"""The decode and paged kernels' arithmetic at float32 and float16, on the
CPU.

On the card every (q, cache) type pair of ``_admit.KV_PAIRS`` runs the
tensor-core kernels of ``csrc/kv_attention.cuh`` (``decode_attention.cu``,
``paged_attention.cu``): float16 against a float16 cache as float16
products; float32 operands as split-bf16 products (two bf16 planes an
operand, hi = RN(x) and lo = RN(x - hi), and the terms of
``SPLIT_BF16_TERMS`` in ``csrc/split_bf16.cuh``, bf16 products exact in f32
and summed in f32); a float16 q against a float32 or int8 cache as its two
bf16 planes, which hold it exactly; int8 widened exactly to bf16.  A
product of an operand of PA planes by one of PB planes takes the terms of
the list whose planes both have (``for_terms<PA, PB>``); p is split into
planes against a float32 v and rounded to v's type otherwise (bf16 against
int8); the k-scale multiplies the scores after the dot and the v-scale p
after l.  Here that arithmetic is emulated in f32 from the term list
parsed out of the header (term by term; the decode regime against a
float32 cache sums k-step by k-step, another f32 rounding order) and held,
for each pair of the kernels but the bfloat16 ones, at q ~ N(0, 2.5^2)
(chip_smoke.py's Q_STD):

* against the reference's Pallas kernels in interpret mode: a static
  decode step (S = 1, ``_decode_pallas``) at head dim 256 and a paged
  chunk of 9 positions x 2 query heads a kv head (18 rows: the chunk
  regime, ``_paged_pallas``, pages of 128) at head dim 64, B = 2 or 3, H = 4,
  within F32_RTOL = 1e-4 of max |reference| for (f32, f32) and (f16, f32),
  F16_RTOL = 2e-3 for (f16, f16) and INT8_RTOL = 1e-2 (chip_smoke.py's
  KERNEL_RTOL["int8"]) for the int8 pairs, where both sides round p to bf16
  and scores a few f32 ulps apart can round a large p to neighbouring bf16
  values (2^-8 of it; 0.4-1.3e-3 here).  A float16 q against a float32 or
  int8 cache goes to the reference as the float32 values it holds (the
  reference's products promote it to f32 either way), so that both sides
  end in f32 and the kernels' last rounding, to float16, is left out;
* against the plain ``_split_merge_dense`` (f32 products of the stored
  values, the same split-K merge) within F32_RTOL / 2 on the same values
  (INT8_RTOL for float32 q against int8, whose q·k drops q's bits past its
  two planes, so p may round the other way);
* a one-term control (hi x hi alone, plain bf16 products) misses F32_RTOL,
  so a lost plane shows;
* a float16 value is exactly its two bf16 planes.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import kv_cache as jkv
from paddle_tpu.ops import decode_attention as jda
from paddle_tpu_torch.ops import _admit
from paddle_tpu_torch.ops import decode_attention as tda
from paddle_tpu_torch.ops import flash_attention as tfa

SPLIT_CUH = Path(tda.__file__).resolve().parents[1] / "csrc" / "split_bf16.cuh"
F32_RTOL = 1e-4
F16_RTOL = 2e-3
INT8_RTOL = 1e-2
Q_STD = 2.5
F32, F16, I8 = torch.float32, torch.float16, torch.int8
PAIRS = [(q, kv) for q, kv in _admit.KV_PAIRS if q != torch.bfloat16]
TOL = {(F32, F32): F32_RTOL, (F16, F32): F32_RTOL, (F16, F16): F16_RTOL,
       (F32, I8): INT8_RTOL, (F16, I8): INT8_RTOL}
PLAIN_TOL = {**{pair: F32_RTOL / 2 for pair in TOL}, (F32, I8): INT8_RTOL}
# (regime, B, S, H, Hkv, D, offsets, keys a slot): the static decode step
# (two splits of 64 keys), the paged chunk (two pages of PS)
CASES = {"decode_d256": ("decode", 3, 1, 4, 2, 256, (0, 37, 127), 128),
         "chunk_d64": ("paged", 2, 9, 4, 2, 64, (200, 40), 256)}
PS = 128


def _terms():
    """SPLIT_BF16_TERMS of the shared header: [(A plane, B plane), ...]."""
    line = re.search(r"^#define SPLIT_BF16_TERMS\(X\)(.*)$", SPLIT_CUH.read_text(),
                     re.M).group(1)
    return [tuple(int(a) for a in m.split(",")) for m in re.findall(r"X\(([^)]*)\)", line)]


def _planes(x, n):
    """x as its n planes in f32: [x] at n = 1; its bf16 (hi, lo) at n = 2."""
    if n == 1:
        return [x.float()]
    p = tfa._split_planes_dense(x.float())
    return [p[..., 0, :].float(), p[..., 1, :].float()]


def _product(eq, a, b, terms):
    """sum over the terms of einsum(eq, plane i of a, plane j of b), in f32,
    in the list's order, over the terms whose planes a and b have."""
    out = None
    for i, j in terms:
        if i < len(a) and j < len(b):
            t = torch.einsum(eq, a[i], b[j])
            out = t if out is None else out + t
    return out


def _emulated(q, k, v, offset, k_scale, v_scale, scale, split_keys, terms):
    """The kernels' arithmetic for q [B, S, H, D] against a head-major cache
    k/v [B, Hkv, L, D] (a paged one gathered), split-K as the decode regime
    runs it (each split's m, l and acc, merged in split order; one split is
    the chunk regime).  Returns [B, S, H, D] in f32 (the kernels round it to
    q's type last)."""
    B, S, H, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    rep = H // Hkv
    e = torch.float16 if k.dtype == F16 else torch.bfloat16  # the products' type
    pq = 1 if q.dtype == e else 2
    pkv = 2 if k.dtype == F32 else 1
    kp = [x.repeat_interleave(rep, dim=1) for x in _planes(k, pkv)]
    vp = [x.repeat_interleave(rep, dim=1) for x in _planes(v, pkv)]
    s = _product("bshd,bhld->bhsl", _planes(q, pq), kp, terms) * scale
    if k_scale is not None:
        s = s * k_scale.float().repeat_interleave(rep, dim=1)[:, :, None, :]
    kpos = torch.arange(Lk)[None, None, None, :]
    qpos = torch.as_tensor(offset).long()[:, None, None, None] + torch.arange(S)[None, None, :, None]
    visible = kpos <= qpos
    s = torch.where(visible, s, torch.full_like(s, tda.NEG_INF))
    parts = []
    for k0 in range(0, Lk, split_keys):
        sl = slice(k0, k0 + split_keys)
        m = s[..., sl].amax(-1, keepdim=True)
        p = torch.where(visible[..., sl], torch.exp(s[..., sl] - m), torch.zeros_like(m))
        l = p.sum(-1, keepdim=True)
        if v_scale is not None:
            p = p * v_scale.float().repeat_interleave(rep, dim=1)[:, :, None, sl]
        pp = _planes(p, 2) if pkv == 2 else [p.to(e).float()]
        acc = _product("bhsl,bhld->bhsd", pp, [x[:, :, sl] for x in vp], terms)
        parts.append((m, l, acc))
    m_all = torch.stack([m for m, _, _ in parts])
    top = m_all.amax(0)
    top = torch.where(top == tda.NEG_INF, torch.zeros_like(top), top)
    w = torch.where(m_all == tda.NEG_INF, torch.zeros_like(m_all), torch.exp(m_all - top))
    l_tot = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    o = sum(wi * acc for wi, (_, _, acc) in zip(w, parts))
    return (o / torch.where(l_tot <= 0, torch.ones_like(l_tot), l_tot)).transpose(1, 2)


def _inputs(case, q_dtype, kv_dtype):
    """numpy q (q's type), the reference's cache (int8 by its own
    quantizer) with scales, the offsets and, paged, the page table."""
    regime, B, S, H, Hkv, D, offsets, L = CASES[case]
    rng = np.random.RandomState(D + S)
    np_dt = {F32: np.float32, F16: np.float16}
    q = (rng.randn(B, S, H, D) * Q_STD).astype(np_dt[q_dtype])
    shape = (B, Hkv, L, D) if regime == "decode" else (1 + B * L // PS, Hkv, PS, D)
    k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    ks = vs = tbl = None
    if kv_dtype == I8:
        (k, ks), (v, vs) = jkv._quantize_kv(jnp.asarray(k)), jkv._quantize_kv(jnp.asarray(v))
        k, v, ks, vs = (np.asarray(a) for a in (k, v, ks, vs))
    else:
        k, v = k.astype(np_dt[kv_dtype]), v.astype(np_dt[kv_dtype])
    if regime == "paged":
        tbl = (1 + rng.permutation(B * L // PS)).reshape(B, L // PS).astype(np.int32)
    return q, k, v, ks, vs, np.asarray(offsets, np.int32), tbl


def _port_inputs(k, v, ks, vs, tbl):
    """The cache as the emulation reads it: head-major, pages gathered."""
    t = [None if a is None else torch.from_numpy(np.array(a)) for a in (k, v, ks, vs)]
    if tbl is not None:
        tt = torch.from_numpy(tbl)
        t = [None if a is None else tda.gather_pages(a, tt) for a in t]
    return t


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{str(p[0])[6:]}_{str(p[1])[6:]}")
def test_emulated_products_match_reference_and_plain(pair, case):
    q_dtype, kv_dtype = pair
    regime, B, S, H, Hkv, D, _, L = CASES[case]
    q, k, v, ks, vs, off, tbl = _inputs(case, q_dtype, kv_dtype)
    scale = 1 / D ** 0.5
    f32_out = kv_dtype != F16  # the reference on q's values in f32 (the same math to its last cast)
    qr = jnp.asarray(q.astype(np.float32) if f32_out else q)
    jks, jvs = (None, None) if ks is None else (jnp.asarray(ks), jnp.asarray(vs))
    if regime == "decode":
        want = jda._decode_pallas(qr, jnp.asarray(k), jnp.asarray(v), jnp.asarray(off), jks, jvs,
                                  scale=scale, bk=128, interpret=True)
    else:
        want = jda._paged_pallas(qr, jnp.asarray(k), jnp.asarray(v), jnp.asarray(off + S),
                                 jnp.asarray(tbl), jks, jvs, scale=scale, interpret=True)
    kt, vt, kst, vst = _port_inputs(k, v, ks, vs, tbl)
    tq = torch.from_numpy(q)
    rows = S * H // Hkv
    split_keys = 64 if rows <= _admit.DECODE_ROWS else L  # two splits, or the chunk's one
    got = _emulated(tq, kt, vt, off, kst, vst, scale, split_keys, _terms())
    assert _rel((got if f32_out else got.to(q_dtype)).float().numpy(), want) <= TOL[pair]
    plain = tda._split_merge_dense(tq.float(), kt, vt, torch.from_numpy(off), kst, vst, scale,
                                   split_keys)
    assert _rel(got.numpy(), plain.numpy()) <= PLAIN_TOL[pair]


def test_one_term_control_misses_f32_rtol():
    """hi x hi alone (q, K, V and p rounded to bf16) is not within F32_RTOL
    of the f32 products, so the gates above see a lost plane."""
    q, k, v, _, _, off, _ = _inputs("decode_d256", F32, F32)
    t = torch.from_numpy
    plain = tda._split_merge_dense(t(q), t(k), t(v), t(off), None, None, 1 / 16, 64)
    full = _emulated(t(q), t(k), t(v), off, None, None, 1 / 16, 64, _terms())
    control = _emulated(t(q), t(k), t(v), off, None, None, 1 / 16, 64, [(0, 0)])
    assert _rel(full.numpy(), plain.numpy()) <= F32_RTOL / 2
    assert _rel(control.numpy(), plain.numpy()) > F32_RTOL


def test_f16_is_exactly_two_bf16_planes():
    """Every float16 value, subnormals and the largest included, is hi + lo
    of its bf16 planes: 11 significand bits in 8 + 8, the exponent range
    inside bf16's."""
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16).view(torch.float16)
    x = x[torch.isfinite(x)]
    hi, lo = _planes(x, 2)
    assert torch.equal(hi + lo, x.float())
    assert torch.equal(hi.bfloat16().float(), hi) and torch.equal(lo.bfloat16().float(), lo)


def test_term_list_by_planes():
    """The header's list is lo x hi, hi x lo, hi x hi; an operand of one
    plane keeps the terms on its plane 0, in the list's order."""
    terms = _terms()
    assert terms == [(1, 0), (0, 1), (0, 0)]
    assert [t for t in terms if t[1] < 1] == [(1, 0), (0, 0)]
    assert [t for t in terms if t[0] < 1 and t[1] < 1] == [(0, 0)]
