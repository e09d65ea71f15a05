"""The float32 flash forward's and backward's split-bf16 arithmetic, on
the CPU.

On the card the float32 flash kernels run the bf16 tensor-core kernels of
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward): each f32 operand is two bf16 planes, hi = RN(x) and lo = RN(x -
hi) (``_split_planes_dense``: the backward's split pass, and the split the
forward makes of its f32 tiles in shared memory), and each product the sum
of the terms that the shared header ``csrc/split_bf16.cuh`` lists in
``SPLIT_BF16_TERMS``, bf16 products exact in f32 and summed in f32.  Here
that arithmetic is emulated in f32 from the term list parsed out of the
header, which both sources include, and held:

* the forward (S = Q K^T split, the softmax in f32, P split after it, the
  reference not rounding p at float32, then P V over the terms) within
  EMU_TOL = 5e-5 of max |plain| of ``_flash_dense`` and within F32_RTOL =
  1e-4 of max |reference| of ``flash_attention_with_lse`` through the
  reference's Pallas kernel in interpret mode, its lse within LSE_TOL =
  1e-4 of both, causal and full, Sq < Sk, head dims 64, 128 and 256 (q ~
  N(0, 2.5^2)); the one-term control misses F32_RTOL;

* within EMU_TOL = 5e-5 of max |plain| (half of chip_smoke.py's F32_RTOL,
  the card's gate) of ``_flash_bwd_dense`` on the same values, and within
  the flash tests' GRAD_TOL = 2e-4 of jax.grad through the reference's
  Pallas kernels in interpret mode, at [1, 128, 2, 64] and [1, 96, 1, 256]
  causal (q ~ N(0, 2.5^2), as chip_smoke.py's Q_STD); a one-term control
  (hi x hi alone, plain bf16) misses F32_RTOL there, so a lost plane shows;
* ``_split_planes_dense``: hi is bf16 round-to-nearest, hi + lo is x
  within 2^-16 |x|, a non-finite hi gives lo = 0, subnormals are kept;
* the admission: float32 is in ``_admit.TC_TYPES["flash"]`` and
  ``["flash_bwd"]``, which are the sources' type lists, and routes to
  ``flash_attention`` and ``flash_attention_bwd`` at head dims 64, 128 and
  256.
"""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import _admit
from paddle_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
BWD_CU = Path(tfa.__file__).resolve().parents[1] / "csrc" / "flash_attention_bwd.cu"
FWD_CU = BWD_CU.with_name("flash_attention.cu")
SPLIT_CUH = BWD_CU.with_name("split_bf16.cuh")
EMU_TOL = 5e-5
GRAD_TOL = 2e-4
F32_RTOL = 1e-4
LSE_TOL = 1e-4
Q_STD = 2.5
SHAPES = {"s128_h2_d64": (128, 2, 64), "s96_h1_d256": (96, 1, 256)}
# the forward's cases: (Sq, Sk, H, D, causal)
FWD_SHAPES = {"s128_d64_causal": (128, 128, 2, 64, True),
              "sq128_sk256_d128_causal": (128, 256, 2, 128, True),
              "sq128_sk256_d128_full": (128, 256, 1, 128, False),
              "s128_d256_full": (128, 128, 1, 256, False),
              "s96_d256_causal": (96, 96, 1, 256, True)}


def _terms():
    """SPLIT_BF16_TERMS of the shared header: [(A plane, B plane), ...]."""
    line = re.search(r"^#define SPLIT_BF16_TERMS\(X\)(.*)$", SPLIT_CUH.read_text(),
                     re.M).group(1)
    return [tuple(int(a) for a in m.split(",")) for m in re.findall(r"X\(([^)]*)\)", line)]


def _planes(x):
    """The (hi, lo) planes of an f32 tensor along its last dim, as f32."""
    p = tfa._split_planes_dense(x)
    return p[..., 0, :].float(), p[..., 1, :].float()


def _product(eq, a, b, terms):
    """sum over the terms of einsum(eq, plane of a, plane of b), in f32, in
    the list's order."""
    pa, pb = _planes(a), _planes(b)
    out = None
    for i, j in terms:
        t = torch.einsum(eq, pa[i], pb[j])
        out = t if out is None else out + t
    return out


def _emulated_bwd(q, k, v, o, lse, do, causal, scale, terms):
    """The kernels' float32 arithmetic: every product over the planes'
    terms, P and dS split where the kernels split them."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = _product("bqhd,bkhd->bhqk", q, k, terms) * scale
    if causal:
        vis = torch.ones(Sq, Sk, dtype=torch.bool).tril(Sk - Sq)
        s = torch.where(vis, s, torch.full_like(s, tfa.NEG_INF))
    p = torch.exp(s - lse[..., None])
    dsum = torch.einsum("bqhd,bqhd->bhq", do, o)
    dp = _product("bqhd,bkhd->bhqk", do, v, terms)
    dv = _product("bhkq,bqhd->bkhd", p.transpose(-1, -2), do, terms)
    ds = p * (dp - dsum[..., None])
    dq = _product("bhqk,bkhd->bqhd", ds, k, terms) * scale
    dk = _product("bhkq,bqhd->bkhd", ds.transpose(-1, -2), q, terms) * scale
    return dq, dk, dv


def _emulated_fwd(q, k, v, causal, scale, terms):
    """The forward kernel's float32 arithmetic: S = Q K^T over the planes'
    terms, the online softmax's statistics in f32 (here the row's max m and
    sum l at once), the unnormalised P = exp(S - m) split into its planes
    and P V over the terms, divided by l at the end; lse = m + log l.
    Returns (O [B, Sq, H, D], lse [B, H, Sq])."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = _product("bqhd,bkhd->bhqk", q, k, terms) * scale
    if causal:
        vis = torch.ones(Sq, Sk, dtype=torch.bool).tril(Sk - Sq)
        s = torch.where(vis, s, torch.full_like(s, tfa.NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = _product("bhqk,bkhd->bqhd", p, v, terms) / l.permute(0, 2, 1, 3)
    return o, (m + torch.log(l))[..., 0]


def _case(shape):
    S, H, D = SHAPES[shape]
    rng = np.random.RandomState(S + D)
    q = (rng.randn(1, S, H, D) * Q_STD).astype(np.float32)
    k, v = (rng.randn(1, S, H, D).astype(np.float32) for _ in range(2))
    return q, k, v


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_term_list_is_three_products_small_terms_first():
    assert _terms() == [(1, 0), (0, 1), (0, 0)]
    assert '#include "split_bf16.cuh"' in BWD_CU.read_text()
    assert "_TERMS(X)" not in BWD_CU.read_text()  # one term list, the header's


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_emulated_split_backward_matches_plain_and_reference(shape):
    q, k, v = _case(shape)
    D = q.shape[-1]
    scale = 1.0 / D ** 0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = tfa._flash_dense(tq, tk, tv, True, scale)
    do = o.cos() - o * o.sin()  # the cotangent of sum(o * cos o)
    plain = tfa._flash_bwd_dense(tq, tk, tv, o, lse, do, True, scale)
    emu = _emulated_bwd(tq, tk, tv, o, lse, do, True, scale, _terms())
    one = _emulated_bwd(tq, tk, tv, o, lse, do, True, scale, [(0, 0)])
    ref = [torch.from_numpy(np.array(g)) for g in jax.grad(
        lambda a, b, c: jnp.sum((lambda x: x * jnp.cos(x))(
            jfa.flash_attention(a, b, c, causal=True, interpret=True))),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    for name, e, p, r, c in zip("qkv", emu, plain, ref, one):
        assert _rel(e, p) <= EMU_TOL, f"d{name}: {_rel(e, p):.2e}"
        np.testing.assert_allclose(e.numpy(), r.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    assert max(_rel(c, p) for c, p in zip(one, plain)) > F32_RTOL  # a lost plane shows


@pytest.mark.parametrize("shape", sorted(FWD_SHAPES))
def test_emulated_split_forward_matches_plain_and_reference(shape):
    """The forward's split arithmetic within EMU_TOL of the plain version
    and within F32_RTOL of the reference kernel on the same inputs, its lse
    within LSE_TOL of both; the one-term control (hi x hi alone, plain
    bf16) outside F32_RTOL."""
    Sq, Sk, H, D, causal = FWD_SHAPES[shape]
    rng = np.random.RandomState(Sq + Sk + D)
    q = (rng.randn(1, Sq, H, D) * Q_STD).astype(np.float32)
    k, v = (rng.randn(1, Sk, H, D).astype(np.float32) for _ in range(2))
    scale = 1.0 / D ** 0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    plain, plain_lse = tfa._flash_dense(tq, tk, tv, causal, scale)
    emu, emu_lse = _emulated_fwd(tq, tk, tv, causal, scale, _terms())
    one, _ = _emulated_fwd(tq, tk, tv, causal, scale, [(0, 0)])
    ref, ref_lse = (torch.from_numpy(np.array(a)) for a in jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True))
    assert _rel(emu, plain) <= EMU_TOL, f"{_rel(emu, plain):.2e}"
    assert _rel(emu, ref) <= F32_RTOL, f"{_rel(emu, ref):.2e}"
    assert float((emu_lse - plain_lse).abs().max()) <= LSE_TOL
    assert float((emu_lse - ref_lse).abs().max()) <= LSE_TOL
    assert _rel(one, plain) > F32_RTOL  # a lost plane shows


def test_split_planes_round_and_reproduce():
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(2, 16, 2, 64) * np.exp(rng.randn(2, 16, 2, 64) * 8))
                         .astype(np.float32))
    p = tfa._split_planes_dense(x)
    assert p.dtype == torch.bfloat16 and p.shape == (2, 16, 2, 2, 64)
    hi, lo = p[..., 0, :], p[..., 1, :]
    assert torch.equal(hi, x.to(torch.bfloat16))  # round to nearest even
    err = (hi.float() + lo.float() - x).abs()
    assert bool((err <= x.abs() * 2.0 ** -16).all())
    bad = torch.tensor([float("inf"), float("-inf"), float("nan"), 3.4e38, 1e-40, 2.0 ** -130,
                        -(2.0 ** -132)]).reshape(1, 1, 1, 7)
    pb = tfa._split_planes_dense(bad)
    hb, lb = pb[..., 0, :].float().flatten(), pb[..., 1, :].float().flatten()
    assert torch.equal(lb[:4], torch.zeros(4))  # 3.4e38 rounds to inf in bf16: lo = 0
    assert torch.isinf(hb[:2]).all() and torch.isnan(hb[2]) and torch.isinf(hb[3])
    assert bool((hb[4:] != 0).all())  # subnormal, not flushed
    assert hb[5] == 2.0 ** -130 and hb[6] == -(2.0 ** -132)


def test_float32_forward_admitted_to_the_tensor_cores():
    """float32 is in the forward source's type list (FLASH_TYPES, code 0)
    and in ``_admit.TC_TYPES["flash"]``, the wrapper's admission; the
    forward shares the header's term list and keeps none of its own."""
    text = FWD_CU.read_text()
    line = re.search(r"^#define FLASH_TYPES\(X\)(.*)$", text, re.M).group(1)
    c_types = {"__nv_bfloat16": torch.bfloat16, "__half": torch.float16, "float": torch.float32}
    built = {c_types[t.strip()]: int(c) for t, c in
             (m.split(",") for m in re.findall(r"X\(([^)]*)\)", line))}
    assert built == {t: _admit.TC_TYPE_CODES[t] for t in _admit.TC_TYPES["flash"]}
    assert built[torch.float32] == 0
    assert '#include "split_bf16.cuh"' in text and "_TERMS(X)" not in text
    for D in tfa.FWD_HEAD_DIMS:
        inst = _admit.admit("flash", torch.float32, torch.float32, D)
        assert inst.lib == "flash_attention" and inst.D == D
    assert not hasattr(tfa, "flash_attention_simt_kernel")


def test_float32_backward_admitted_to_the_tensor_cores():
    line = re.search(r"^#define FLASH_BWD_TYPES\(X\)(.*)$", BWD_CU.read_text(), re.M).group(1)
    c_types = {"__nv_bfloat16": torch.bfloat16, "__half": torch.float16, "float": torch.float32}
    built = {c_types[t.strip()]: int(c) for t, c in
             (m.split(",") for m in re.findall(r"X\(([^)]*)\)", line))}
    assert built == {t: _admit.TC_TYPE_CODES[t] for t in _admit.TC_TYPES["flash_bwd"]}
    assert torch.float32 in built
    for D in (64, 128, 256):
        inst = _admit.admit("flash_bwd", torch.float32, torch.float32, D)
        assert inst.lib == "flash_attention_bwd" and inst.D == D
    assert tfa._planes_numel(2, 3, 5, 7, 64) == 4 * 2 * 3 * 64 * (5 + 7)
