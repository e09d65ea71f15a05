"""The float32 encoder forward's and backward's split-bf16 arithmetic, on
the CPU.

On the card the float32 encoder kernels run the bf16 tensor-core kernels
of ``csrc/encoder_attention.cu`` (forward) and
``csrc/encoder_attention_bwd.cu`` (backward): q, k, v and dO are each two
bf16 planes, hi = RN(x) and lo = RN(x - hi), made in shared memory from
the f32 tiles TMA loads; P (the forward's, after the dropout mask), P_d
and dS are split the same way where they are made; and each product is
the sum of the terms that the shared header ``csrc/split_bf16.cuh`` lists
in ``SPLIT_BF16_TERMS`` (the flash kernels' float32 list too), bf16
products exact in f32 and summed in f32.  Scores, the softmax, dsum =
rowsum(dP * P) and the accumulators stay f32.  Here that arithmetic is
emulated in f32 from the term list parsed out of the header, and held:

* the forward within EMU_TOL of max |plain| of ``_encoder_dense`` and its
  lse within LSE_TOL = 1e-4 of ``_encoder_lse``, at rate 0 and, with the
  same Philox keep mask, at rate 0.1; at rate 0 also within F32_RTOL =
  1e-4 of max |reference| of the reference's Pallas ``encoder_attention``
  (the encoder tests' forward tolerance is 1e-5 of the plain version);
  head dims 64 and 128, full and causal, S 128 to 512; the one-term
  control outside F32_RTOL, a wrong mask far outside; the packed q, k, v
  slices of one [B, S, 3, H, D] float32 projection readable in place
  (``tma_readable`` at itemsize 4) and giving the contiguous result;

* within EMU_TOL = 5e-5 of max |plain| (half of chip_smoke.py's F32_RTOL,
  the card's gate) of ``_encoder_bwd_dense`` on the same values, at rate 0
  and, with the same Philox keep mask, at rate 0.1; at rate 0 also within
  the encoder tests' GRAD_TOL = 1e-4 of jax.grad through the reference's
  Pallas ``encoder_attention`` in interpret mode (dropout masks are not
  compared across the packages), at [2, 128, 2, 64] full and
  [1, 256, 2, 128] causal with q ~ N(0, 2.5^2), as chip_smoke.py's Q_STD;
  a one-term control (hi x hi alone, plain bf16) misses F32_RTOL there, so
  a lost plane shows;
* the admission: float32 is in ``_admit.TC_TYPES["encoder"]`` and
  ``["encoder_bwd"]``, which are the sources' type lists, and routes to
  ``encoder_attention`` and ``encoder_attention_bwd`` at head dims 64 and
  128, both sources including the shared header and keeping no term list
  of their own.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import encoder_attention as jea
from paddle_tpu_torch.ops import _admit
from paddle_tpu_torch.ops import encoder_attention as tea
from paddle_tpu_torch.ops import flash_attention as tfa

CSRC = Path(tea.__file__).resolve().parents[1] / "csrc"
BWD_CU = CSRC / "encoder_attention_bwd.cu"
FWD_CU = CSRC / "encoder_attention.cu"
SPLIT_CUH = CSRC / "split_bf16.cuh"
EMU_TOL = 5e-5
GRAD_TOL = 1e-4
F32_RTOL = 1e-4
LSE_TOL = 1e-4
Q_STD = 2.5
RATE = 0.1
# (B, S, H, D, causal)
SHAPES = {"b2_s128_h2_d64_full": (2, 128, 2, 64, False),
          "b1_s256_h2_d128_causal": (1, 256, 2, 128, True)}
# the forward's cases besides SHAPES: one of each float32 regime of the
# kernel (resident at S = 128, D 128; streamed at S = 512, D 64)
FWD_SHAPES = {**SHAPES, "b1_s128_h2_d128_causal": (1, 128, 2, 128, True),
              "b1_s512_h1_d64_full": (1, 512, 1, 64, False)}


def _terms():
    """SPLIT_BF16_TERMS of the shared header: [(A plane, B plane), ...]."""
    line = re.search(r"^#define SPLIT_BF16_TERMS\(X\)(.*)$", SPLIT_CUH.read_text(),
                     re.M).group(1)
    return [tuple(int(a) for a in m.split(",")) for m in re.findall(r"X\(([^)]*)\)", line)]


def _planes(x):
    """The (hi, lo) bf16 planes of an f32 tensor, as f32 (the split the
    kernels make, in shared memory for the inputs and in registers for P_d
    and dS)."""
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


def _emulated_bwd(q, k, v, do, scale, causal, keep, rate, terms):
    """The kernels' float32 arithmetic: every product over the planes'
    terms, P_d and dS split where the kernels split them (dS after the
    scale), the softmax and dsum in f32."""
    S = q.shape[1]
    s = _product("bqhd,bkhd->bhqk", q, k, terms) * scale
    if causal:
        vis = torch.ones(S, S, dtype=torch.bool).tril()
        s = torch.where(vis, s, torch.full_like(s, tea.NEG_INF))
    p = torch.softmax(s, dim=-1)
    dp = tea._drop(_product("bqhd,bkhd->bhqk", do, v, terms), keep, rate)
    pd = tea._drop(p, keep, rate)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dv = _product("bhkq,bqhd->bkhd", pd.transpose(-1, -2), do, terms)
    dq = _product("bhqk,bkhd->bqhd", ds, k, terms)
    dk = _product("bhkq,bqhd->bkhd", ds.transpose(-1, -2), q, terms)
    return dq, dk, dv


def _emulated_fwd(q, k, v, scale, causal, keep, rate, terms):
    """The forward kernel's float32 arithmetic: S = Q K^T over the planes'
    terms, the whole-row softmax in f32, the mask on P in f32, then P split
    into its planes and P V over the terms.  Returns (O, lse [B * H, S])."""
    S = q.shape[1]
    s = _product("bqhd,bkhd->bhqk", q, k, terms) * scale
    if causal:
        vis = torch.ones(S, S, dtype=torch.bool).tril()
        s = torch.where(vis, s, torch.full_like(s, tea.NEG_INF))
    p = tea._drop(torch.softmax(s, dim=-1), keep, rate)
    return _product("bhqk,bkhd->bqhd", p, v, terms), torch.logsumexp(s, -1).reshape(-1, S)


def _case(shape, shapes=SHAPES):
    B, S, H, D, causal = shapes[shape]
    rng = np.random.RandomState(S + D)
    q = (rng.randn(B, S, H, D) * Q_STD).astype(np.float32)
    k, v = (rng.randn(B, S, H, D).astype(np.float32) for _ in range(2))
    return q, k, v, causal


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _cotangent(q, k, v, causal, scale, keep, rate):
    o = tea._encoder_dense(q, k, v, scale, causal, keep, rate)
    return o.cos() - o * o.sin()  # the cotangent of sum(o * cos o)


def test_encoder_source_shares_the_header_term_list():
    assert _terms() == [(1, 0), (0, 1), (0, 0)]
    text = BWD_CU.read_text()
    assert '#include "split_bf16.cuh"' in text and "_TERMS(X)" not in text


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_emulated_split_backward_matches_plain_and_reference(shape):
    """Rate 0: the emulation within EMU_TOL of the plain backward and within
    GRAD_TOL of jax.grad of the reference kernel; the one-term control
    outside F32_RTOL."""
    q, k, v, causal = _case(shape)
    scale = 1.0 / q.shape[-1] ** 0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    do = _cotangent(tq, tk, tv, causal, scale, None, 0.0)
    plain = tea._encoder_bwd_dense(tq, tk, tv, do, scale, causal)
    emu = _emulated_bwd(tq, tk, tv, do, scale, causal, None, 0.0, _terms())
    one = _emulated_bwd(tq, tk, tv, do, scale, causal, None, 0.0, [(0, 0)])
    ref = [torch.from_numpy(np.array(g)) for g in jax.grad(
        lambda a, b, c: jnp.sum((lambda x: x * jnp.cos(x))(
            jea.encoder_attention(a, b, c, causal=causal))),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    for name, e, p, r in zip("qkv", emu, plain, ref):
        assert _rel(e, p) <= EMU_TOL, f"d{name}: {_rel(e, p):.2e}"
        np.testing.assert_allclose(e.numpy(), r.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    assert max(_rel(c, p) for c, p in zip(one, plain)) > F32_RTOL  # a lost plane shows


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_emulated_split_backward_with_dropout_matches_plain(shape):
    """Rate 0.1, the port's Philox keep mask on both sides: the emulation
    within EMU_TOL of the plain backward, the one-term control outside
    F32_RTOL, and a wrong mask (the seed words swapped) far outside."""
    q, k, v, causal = _case(shape)
    B, S, H, D = q.shape
    scale = 1.0 / D ** 0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    seed = torch.tensor([1234, -5678], dtype=torch.int32)
    keep = tea.dropout_keep(seed, B, H, S, RATE)
    do = _cotangent(tq, tk, tv, causal, scale, keep, RATE)
    plain = tea._encoder_bwd_dense(tq, tk, tv, do, scale, causal, keep, RATE)
    emu = _emulated_bwd(tq, tk, tv, do, scale, causal, keep, RATE, _terms())
    one = _emulated_bwd(tq, tk, tv, do, scale, causal, keep, RATE, [(0, 0)])
    for name, e, p in zip("qkv", emu, plain):
        assert _rel(e, p) <= EMU_TOL, f"d{name}: {_rel(e, p):.2e}"
    assert max(_rel(c, p) for c, p in zip(one, plain)) > F32_RTOL
    swapped = tea.dropout_keep(seed.flip(0), B, H, S, RATE)
    wrong = _emulated_bwd(tq, tk, tv, do, scale, causal, swapped, RATE, _terms())
    assert max(_rel(w, p) for w, p in zip(wrong, plain)) > 100 * F32_RTOL


@pytest.mark.parametrize("rate", [0.0, RATE], ids=["rate0", "drop"])
@pytest.mark.parametrize("shape", sorted(FWD_SHAPES))
def test_emulated_split_forward_matches_plain_and_reference(shape, rate):
    """The forward's split arithmetic within EMU_TOL of the plain version
    (with dropout, the port's Philox mask on both sides), its lse within
    LSE_TOL; at rate 0 within F32_RTOL of the reference kernel; the
    one-term control outside F32_RTOL, and with dropout a wrong mask (the
    seed words swapped) far outside."""
    q, k, v, causal = _case(shape, FWD_SHAPES)
    B, S, H, D = q.shape
    scale = 1.0 / D ** 0.5
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    seed = torch.tensor([1234, -5678], dtype=torch.int32)
    keep = tea.dropout_keep(seed, B, H, S, rate) if rate > 0 else None
    plain = tea._encoder_dense(tq, tk, tv, scale, causal, keep, rate)
    emu, emu_lse = _emulated_fwd(tq, tk, tv, scale, causal, keep, rate, _terms())
    one, _ = _emulated_fwd(tq, tk, tv, scale, causal, keep, rate, [(0, 0)])
    assert _rel(emu, plain) <= EMU_TOL, f"{_rel(emu, plain):.2e}"
    assert float((emu_lse - tea._encoder_lse(tq, tk, scale, causal)).abs().max()) <= LSE_TOL
    assert _rel(one, plain) > F32_RTOL  # a lost plane shows
    if rate > 0:
        swapped = tea.dropout_keep(seed.flip(0), B, H, S, rate)
        wrong, _ = _emulated_fwd(tq, tk, tv, scale, causal, swapped, rate, _terms())
        assert _rel(wrong, plain) > 100 * F32_RTOL
    else:
        ref = torch.from_numpy(np.array(jea.encoder_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)))
        assert _rel(emu, ref) <= F32_RTOL, f"{_rel(emu, ref):.2e}"


def test_packed_float32_views_read_in_place():
    """q, k and v as the three strided slices of one packed [B, S, 3, H, D]
    float32 projection: ``tma_readable`` admits them at itemsize 4 (rows
    3 H D * 4 bytes apart), so the kernels read them with no copy; a
    transposed view is not; and the forward and backward on the packed
    views give the contiguous tensors' values (the plain versions here)."""
    rng = np.random.RandomState(7)
    qkv = torch.from_numpy(rng.randn(2, 128, 3, 2, 64).astype(np.float32))
    q, k, v = qkv.unbind(2)
    for t in (q, k, v):
        assert tea.tma_readable(tuple(t.shape), t.stride(), 16 * 1024, t.element_size())
    tr = q.transpose(1, 2).contiguous().transpose(1, 2)  # [B, S, H, D] with H outermost
    assert not tea.tma_readable(tuple(tr.shape), tr.stride(), 16 * 1024, tr.element_size())
    args = [t.clone().requires_grad_(True) for t in (q, k, v)]
    packed = qkv.clone().requires_grad_(True)
    o_packed = tea.encoder_attention(*packed.unbind(2), causal=True)
    o = tea.encoder_attention(*args, causal=True)
    assert torch.equal(o_packed, o)
    (o_packed * o_packed.cos()).sum().backward()
    (o * o.cos()).sum().backward()
    assert torch.equal(packed.grad, torch.stack([a.grad for a in args], 2))


def test_float32_forward_admitted_to_the_tensor_cores():
    """float32 is in the forward source's type list (ENCODER_TYPES, code
    0) and in ``_admit.TC_TYPES["encoder"]``, the wrapper's admission, at
    head dims 64 and 128; the forward shares the header's term list."""
    text = FWD_CU.read_text()
    line = re.search(r"^#define ENCODER_TYPES\(X\)(.*)$", text, re.M).group(1)
    c_types = {"__nv_bfloat16": torch.bfloat16, "__half": torch.float16, "float": torch.float32}
    built = {c_types[t.strip()]: int(c) for t, c in
             (m.split(",") for m in re.findall(r"X\(([^)]*)\)", line))}
    assert built == {t: _admit.TC_TYPE_CODES[t] for t in _admit.TC_TYPES["encoder"]}
    assert built[torch.float32] == 0
    assert '#include "split_bf16.cuh"' in text and "_TERMS(X)" not in text
    for D in (64, 128):
        inst = _admit.admit("encoder", torch.float32, torch.float32, D)
        assert inst.lib == "encoder_attention" and inst.D == D
    assert not hasattr(tea, "encoder_attention_simt_kernel")


def test_float32_backward_admitted_to_the_tensor_cores():
    line = re.search(r"^#define ENCODER_BWD_TYPES\(X\)(.*)$", BWD_CU.read_text(), re.M).group(1)
    c_types = {"__nv_bfloat16": torch.bfloat16, "__half": torch.float16, "float": torch.float32}
    built = {c_types[t.strip()]: int(c) for t, c in
             (m.split(",") for m in re.findall(r"X\(([^)]*)\)", line))}
    assert built == {t: _admit.TC_TYPE_CODES[t] for t in _admit.TC_TYPES["encoder_bwd"]}
    assert torch.float32 in built
    for D in (64, 128):
        inst = _admit.admit("encoder_bwd", torch.float32, torch.float32, D)
        assert inst.lib == "encoder_attention_bwd" and inst.D == D
    # float32's whole head at D 64; at D 128 its tiles take the streamed pair
    assert tea._whole_head(128, 64, 4) and not tea._whole_head(128, 128, 4)
