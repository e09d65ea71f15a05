"""The float32 encoder backward's split-bf16 arithmetic, on the CPU.

On the card the float32 encoder backward runs the bf16 tensor-core kernels
of ``csrc/encoder_attention_bwd.cu``: q, k, v and dO are each two bf16
planes, hi = RN(x) and lo = RN(x - hi), made in shared memory from the f32
tiles TMA loads; P_d and dS are split the same way where they are made;
and each product is the sum of the terms that the shared header
``csrc/split_bf16.cuh`` lists in ``SPLIT_BF16_TERMS`` (the flash
backward's float32 list too), bf16 products exact in f32 and summed in
f32.  Scores, dsum = rowsum(dP * P) and the accumulators stay f32.  Here
that arithmetic is emulated in f32 from the term list parsed out of the
header, and held:

* within EMU_TOL = 5e-5 of max |plain| (half of chip_smoke.py's F32_RTOL,
  the card's gate) of ``_encoder_bwd_dense`` on the same values, at rate 0
  and, with the same Philox keep mask, at rate 0.1; at rate 0 also within
  the encoder tests' GRAD_TOL = 1e-4 of jax.grad through the reference's
  Pallas ``encoder_attention`` in interpret mode (dropout masks are not
  compared across the packages), at [2, 128, 2, 64] full and
  [1, 256, 2, 128] causal with q ~ N(0, 2.5^2), as chip_smoke.py's Q_STD;
  a one-term control (hi x hi alone, plain bf16) misses F32_RTOL there, so
  a lost plane shows;
* the admission: float32 is in ``_simt.TC_TYPES["encoder_bwd"]``, which is
  the source's type list, and routes to ``encoder_attention_bwd`` at head
  dims 64 and 128, the source including the shared header and keeping no
  term list of its own.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import encoder_attention as jea
from paddle_tpu_torch.ops import _simt
from paddle_tpu_torch.ops import encoder_attention as tea
from paddle_tpu_torch.ops import flash_attention as tfa

CSRC = Path(tea.__file__).resolve().parents[1] / "csrc"
BWD_CU = CSRC / "encoder_attention_bwd.cu"
SPLIT_CUH = CSRC / "split_bf16.cuh"
EMU_TOL = 5e-5
GRAD_TOL = 1e-4
F32_RTOL = 1e-4
Q_STD = 2.5
RATE = 0.1
# (B, S, H, D, causal)
SHAPES = {"b2_s128_h2_d64_full": (2, 128, 2, 64, False),
          "b1_s256_h2_d128_causal": (1, 256, 2, 128, True)}


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


def _case(shape):
    B, S, H, D, causal = SHAPES[shape]
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


def test_float32_backward_admitted_to_the_tensor_cores():
    line = re.search(r"^#define ENCODER_BWD_TYPES\(X\)(.*)$", BWD_CU.read_text(), re.M).group(1)
    c_types = {"__nv_bfloat16": torch.bfloat16, "__half": torch.float16, "float": torch.float32}
    built = {c_types[t.strip()]: int(c) for t, c in
             (m.split(",") for m in re.findall(r"X\(([^)]*)\)", line))}
    assert built == {t: _simt.TC_TYPE_CODES[t] for t in _simt.TC_TYPES["encoder_bwd"]}
    assert torch.float32 in built
    for D in (64, 128):
        inst = _simt.admit("encoder_bwd", torch.float32, torch.float32, D)
        assert not inst.simt and inst.lib == "encoder_attention_bwd" and inst.D == D
    # float32's whole head at D 64; at D 128 its tiles take the streamed pair
    assert tea._whole_head(128, 64, 4) and not tea._whole_head(128, 128, 4)
