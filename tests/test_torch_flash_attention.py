"""Port parity: paddle_tpu_torch's flash attention, forward and backward,
and the SDPA routing against the JAX reference on the CPU, in f32.

The port's plain ``_flash_dense`` and ``_flash_bwd_dense`` (what CPU
tensors take, and the oracles of the Hopper kernels in chip_smoke.py) are
held against the reference's Pallas ``flash_attention`` and
``flash_attention_with_lse`` in interpret mode, on the same numpy-seeded
inputs.  Tolerance 2e-5 on O and on the logsumexp, and 2e-4 on dQ, dK and
dV, as the reference's own flash tests (tests/test_flash_attention.py):
both sides compute in f32 and differ in summation order only.  The
gradients are taken of the reference's non-trivial cotangent, sum(o *
cos(o)), plus a random weighting of the logsumexp where it is returned.
The D = 256 backward, which the Hopper kernels now take at every type, is
held at float32 and bfloat16 too (BF16_GRAD_TOL says why that tolerance;
float16 is in test_torch_train_dtypes.py).
"""
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional.attention import _reference_kernel
from paddle_tpu_torch.ops import flash_attention as tfa

# the module: paddle_tpu.ops re-exports its function under the same name
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
TOL = 2e-5
GRAD_TOL = 2e-4
BWD_CU = Path(tfa.__file__).resolve().parents[1] / "csrc" / "flash_attention_bwd.cu"


def _qkv(Sq, Sk, D, B=1, H=2, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Sk, H, D).astype(np.float32)
    v = rng.randn(B, Sk, H, D).astype(np.float32)
    return q, k, v


CASES = {
    "causal_sq_eq_sk_d64": (256, 256, 64, True),
    "full_sq_eq_sk_d128": (256, 256, 128, False),
    "causal_sq_lt_sk_d128": (128, 256, 128, True),
    "full_sq_lt_sk_d64": (128, 384, 64, False),
}


D256_CASES = {
    "causal_s128_d256": (128, 128, 256, True),
    "full_s256_d256": (256, 256, 256, False),
    "causal_sq128_sk256_d256": (128, 256, 256, True),
}


@pytest.mark.parametrize("case", sorted(D256_CASES))
def test_plain_matches_reference_kernel_d256(case):
    """D = 256, which the reference's SDPA sends to flash at S >= 1024 and
    the port's Hopper forward now takes: the plain version (what a CPU
    tensor runs, and the kernel's oracle on the card) against the
    reference's Pallas kernel in interpret mode."""
    Sq, Sk, D, causal = D256_CASES[case]
    q, k, v = _qkv(Sq, Sk, D, seed=3)
    want_o, want_lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    t = torch.from_numpy
    o, lse = tfa.flash_attention_with_lse(t(q), t(k), t(v), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=TOL, atol=TOL)


def test_backward_admission_rejects_head_dim_256():
    """Head dim 256 is admitted forward and backward (the D = 256 backward
    kernels split the 256 columns of dK and dV between two warpgroups); the
    wrapper's list is the .cu's FLASH_BWD_DIMS, the one list its entries
    dispatch on; other head dims are refused."""
    for D in tfa.FWD_HEAD_DIMS:
        tfa._check_head_dim(D)
    for D in tfa.BWD_HEAD_DIMS:
        tfa._check_head_dim(D, backward=True)
    tfa._check_head_dim(256, backward=True)
    assert 256 in tfa.BWD_HEAD_DIMS
    line = re.search(r"#define FLASH_BWD_DIMS\(X\)(.*)", BWD_CU.read_text()).group(1)
    assert tuple(int(d) for d in re.findall(r"X\((\d+)\)", line)) == tfa.BWD_HEAD_DIMS
    assert BWD_CU.read_text().count("FLASH_BWD_DIMS(X)") == 4  # the define and three entries
    with pytest.raises(ValueError, match="head dim 96"):
        tfa._check_head_dim(96)
    with pytest.raises(ValueError, match="head dim 96"):
        tfa._check_head_dim(96, backward=True)


# The D = 256 backward at B 1, H 1 against jax.grad of the reference's
# kernels in interpret mode, of sum(o * cos o), q ~ N(0, 2^2): float32
# within GRAD_TOL (f32 on both sides); bfloat16 within BF16_GRAD_TOL of max
# |want| per gradient: both sides round dS and dV's P to bfloat16 in the
# same places, but each takes its own forward's O, whose bfloat16 rounding
# dsum = rowsum(dO * O) carries into every dS (measured at most 9.3e-3,
# the float16 tolerance of test_torch_train_dtypes.py times the 2^3 that
# bfloat16's three fewer mantissa bits give).
BF16_GRAD_TOL = 4e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(D256_CASES))
def test_plain_backward_d256_matches_reference_kernels(case, dtype):
    Sq, Sk, D, causal = D256_CASES[case]
    q, k, v = _qkv(Sq, Sk, D, H=1, seed=Sq + Sk)
    q = q * 2
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = [np.asarray(g.astype(jnp.float32))
            for g in _ref_grads(*(a.astype(jdt) for a in map(jnp.asarray, (q, k, v))), causal)]
    ts = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    o = tfa.flash_attention(*ts, causal=causal)
    got = torch.autograd.grad((o.float() * o.float().cos()).sum(), ts)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == tdt
        g = g.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"d{name}")
        else:
            assert np.abs(g - w).max() / np.abs(w).max() <= BF16_GRAD_TOL, f"d{name}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_reference_kernel(case):
    Sq, Sk, D, causal = CASES[case]
    q, k, v = _qkv(Sq, Sk, D)
    want_o, want_lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, interpret=True)
    want_plain = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, interpret=True)
    t = torch.from_numpy
    o, lse = tfa.flash_attention_with_lse(t(q), t(k), t(v), causal=causal)
    assert o.shape == q.shape and lse.shape == (1, 2, Sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tfa.flash_attention(t(q), t(k), t(v), causal=causal).numpy(),
                               np.asarray(want_plain), rtol=TOL, atol=TOL)


def test_causal_longer_query_raises():
    q, k, v = _qkv(256, 128, 64)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="Sq <= Sk"):
        tfa.flash_attention(t(q), t(k), t(v), causal=True)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)


def _ref_grads(q, k, v, causal, w=None):
    """jax.grad of sum(o * cos o) (+ sum(lse * w)) through the reference's
    Pallas kernels in interpret mode (o taken in f32 for the loss)."""
    def loss(q, k, v):
        if w is None:
            o = jfa.flash_attention(q, k, v, causal=causal, interpret=True).astype(jnp.float32)
            return jnp.sum(o * jnp.cos(o))
        o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal, interpret=True)
        return jnp.sum(o * jnp.cos(o)) + jnp.sum(lse * w)
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


def _port_grads(q, k, v, causal, w=None, needs=(True, True, True)):
    ts = [torch.from_numpy(a).requires_grad_(n) for a, n in zip((q, k, v), needs)]
    if w is None:
        o = tfa.flash_attention(*ts, causal=causal)
        loss = (o * o.cos()).sum()
    else:
        o, lse = tfa.flash_attention_with_lse(*ts, causal=causal)
        loss = (o * o.cos()).sum() + (lse * torch.from_numpy(w)).sum()
    loss.backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_reference_kernels(case):
    """dQ, dK, dV through the port's Function (its plain backward on CPU
    tensors) against jax.grad of the reference's _dq_kernel/_dkv_kernel."""
    Sq, Sk, D, causal = CASES[case]
    q, k, v = _qkv(Sq, Sk, D, seed=5)
    before = (tfa.flash_attention_dq_kernel.launches, tfa.flash_attention_dkv_kernel.launches)
    got = _port_grads(q, k, v, causal)
    for g, want, name in zip(got, _ref_grads(q, k, v, causal), "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    after = (tfa.flash_attention_dq_kernel.launches, tfa.flash_attention_dkv_kernel.launches)
    assert after == before  # CPU tensors never reach a kernel


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_lse_cotangent_matches_reference(causal):
    """flash_attention_with_lse honours a non-zero LSE cotangent (the ring
    attention combine's backward), Sq < Sk."""
    q, k, v = _qkv(128, 256, 64, seed=6)
    w = np.random.RandomState(7).randn(1, 2, 128).astype(np.float32)
    got = _port_grads(q, k, v, causal, w)
    for g, want, name in zip(got, _ref_grads(q, k, v, causal, jnp.asarray(w)), "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")


def test_autograd_raises_until_the_backward_is_ported():
    """The backward is ported: autograd through flash_attention no longer
    raises, and a gradient for q alone matches the reference's; under
    no_grad the forward runs as before."""
    q, k, v = _qkv(128, 128, 64)
    got = _port_grads(q, k, v, True, needs=(True, False, False))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(_ref_grads(q, k, v, True)[0]),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    assert got[1] is None and got[2] is None
    with torch.no_grad():
        assert tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=True).shape == q.shape


@pytest.mark.parametrize("with_dlse", [False, True], ids=["no_dlse", "dlse"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_plain_bwd_stats_layout(dtype, with_dlse):
    """``_flash_bwd_stats_dense`` (the statistics pass's plain version and
    its oracle on the card) at Sq = 100, not a multiple of 64: the pad up to
    Sqp = 128 is exactly zero, row 0 is lse * log2(e), and row 1 is the
    reference's dsum, ``jnp.sum(do.astype(f32) * o.astype(f32), -1) - dlse``
    as ``_dq_kernel`` writes it, run in JAX on the same values (within 1e-6
    of its max: f32 sums of 64 products in another order)."""
    B, Sq, H, D = 2, 100, 3, 64
    rng = np.random.RandomState(11)
    tdt = getattr(torch, dtype)
    o, do = (torch.from_numpy(rng.randn(B, Sq, H, D).astype(np.float32)).to(tdt)
             for _ in range(2))
    lse = rng.randn(B, H, Sq).astype(np.float32)
    dlse = rng.randn(B, H, Sq).astype(np.float32) if with_dlse else None
    stats = tfa._flash_bwd_stats_dense(o, do, torch.from_numpy(lse),
                                       None if dlse is None else torch.from_numpy(dlse))
    assert stats.dtype == torch.float32 and tuple(stats.shape) == (2, B * H, 128)
    assert torch.count_nonzero(stats[:, :, Sq:]) == 0
    np.testing.assert_allclose(stats[0, :, :Sq].numpy(),
                               lse.reshape(B * H, Sq) * np.float32(np.log2(np.e)),
                               rtol=1e-6, atol=0)
    jdt = getattr(jnp, dtype)
    jo, jdo = (jnp.asarray(t.float().numpy()).astype(jdt) for t in (o, do))
    want = jnp.sum(jdo.astype(jnp.float32) * jo.astype(jnp.float32), -1)  # [B, Sq, H]
    want = np.asarray(want).transpose(0, 2, 1)
    if dlse is not None:
        want = want - dlse
    want = want.reshape(B * H, Sq)
    err = np.abs(stats[1, :, :Sq].numpy() - want).max()
    assert err <= 1e-6 * np.abs(want).max(), err


def test_plain_backward_rounds_where_the_reference_rounds():
    """In bf16 the plain backward rounds P to bf16 for dV and dS for dQ/dK,
    as _dq_kernel/_dkv_kernel do: equal to the f32 version on the bf16
    values up to those roundings, not bit-equal to it."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(128, 128, 64, seed=8))
    o, lse = tfa._flash_dense(q, k, v, True, 0.125)
    do = torch.from_numpy(np.random.RandomState(9).randn(1, 128, 2, 64).astype(np.float32))
    bf = tfa._flash_bwd_dense(q, k, v, o, lse, do.bfloat16(), True, 0.125)
    f32 = tfa._flash_bwd_dense(q.float(), k.float(), v.float(), o.float(), lse,
                               do.bfloat16().float(), True, 0.125)
    for a, b in zip(bf, f32):
        assert a.dtype == torch.bfloat16
        rel = ((a.float() - b).abs().max() / b.abs().max()).item()
        assert 0 < rel < 2e-2


def test_supports_seq_matches_reference():
    for n in (8, 96, 128, 500, 512, 520, 640, 1000, 1024, 2048):
        assert tfa.supports_seq(n) == jfa.supports_seq(n)


def test_sdpa_flash_backend_matches_reference():
    """backend="flash" takes flash on any device in both packages (the
    reference runs its Pallas kernel in interpret mode here)."""
    q, k, v = _qkv(256, 256, 64, seed=3)
    want = JF.scaled_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           is_causal=True, backend="flash")
    got = TF.scaled_dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                          is_causal=True, backend="flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(want, "_value", want)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,kw,want", [
    # (B, Sq, Sk, H, D), options -> the kernel the reference picks on its
    # accelerator (nn/functional/attention.py), which the port takes on CUDA
    ((2, 128, 128, 4, 128), {}, "encoder_attention"),
    ((1, 512, 512, 4, 64), dict(is_causal=True), "encoder_attention"),
    ((1, 384, 512, 4, 64), {}, None),                 # encoder is self-attention only
    ((1, 1024, 1024, 4, 128), dict(is_causal=True), "flash_attention"),
    ((1, 1024, 2048, 4, 128), dict(is_causal=True), "flash_attention"),
    ((1, 2048, 1024, 4, 128), dict(is_causal=True), None),   # causal Sq > Sk
    ((1, 1000, 1000, 4, 128), {}, None),              # not tileable
    ((1, 64, 64, 4, 128), {}, None),                  # short: dense math
    ((1, 1024, 1024, 4, 128), dict(backend="math"), None),
    ((1, 1024, 1024, 4, 128), dict(mask=True), None),
    ((1, 256, 256, 4, 96), dict(backend="flash"), "flash_attention"),
    ((1, 1024, 1024, 4, 256), {}, "flash_attention"),  # D = 256 takes flash too
], ids=lambda x: str(x) if not isinstance(x, tuple) else "x".join(map(str, x)))
def test_sdpa_routing_follows_the_reference(shape, kw, want):
    B, Sq, Sk, H, D = shape
    q = torch.zeros(B, Sq, H, D)
    k = torch.zeros(B, Sk, H, D)
    mask = torch.ones(Sq, Sk, dtype=torch.bool) if kw.get("mask") else None
    assert _reference_kernel(q, k, mask, kw.get("is_causal", False),
                             kw.get("backend", "auto")) == want


def test_kernel_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(128, 128, 64))
    before = tfa.flash_attention_kernel.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        tfa.flash_attention_kernel(q, k, v, causal=True)
    assert tfa.flash_attention_kernel.launches == before


@pytest.mark.parametrize("which", ["dq", "dkv", "f32_dq", "f32_dkv", "f32_bwd_stats",
                                   "f32_bwd_split"])
def test_backward_kernel_wrappers_reject_cpu_tensors(which):
    """The backward wrappers, at bfloat16 and at float32 (the same
    tensor-core wrappers, and float32's split pass), launch on CUDA tensors
    only and never run the plain version; a refused call does not count."""
    dt = torch.float32 if which.startswith("f32") else torch.bfloat16
    q, k, v = (torch.from_numpy(a).to(dt) for a in _qkv(128, 128, 64))
    lse = torch.zeros(1, 2, 128)
    if which == "f32_bwd_stats":
        fn, args = tfa.flash_attention_bwd_stats, (q, q, lse)
    elif which == "f32_bwd_split":
        fn, args = tfa.flash_attention_bwd_split, (q, k, v, q)
    else:
        fn = getattr(tfa, f"flash_attention_{which.removeprefix('f32_')}_kernel")
        args = (q, k, v, q, q, lse)
    before = fn.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        fn(*args)
    assert fn.launches == before
