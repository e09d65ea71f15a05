"""Port parity: paddle_tpu_torch's flash attention forward and the SDPA
routing against the JAX reference on the CPU, in f32.

The port's plain ``_flash_dense`` (what CPU tensors take, and the oracle of
the Hopper kernel in chip_smoke.py) is held against the reference's Pallas
``flash_attention`` and ``flash_attention_with_lse`` in interpret mode, on
the same numpy-seeded inputs.  Tolerance 2e-5 on O and on the logsumexp,
as the reference's own flash tests (tests/test_flash_attention.py): both
sides compute in f32 and differ in summation order only.
"""
import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional.attention import _reference_kernel
from paddle_tpu_torch.ops import flash_attention as tfa

# the module: paddle_tpu.ops re-exports its function under the same name
jfa = importlib.import_module("paddle_tpu.ops.flash_attention")
TOL = 2e-5


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


def test_autograd_raises_until_the_backward_is_ported():
    q, k, v = (torch.from_numpy(a) for a in _qkv(128, 128, 64))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        tfa.flash_attention(q, k, v, causal=True)
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v, causal=True).shape == q.shape


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
