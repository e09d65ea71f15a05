"""Port parity: paddle_tpu_torch's encoder attention forward against the
JAX reference on the CPU, in f32.

The port's plain ``_encoder_dense`` (what CPU tensors take, and the oracle
of the Hopper kernel in chip_smoke.py) is held against the reference's
Pallas ``encoder_attention`` in interpret mode at dropout rate 0, on the
same numpy-seeded inputs.  Tolerance 1e-5 absolute, as the reference's own
test (tests/test_encoder_attention.py): f32 on both sides.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from paddle_tpu.ops import encoder_attention as jea
from paddle_tpu_torch.ops import encoder_attention as tea

TOL = 1e-5


def _qkv(S, D, B=1, H=2, seed=0):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(B, S, H, D) * 0.5).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 256])
def test_plain_matches_reference_kernel(S, D, causal):
    q, k, v = _qkv(S, D, seed=S + D)
    want = jea.encoder_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal)
    got = tea.encoder_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_dropout_raises_until_philox_is_ported():
    q, k, v = (torch.from_numpy(a) for a in _qkv(128, 64))
    with pytest.raises(NotImplementedError, match="Queue 2 item 4"):
        tea.encoder_attention(q, k, v, seed=torch.tensor([3, 9]), dropout_rate=0.1)


def test_admission_matches_reference():
    for bh in (1, 8, 96):
        for s in (64, 128, 200, 256, 384, 512, 640):
            for d in (32, 64, 96, 128):
                for skv in (None, s, s + 128):
                    assert tea.supported(bh, s, d, skv) == jea.supported(bh, s, d, skv), \
                        (bh, s, d, skv)
    q, k, v = (torch.from_numpy(a) for a in _qkv(192, 64))
    with pytest.raises(ValueError, match="unsupported"):
        tea.encoder_attention(q, k, v)


def test_kernel_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(128, 64))
    before = tea.encoder_attention_kernel.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        tea.encoder_attention_kernel(q, k, v)
    assert tea.encoder_attention_kernel.launches == before
