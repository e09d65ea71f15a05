"""Port parity: paddle_tpu_torch's encoder attention, forward and backward,
against the JAX reference on the CPU, in f32.

The port's plain ``_encoder_dense`` and ``_encoder_bwd_dense`` (what CPU
tensors take, and the oracles of the Hopper kernels in chip_smoke.py) are
held against the reference's Pallas ``encoder_attention`` in interpret mode
at dropout rate 0, on the same numpy-seeded inputs.  With dropout, whose
bits differ between the platforms by design, they are held against a jnp
composition of the reference kernel's math (``_fwd_kernel``: softmax, then
where(keep, p / (1 - rate), 0), then P.V) fed the port's own Philox mask,
and its ``jax.grad``.  Tolerance 1e-5 absolute on the output and 1e-4 on
the gradients, as the reference's own test (tests/test_encoder_attention.py):
f32 on both sides.  The gradients are of sum(o * cos(o)).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import encoder_attention as jea
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import encoder_attention as tea

TOL = 1e-5
GRAD_TOL = 1e-4


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


def _ref_grads(fn, q, k, v):
    def loss(q, k, v):
        o = fn(q, k, v)
        o = getattr(o, "_value", o)
        return jnp.sum(o * jnp.cos(o))
    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


def _port_grads(fn, q, k, v):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = fn(*ts)
    (o * o.cos()).sum().backward()
    return [t.grad for t in ts]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 256])
def test_backward_matches_reference_kernel(S, D, causal):
    """dQ, dK, dV through the port's Function (its plain backward on CPU
    tensors) against jax.grad of the reference's _bwd_kernel at rate 0."""
    q, k, v = _qkv(S, D, seed=S + D + 1)
    before = tea.encoder_attention_bwd_kernel.launches
    got = _port_grads(lambda *a: tea.encoder_attention(*a, causal=causal), q, k, v)
    want = _ref_grads(lambda *a: jea.encoder_attention(*a, causal=causal), q, k, v)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    assert tea.encoder_attention_bwd_kernel.launches == before


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_sdpa_auto_grads_match_reference(causal):
    """SDPA(backend="auto") at an encoder shape: the gradients through the
    port's routing equal those through the reference's (off the
    accelerator both take the dense math)."""
    q, k, v = _qkv(128, 64, B=2, seed=11)
    got = _port_grads(lambda *a: TF.scaled_dot_product_attention(*a, is_causal=causal), q, k, v)
    want = _ref_grads(lambda *a: JF.scaled_dot_product_attention(*a, is_causal=causal), q, k, v)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")


def _ref_dropout_math(keep, rate, causal, scale):
    """The reference _fwd_kernel's math in jnp, on [B, S, H, D], with an
    explicit keep mask [B, H, S, S]."""
    def fn(q, k, v):
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * scale
        if causal:
            S = q.shape[1]
            s = s + jnp.where(jnp.arange(S)[:, None] >= jnp.arange(S)[None, :], 0.0, -1e30)
        m = jnp.max(s, axis=-1, keepdims=True)
        e = jnp.exp(s - m)
        p = e / jnp.sum(e, axis=-1, keepdims=True)
        p = jnp.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        return jnp.einsum("bhqk,bkhd->bqhd", p.astype(v.dtype), v)
    return fn


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("S,D", [(128, 64), (256, 128)])
def test_dropout_matches_reference_math_with_the_ports_mask(S, D, causal):
    """Rate 0.1: forward and dQ, dK, dV through the port's Function (its
    plain versions on CPU tensors), the mask regenerated in the backward
    from the saved seed, against jax.grad of the reference kernel's math
    fed the same mask."""
    rate, B, H = 0.1, 2, 2
    q, k, v = _qkv(S, D, B=B, H=H, seed=S + D + 7)
    seed = torch.tensor([S * 7, -D], dtype=torch.int32)
    keep = tea.dropout_keep(seed, B, H, S, rate)
    kc = keep.float().mean().item()
    assert abs(kc - (1 - rate)) < 5 * (rate * (1 - rate) / keep.numel()) ** 0.5
    fn = _ref_dropout_math(jnp.asarray(keep.numpy()), rate, causal, 1.0 / D ** 0.5)
    want = fn(*(jnp.asarray(a) for a in (q, k, v)))
    got = tea.encoder_attention(*(torch.from_numpy(a) for a in (q, k, v)), seed=seed,
                                dropout_rate=rate, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    gots = _port_grads(lambda *a: tea.encoder_attention(*a, seed=seed, dropout_rate=rate,
                                                        causal=causal), q, k, v)
    wants = _ref_grads(fn, q, k, v)
    for g, w, name in zip(gots, wants, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")
    # and a mask one key over is far outside the tolerance
    off = _ref_dropout_math(jnp.asarray(keep.roll(1, -1).numpy()), rate, causal, 1.0 / D ** 0.5)
    assert np.abs(np.asarray(off(*(jnp.asarray(a) for a in (q, k, v)))) - got.numpy()).max() > 0.05


def test_dropout_needs_a_seed_and_routes_like_the_reference():
    q, k, v = (torch.from_numpy(a) for a in _qkv(128, 64))
    with pytest.raises(ValueError, match="requires a seed"):
        tea.encoder_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError, match="requires a seed"):
        jea.encoder_attention(*(jnp.asarray(a) for a in _qkv(128, 64)), dropout_rate=0.1)
    from paddle_tpu_torch.nn.functional.attention import _reference_kernel

    enc = torch.empty(2, 128, 12, 64, device="meta")
    long = torch.empty(1, 2048, 16, 128, device="meta")
    assert _reference_kernel(enc, enc, None, False, "auto", dropout=True) == "encoder_attention"
    assert _reference_kernel(long, long, None, True, "auto") == "flash_attention"
    assert _reference_kernel(long, long, None, True, "auto", dropout=True) is None
    assert _reference_kernel(long, long, None, True, "flash", dropout=True) is None


def test_sdpa_dropout_on_cpu_takes_the_dense_math():
    """CPU tensors with dropout: the dense path masks the probabilities
    (eval turns it off); the gradients flow through the same mask."""
    from paddle_tpu_torch import seed

    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(128, 64, B=2))
    seed(5)
    a = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    seed(5)
    b = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    c = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5, training=False)
    d = TF.scaled_dot_product_attention(q, k, v)
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.allclose(a, d)
    a.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


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
    before = tea.encoder_attention_bwd_kernel.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        tea.encoder_attention_bwd_kernel(q, k, v, q)
    assert tea.encoder_attention_bwd_kernel.launches == before


def _packed(S, D, B=1, H=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, 3, H, D) * 0.5).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("S,D", [(128, 64), (256, 128)])
def test_packed_qkv_views_match_copies_and_reference(S, D, causal):
    """ERNIE's attention takes q, k, v as the three strided slices of one
    packed [B, S, 3, H, D] projection (``unbind(2)``): through the port's
    Function they give the forward and the packed gradient that contiguous
    copies give, and both match the reference's Pallas kernel (interpret
    mode) and its jax.grad."""
    packed = _packed(S, D, seed=S + D + (3 if causal else 5))
    x = torch.from_numpy(packed).requires_grad_(True)
    q, k, v = x.unbind(2)
    assert not q.is_contiguous() and q.stride() == (S * 3 * 2 * D, 3 * 2 * D, D, 1)
    o = tea.encoder_attention(q, k, v, causal=causal)
    (o * o.cos()).sum().backward()
    copies = [torch.from_numpy(np.ascontiguousarray(packed[:, :, i])) for i in range(3)]
    want_o = tea.encoder_attention(*copies, causal=causal)
    want_g = _port_grads(lambda *a: tea.encoder_attention(*a, causal=causal),
                         *(c.numpy() for c in copies))
    np.testing.assert_allclose(o.detach().numpy(), want_o.numpy(), rtol=1e-6, atol=1e-6)
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(x.grad[:, :, i].numpy(), want_g[i].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"d{name}")
    ref = [jnp.asarray(c.numpy()) for c in copies]
    np.testing.assert_allclose(o.detach().numpy(),
                               np.asarray(jea.encoder_attention(*ref, causal=causal)),
                               rtol=TOL, atol=TOL)
    ref_g = _ref_grads(lambda *a: jea.encoder_attention(*a, causal=causal),
                       *(c.numpy() for c in copies))
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(x.grad[:, :, i].numpy(), np.asarray(ref_g[i]), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def _view(kind):
    """A [2, 128, 4, 64] bf16 view of each kind the kernels' admission sorts."""
    B, S, H, D = 2, 128, 4, 64
    if kind == "contiguous":
        return torch.empty(B, S, H, D, dtype=torch.bfloat16)
    if kind == "packed_slice":
        return torch.empty(B, S, 3, H, D, dtype=torch.bfloat16).unbind(2)[1]
    if kind == "one_batch_packed":
        return torch.empty(1, S, 3, H, D, dtype=torch.bfloat16).unbind(2)[2]
    if kind == "head_major_transposed":
        return torch.empty(B, H, S, D, dtype=torch.bfloat16).transpose(1, 2)
    if kind == "strided_last_dim":
        return torch.empty(B, S, H, 2 * D, dtype=torch.bfloat16)[..., ::2]
    if kind == "row_stride_not_16_bytes":
        return torch.empty(B * S * (H * D + 4), dtype=torch.bfloat16).as_strided(
            (B, S, H, D), (S * (H * D + 4), H * D + 4, D, 1))
    raise AssertionError(kind)


@pytest.mark.parametrize("kind,launches_as_is", [
    ("contiguous", True), ("packed_slice", True), ("one_batch_packed", True),
    ("head_major_transposed", False), ("strided_last_dim", False),
    ("row_stride_not_16_bytes", False)])
def test_tma_admission_of_views(kind, launches_as_is):
    """Which views the kernels read in place (TMA: last dimension
    contiguous, heads D apart, 16-byte row and batch strides) and which the
    wrapper copies first; a pure function of shape, strides and address."""
    t = _view(kind)
    assert tea.tma_readable(tuple(t.shape), t.stride(), 0, t.element_size()) is launches_as_is
    assert not tea.tma_readable(tuple(t.shape), t.stride(), 8, t.element_size())  # misaligned
    if launches_as_is:
        h, s, b = tea._tma_strides(t)
        assert h == 64 and s % 8 == 0 and b % 8 == 0 and s > 0 and b > 0
        if kind == "packed_slice":
            assert (h, s, b) == (64, 3 * 4 * 64, 128 * 3 * 4 * 64)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("S,D", [(128, 64), (256, 128)])
def test_plain_lse_matches_logsumexp_of_reference_scores(S, D, causal):
    """The forward kernel's second output (each row's logsumexp, which the
    backward at S > 128 reads): its plain version against
    jax.nn.logsumexp of the reference kernel's scaled, masked scores."""
    q, k, _ = _qkv(S, D, B=2, seed=S + D + 9)
    scale = 1.0 / D ** 0.5
    s = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q), jnp.asarray(k)) * scale
    if causal:
        s = s + jea._causal_neg(S)[None, None]
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(-1, S)
    got = tea._encoder_lse(torch.from_numpy(q), torch.from_numpy(k), scale, causal)
    assert got.shape == (2 * 2, S) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
