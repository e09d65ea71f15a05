"""Port parity: paddle_tpu_torch.nn.functional.cross_entropy against the JAX
reference's (paddle_tpu/nn/functional/loss.py) on the CPU.

Same numpy-seeded logits and labels on both sides.  In f32 the loss and its
gradient agree within 1e-6 relative and absolute: both take the logsumexp
in f32 and differ in summation order only.  With bf16 logits both do the
math in f32 and return a bf16 loss, so the loss agrees within one bf16
rounding (2^-8 relative) and the bf16 gradient within one rounding of its
largest element.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu_torch.nn import functional as TF

TOL = 1e-6
N, V = 12, 40


def _val(x):
    return np.asarray(getattr(x, "_value", x))


def _data(seed=0, ignored=(2, 7)):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(N, V) * 3).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int64)
    labels[list(ignored)] = -100
    return logits, labels


def _both(logits, labels, **kw):
    want = _val(JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), **kw))
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), **kw)
    return got, want


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_hard_labels_with_ignored_rows(reduction):
    logits, labels = _data()
    got, want = _both(logits, labels, reduction=reduction)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    if reduction == "none":
        assert (got.numpy()[[2, 7]] == 0).all()


def test_all_ignored_batch_is_zero_not_nan():
    logits, labels = _data(ignored=range(N))
    got, want = _both(logits, labels)
    assert float(got) == float(want) == 0.0


def test_label_with_trailing_axis_and_other_axis():
    logits, labels = _data(seed=1)
    got, want = _both(logits, labels[:, None])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    x3 = np.ascontiguousarray(logits.reshape(3, 4, V).transpose(0, 2, 1))  # classes on axis 1
    got, want = _both(x3, labels.reshape(3, 4), axis=1, reduction="none")
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_weight_soft_label_and_smoothing(reduction):
    logits, labels = _data(seed=2)
    w = np.random.RandomState(3).rand(V).astype(np.float32) + 0.5
    want = _val(JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), weight=jnp.asarray(w),
                                 reduction=reduction))
    got = TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           weight=torch.from_numpy(w), reduction=reduction)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    got, want = _both(logits, labels, reduction=reduction, label_smoothing=0.1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    soft = np.random.RandomState(4).rand(N, V).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    for ls in (0.0, 0.2):
        got, want = _both(logits, soft, soft_label=True, reduction=reduction, label_smoothing=ls)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    got, want = _both(probs, labels, use_softmax=False, reduction=reduction)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_bf16_logits_keep_their_dtype():
    logits, labels = _data(seed=5)
    want = JF.cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels))
    want = _val(want)
    got = TF.cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels))
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=2 ** -8)


@pytest.mark.parametrize("kw", [{}, {"reduction": "sum"}, {"label_smoothing": 0.1},
                                {"soft_label": True}],
                         ids=["hard_mean", "hard_sum", "smoothing", "soft"])
def test_gradients_match(kw):
    logits, labels = _data(seed=6)
    if kw.get("soft_label"):
        labels = np.random.RandomState(7).dirichlet(np.ones(V), N).astype(np.float32)

    want = np.asarray(jax.grad(lambda x: _val_traced(JF.cross_entropy(
        x, jnp.asarray(labels), **kw)))(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_(True)
    TF.cross_entropy(x, torch.from_numpy(labels), **kw).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=TOL, atol=TOL)
    if not kw:
        assert (x.grad.numpy()[[2, 7]] == 0).all()  # ignored rows get no gradient


def test_bf16_gradient():
    logits, labels = _data(seed=8)
    want = np.asarray(jax.grad(lambda x: _val_traced(JF.cross_entropy(x, jnp.asarray(labels))))(
        jnp.asarray(logits, jnp.bfloat16))).astype(np.float32)
    x = torch.from_numpy(logits).bfloat16().requires_grad_(True)
    TF.cross_entropy(x, torch.from_numpy(labels)).backward()
    assert x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(x.grad.float().numpy(), want, atol=np.abs(want).max() * 2 ** -8)


def _val_traced(x):
    return getattr(x, "_value", x)
