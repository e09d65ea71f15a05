"""Port parity for the layers ResNet is built from: paddle_tpu_torch's
``F.conv2d``/``Conv2D``, ``F.batch_norm``/``BatchNorm2D``, ``F.max_pool2d``,
``F.adaptive_avg_pool2d``, ``ReLU`` and ``CrossEntropyLoss`` against
paddle_tpu's, on the same numpy-seeded inputs and weights, on the CPU.

Tolerances: TOL = 1e-5 of max |reference| for f32 outputs and gradients
(the two sides differ in the order of their f32 sums only); pooling and
ReLU pick or average the same values, within 1e-6.  The running buffers
after a training call match within 1e-6 in f32; in bf16 they must be
equal, bit for bit: ``momentum * running`` rounds 0.9 to bf16
(0.8984375) on both sides, as JAX does with a Python scalar, and the sum
is taken in f32 and rounded back.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

TOL = 1e-5


def _np(t):
    """A reference Tensor or a torch tensor as f32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._value.astype(jnp.float32))


def _close(got, want, tol=TOL, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{msg}: {err:.3e} of max |reference| (tol {tol})"


def _pair(fn_ref, fn_port, arrays, dout_seed=0):
    """Run fn on both sides with the arrays as leaves needing gradients;
    compare the outputs and the gradients of sum(out * dout)."""
    jt = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    tt = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    jo, to = fn_ref(*jt), fn_port(*tt)
    _close(to, jo, msg="output")
    dout = np.asarray(np.random.RandomState(dout_seed).randn(*to.shape), np.float32)
    (jo * paddle.to_tensor(dout)).sum().backward()
    (to * torch.from_numpy(dout)).sum().backward()
    for i, (j, t) in enumerate(zip(jt, tt)):
        _close(t.grad, j.grad, msg=f"grad {i}")


CONV_CASES = [  # (N, C, H, W, Cout, k, stride, padding, dilation, groups, bias)
    (2, 4, 9, 9, 8, 3, 1, 1, 1, 1, True),
    (2, 4, 10, 9, 6, 3, 2, [1, 2], 1, 1, False),
    (2, 6, 11, 11, 6, 3, 2, [0, 1, 2, 1], 1, 3, True),
    (1, 4, 12, 12, 8, 3, 1, [2, 1, 1, 2], 2, 1, False),
    (2, 4, 9, 9, 8, 3, 2, "SAME", 1, 2, True),
    (2, 4, 9, 9, 8, 2, 2, "VALID", 1, 1, False),
    (2, 3, 16, 16, 8, 7, 2, 3, 1, 1, False),   # ResNet's stem
    (2, 8, 7, 7, 16, 1, 2, 0, 1, 1, False),    # a strided 1x1 projection
]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[str(i) for i in range(len(CONV_CASES))])
def test_conv2d_matches_reference(case, fmt):
    N, C, H, W, Co, k, s, pad, d, g, bias = case
    rng = np.random.RandomState(len(str(case)))
    shape = (N, C, H, W) if fmt == "NCHW" else (N, H, W, C)
    arrays = [rng.randn(*shape).astype(np.float32),
              (rng.randn(Co, C // g, k, k) * 0.2).astype(np.float32)]
    if bias:
        arrays.append(rng.randn(Co).astype(np.float32))
    kw = dict(stride=s, padding=pad, dilation=d, groups=g, data_format=fmt)
    _pair(lambda *a: JF.conv2d(*a, **kw), lambda *a: TF.conv2d(*a, **kw), arrays)


def test_conv2d_nested_padding_is_the_flat_form():
    """[[0, 0], [0, 0], [h0, h1], [w0, w1]] pads as [h0, h1, w0, w1].  The
    reference's 2-D conv raises TypeError on the nested form (its
    ``_conv_padding`` tests for 2 * nd entries first, which is 4 here too),
    so the port is held to its own flat form."""
    rng = np.random.RandomState(9)
    x, w = torch.from_numpy(rng.randn(1, 4, 12, 12).astype(np.float32)), torch.randn(8, 4, 3, 3)
    torch.testing.assert_close(TF.conv2d(x, w, padding=[[0, 0], [0, 0], [2, 1], [1, 2]]),
                               TF.conv2d(x, w, padding=[2, 1, 1, 2]), rtol=0, atol=0)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_layer_carries_reference_weights(fmt):
    paddle.seed(3)
    jl = jnn.Conv2D(4, 8, 3, stride=2, padding=1, data_format=fmt)
    tl = tnn.Conv2D(4, 8, 3, stride=2, padding=1, data_format=fmt, device="cpu")
    assert {k: tuple(v.shape) for k, v in tl.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jl.state_dict().items()}
    tl.load_state_dict({k: torch.from_numpy(np.asarray(v._value))
                        for k, v in jl.state_dict().items()})
    x = np.random.RandomState(0).randn(*((2, 4, 8, 8) if fmt == "NCHW" else (2, 8, 8, 4)))
    x = x.astype(np.float32)
    _close(tl(torch.from_numpy(x)), jl(paddle.to_tensor(x)), msg="Conv2D")
    # the port's own init: the reference's Kaiming-uniform limit sqrt(6 / fan_in)
    lim = np.sqrt(6.0 / (4 * 9))
    assert tl.weight.abs().max() <= lim and tl.weight.abs().max() > 0.8 * lim
    assert tnn.Conv2D(4, 8, 1, bias_attr=False, device="cpu").bias is None


def _bn_pair(fmt, dtype="float32"):
    paddle.seed(5)
    jl = jnn.BatchNorm2D(6, data_format=fmt)
    tl = tnn.BatchNorm2D(6, data_format=fmt, device="cpu")
    rng = np.random.RandomState(1)
    state = {"weight": 1 + 0.1 * rng.randn(6), "bias": 0.1 * rng.randn(6),
             "_mean": 0.3 * rng.randn(6), "_variance": 1 + 0.2 * rng.rand(6)}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    for k, v in state.items():
        getattr(jl, k).set_value(paddle.to_tensor(v))
    tl.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    if dtype == "bfloat16":
        jl.bfloat16()
        tl.bfloat16()
    return jl, tl


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_reference(fmt, training):
    jl, tl = _bn_pair(fmt)
    jl.train() if training else jl.eval()
    tl.train(training)
    shape = (4, 6, 5, 3) if fmt == "NCHW" else (4, 5, 3, 6)
    x = (np.random.RandomState(2).randn(*shape) * 2 + 0.5).astype(np.float32)
    _pair(jl, tl, [x])
    for name in ("_mean", "_variance"):  # one training call moved them
        _close(getattr(tl, name), getattr(jl, name), tol=1e-6, msg=name)
    for name in ("weight", "bias"):
        _close(getattr(tl, name).grad, getattr(jl, name).grad, msg=f"d{name}")


def test_batch_norm_functional_matches_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 4, 4).astype(np.float32)
    rm, rv = rng.randn(5).astype(np.float32), (1 + rng.rand(5)).astype(np.float32)
    jm, jv = paddle.to_tensor(rm), paddle.to_tensor(rv)
    tm, tv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    for kw in (dict(training=True, momentum=0.8, epsilon=1e-3), dict(training=False),
               dict(training=True, use_global_stats=True)):
        _close(TF.batch_norm(torch.from_numpy(x), tm, tv, **kw),
               JF.batch_norm(paddle.to_tensor(x), jm, jv, **kw), msg=str(kw))
        _close(tm, jm, tol=1e-6, msg="running mean")
        _close(tv, jv, tol=1e-6, msg="running var")


def test_batch_norm_bf16_buffers_round_like_reference():
    jl, tl = _bn_pair("NHWC", "bfloat16")
    assert tl._mean.dtype == torch.bfloat16 and tl.weight.dtype == torch.bfloat16
    x = np.random.RandomState(6).randn(8, 4, 4, 6).astype(np.float32) * 3 + 1
    for _ in range(3):
        jo = jl(paddle.to_tensor(x).astype("bfloat16"))
        to = tl(torch.from_numpy(x).bfloat16())
    _close(to, jo, tol=1e-2, msg="bf16 output")  # one bf16 step, 2^-7
    for name in ("_mean", "_variance"):
        np.testing.assert_array_equal(_np(getattr(tl, name)), _np(getattr(jl, name)),
                                      err_msg=name)
    # torch's own rule (an unrounded 0.9 in f32 opmath) lands elsewhere
    rm = torch.full((6,), 1.5, dtype=torch.bfloat16)
    assert (rm * 0.9).float()[0] != (rm * 0.8984375).float()[0]


POOL_CASES = [  # (H, W, kernel, stride, padding)
    (9, 9, 3, 2, 1),       # ResNet's stem pool
    (8, 7, 2, None, 0),
    (9, 10, 3, 2, [1, 0]),
    (8, 8, 3, 2, [0, 1, 2, 1]),
    (9, 9, 3, 2, "SAME"),
    (7, 7, 3, 1, "VALID"),
]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", POOL_CASES, ids=[str(i) for i in range(len(POOL_CASES))])
def test_max_pool2d_matches_reference(case, fmt):
    H, W, k, s, pad = case
    shape = (2, 3, H, W) if fmt == "NCHW" else (2, H, W, 3)
    x = (np.random.RandomState(H * W).randn(*shape) - 2.0).astype(np.float32)  # mostly < 0
    kw = dict(kernel_size=k, stride=s, padding=pad, data_format=fmt)
    _pair(lambda a: JF.max_pool2d(a, **kw), lambda a: TF.max_pool2d(a, **kw), [x])
    _close(tnn.MaxPool2D(k, s, pad, data_format=fmt)(torch.from_numpy(x)),
           jnn.MaxPool2D(k, s, pad, data_format=fmt)(paddle.to_tensor(x)), msg="layer")


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("size,out", [((4, 4), (1, 1)), ((7, 5), (1, 1)), ((7, 5), (3, 2)),
                                      ((6, 6), 2)])
def test_adaptive_avg_pool2d_matches_reference(size, out, fmt):
    shape = (2, 3, *size) if fmt == "NCHW" else (2, *size, 3)
    x = np.random.RandomState(7).randn(*shape).astype(np.float32)
    _pair(lambda a: JF.adaptive_avg_pool2d(a, out, data_format=fmt),
          lambda a: TF.adaptive_avg_pool2d(a, out, data_format=fmt), [x])
    _close(tnn.AdaptiveAvgPool2D(out, data_format=fmt)(torch.from_numpy(x)),
           jnn.AdaptiveAvgPool2D(out, data_format=fmt)(paddle.to_tensor(x)), msg="layer")


def test_pooling_options_not_ported_raise():
    x = torch.zeros(1, 1, 4, 4)
    for kw in (dict(return_mask=True), dict(ceil_mode=True)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            TF.max_pool2d(x, 2, **kw)


def test_relu_and_cross_entropy_layers_match_reference():
    rng = np.random.RandomState(8)
    x = rng.randn(6, 10).astype(np.float32)
    _pair(jnn.ReLU(), tnn.ReLU(), [x])
    labels = rng.randint(0, 10, (6,)).astype(np.int64)
    for kw in (dict(), dict(reduction="sum"), dict(label_smoothing=0.1)):
        _pair(lambda a: jnn.CrossEntropyLoss(**kw)(a, paddle.to_tensor(labels)),
              lambda a: tnn.CrossEntropyLoss(**kw)(a, torch.from_numpy(labels)), [x])
