"""Port parity for the fused 1x1-conv + BatchNorm op: paddle_tpu_torch's
``ops.fused_conv_bn.conv1x1_bn`` (on the CPU: the kernels' plain versions)
against paddle_tpu's (its Pallas kernels in interpret mode), on the same
numpy-seeded inputs.

Cases: the reference test's shapes (tests/test_fused_conv_bn.py: [4, 8, 8,
64] -> 128 with and without the fold, [2, 4, 8, 128] -> 64 with W' = 8 >
wv = 6, so that pad columns are masked) and [2, 2, 16, 256] -> 192 at wv 13;
each without the fold, and with it with and without the ReLU; f32 and
bf16.  Compared: y,
s1, s2 and the four gradients of one vjp with the same (dy, ds1, ds2).

Tolerances, of max |reference| per output:
- f32, F32_TOL = 1e-5: the two sides differ only in the order of their
  f32 sums (measured on the CPU: at most 5.8e-7).
- bf16, BF16_TOL = 1e-2: y and dx are rounded to bf16, and where the two
  f32 accumulations round to neighbouring bf16 values an element moves by
  one bf16 step, at most 2^-7 of it; the sums and dW inherit that
  (measured on the CPU: at most 6.9e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_conv_bn as ref
from paddle_tpu_torch.ops import fused_conv_bn as port

F32_TOL = 1e-5
BF16_TOL = 1e-2
SHAPES = [(4, 8, 8, 64, 128, 8), (2, 4, 8, 128, 64, 6), (2, 2, 16, 256, 192, 13)]
MODES = {"no_fold": (False, True), "fold_relu": (True, True), "fold_linear": (True, False)}


def _inputs(N, H, Wp, K, C, wv, fold, seed):
    """x with zero pad columns, w [1, 1, K, C] at 0.1, scale 1 + 0.2 N,
    offset 0.2 N (so the ReLU cuts), dy zero on pad columns, ds1 and ds2
    at 1e-2 and 1e-3: numpy f32."""
    rng = np.random.RandomState(seed)
    cols = (np.arange(Wp) < wv).reshape(1, 1, Wp, 1)
    x = np.where(cols, rng.randn(N, H, Wp, K), 0.0).astype(np.float32)
    w = (rng.randn(1, 1, K, C) * 0.1).astype(np.float32)
    sc = (1.0 + 0.2 * rng.randn(1, K)).astype(np.float32) if fold else None
    of = (0.2 * rng.randn(1, K)).astype(np.float32) if fold else None
    dy = np.where(cols, rng.randn(N, H, Wp, C), 0.0).astype(np.float32)
    ds1 = (rng.randn(C) * 1e-2).astype(np.float32)
    ds2 = (rng.randn(C) * 1e-3).astype(np.float32)
    return x, w, sc, of, dy, ds1, ds2


def _ref(x, w, sc, of, dy, ds1, ds2, relu, wv, dt):
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    xj, wj, dyj = (jnp.asarray(a).astype(jdt) for a in (x, w, dy))
    if sc is None:
        fn = lambda a, b: ref.conv1x1_bn(a, b, relu=relu, wv=wv)  # noqa: E731
        args = (xj, wj)
    else:
        fn = lambda a, b, s, o: ref.conv1x1_bn(a, b, s, o, relu=relu, wv=wv)  # noqa: E731
        args = (xj, wj, jnp.asarray(sc), jnp.asarray(of))
    out, vjp = jax.vjp(fn, *args)
    grads = vjp((dyj, jnp.asarray(ds1), jnp.asarray(ds2)))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return [f32(o) for o in out], [f32(g) for g in grads]


def _port(x, w, sc, of, dy, ds1, ds2, relu, wv, dt):
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    xt, wt = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (x, w))
    leaves = [xt, wt]
    st = ot = None
    if sc is not None:
        st, ot = (torch.from_numpy(a).requires_grad_(True) for a in (sc, of))
        leaves += [st, ot]
    out = port.conv1x1_bn(xt, wt, st, ot, relu=relu, wv=wv)
    torch.autograd.backward(out, [torch.from_numpy(dy).to(tdt), torch.from_numpy(ds1),
                                  torch.from_numpy(ds2)])
    f32 = lambda t: t.detach().float().numpy()  # noqa: E731
    return [f32(o) for o in out], [f32(t.grad) for t in leaves]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv1x1_bn_matches_reference(shape, mode, dt):
    N, H, Wp, K, C, wv = shape
    fold, relu = MODES[mode]
    args = _inputs(N, H, Wp, K, C, wv, fold, seed=sum(shape))
    want_out, want_grads = _ref(*args, relu, wv, dt)
    got_out, got_grads = _port(*args, relu, wv, dt)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    names = ["y", "s1", "s2", "dx", "dw", "dscale", "doffset"]
    for name, got, want in zip(names, got_out + got_grads, want_out + want_grads):
        assert got.shape == want.shape, (name, got.shape, want.shape)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, f"{name}: {err:.3e} of max |reference| (tol {tol})"
    # pad columns of y and dx stay exact zeros
    assert np.all(got_out[0][:, :, wv:] == 0) and np.all(got_grads[0][:, :, wv:] == 0)


def test_supported_matches_reference():
    shapes = [((n, h, wp, k), (kh, kw, k2, c))
              for n in (1, 2) for h in (1, 7) for wp in (8, 12, 16, 56)
              for k in (32, 64, 96, 128) for c in (64, 100, 256)
              for kh, kw in ((1, 1), (3, 3)) for k2 in (k, 64)]
    shapes += [((2, 8, 8), (1, 1, 64, 64)), ((2, 8, 8, 64), (64, 64))]
    for xs, ws in shapes:
        assert port.supported(xs, ws) == ref.supported(xs, ws), (xs, ws)


def test_unsupported_shape_raises():
    x = torch.zeros(2, 4, 8, 48)
    with pytest.raises(ValueError, match="unsupported"):
        port.conv1x1_bn(x, torch.zeros(1, 1, 48, 64))


def test_kernel_wrappers_take_only_cuda_tensors():
    """The wrappers launch or raise: a CPU tensor never reaches a plain
    version through them (the autograd Function routes CPU tensors to the
    plain versions before any wrapper)."""
    x, w = torch.zeros(2, 4, 8, 64), torch.zeros(64, 128)
    sc = torch.ones(1, 64)
    with pytest.raises(ValueError, match="not a CUDA device"):
        port.fused_conv_bn_kernel(x, w, sc, sc.clone())
    dy = torch.zeros(2, 4, 8, 128)
    with pytest.raises(ValueError, match="not a CUDA device"):
        port.fused_conv_bn_bwd_kernel(dy, dy, x, w, None, None, torch.zeros(128),
                                      torch.zeros(128))
    assert port.fused_conv_bn_kernel.launches == 0
    assert port.fused_conv_bn_bwd_kernel.launches == 0


def test_geometry_covers_every_row():
    """The partial buffers' shapes: row tiles of 128 (bf16) or 64 (f32)
    rows, and dW splits of a multiple of 32 rows that cover M exactly
    once, at the main path's shapes and a small one."""
    for M, K, C in [(401408, 64, 256), (114688, 128, 512), (28672, 256, 1024),
                    (7168, 512, 2048), (401408, 256, 64), (64, 128, 64)]:
        for bf16 in (True, False):
            tiles, splits, rows = port._geometry(M, K, C, bf16)
            assert tiles == -(-M // (128 if bf16 else 64))
            assert rows % 32 == 0 and (splits - 1) * rows < M <= splits * rows
