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
import re

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


MAIN_SHAPES = [(401408, 64, 256), (114688, 128, 512), (28672, 256, 1024), (7168, 512, 2048),
               (401408, 256, 128), (401408, 256, 64), (401408, 64, 64), (28672, 1024, 256),
               (7168, 2048, 512)]


def test_geometry_covers_every_row():
    """The partial layout: each kernel's blocks own contiguous ranges of
    ``rows`` rows that cover M exactly once, in whole tiles (bf16: 128 rows
    for the forward and the dX pass, 64 for the one-pass backward and the
    dW splits; f32: one 64-row tile a block, dW splits of a multiple of 32
    rows, at least 256), and the bf16 grids fill the H100's 132 SMs in one
    wave at the ResNet step's shapes (conv3's K -> C and conv1's K > C),
    whose backward runs in one pass exactly where K * C <= 16384."""
    sms = port._SMS
    for M, K, C in MAIN_SHAPES + [(64, 128, 64), (384, 256, 128), (384, 128, 64)]:
        for bf16 in (True, False):
            plan = port._geometry(M, K, C, bf16)
            fwd, bwd, dw = plan.fwd_rows, plan.bwd_rows, plan.dw_rows
            for rows in (fwd, bwd, dw):
                blocks = port._blocks(M, rows)
                assert (blocks - 1) * rows < M <= blocks * rows
            if not bf16:
                assert fwd == bwd == 64 and dw % 32 == 0 and dw >= 256 and not plan.one_pass
                continue
            assert fwd % 128 == 0 and dw % 64 == 0
            assert bwd % (64 if plan.one_pass else 128) == 0 and (not plan.one_pass or dw == bwd)
            grids = [port._blocks(M, fwd) * -(-C // plan.bn)]
            if plan.one_pass:
                grids.append(port._blocks(M, bwd))
            else:
                grids.append(port._blocks(M, bwd) * -(-K // 256))
                grids.append(port._blocks(M, dw) * -(-K // 128) * -(-C // plan.bn))
            assert all(g <= sms for g in grids), (M, K, C, grids)
            if (M, K, C) in MAIN_SHAPES:
                assert all(g >= 0.8 * sms for g in grids), (M, K, C, grids)
                assert plan.one_pass == (K * C <= 16384), (M, K, C)


def _instantiated():
    """The bf16 kernels csrc/fused_conv_bn.cu instantiates: the (K, C) of
    its one-pass backward, and the column widths of its forward and of its
    dW pass."""
    src = (port._build.CSRC_DIR / "fused_conv_bn.cu").read_text()
    one = {(int(k), int(c)) for k, c in re.findall(r"\bONE\((\d+), (\d+)\)", src)}
    fwd = {int(n) for n in re.findall(r"\bFWD\((\d+), ", src)}
    dw = {int(n) for n in re.findall(r"launch\(fcbn_dw_bf16<(\d+)>", src)}
    return one, fwd, dw


def test_every_admitted_shape_has_a_kernel():
    """Every (K, C) that ``supported`` admits (multiples of 64, here up to
    512) gets a plan that the kernel source runs: the one-pass backward
    only for a (K, C) it instantiates (64 -> 192 and 192 -> 64, admitted
    but not instantiated, take the two passes), and column widths it
    instantiates.  Any two-pass shape runs: those kernels take any
    multiple of 64."""
    one, fwd, dw = _instantiated()
    assert one == set(port._ONE_PASS)
    assert fwd == dw == {64, 128, 256}
    for K in range(64, 513, 64):
        for C in range(64, 513, 64):
            assert port.supported((2, 4, 8, K), (1, 1, K, C))
            for M in (64, 7168, 401408):
                plan = port._geometry(M, K, C, True)
                assert plan.one_pass == ((K, C) in one), (K, C)
                assert plan.bn in fwd and plan.bn <= max(64, C), (K, C, plan.bn)
    for K, C in ((64, 192), (192, 64)):
        assert not port._geometry(401408, K, C, True).one_pass


# Shapes of the partial-layout model: W' = 24 does not divide the blocks'
# 64 or 128 rows, so ranges end inside a W' row; (128, 64) takes the
# one-pass backward, (256, 128) the two passes.
PARTIAL_SHAPES = {"one_pass": (2, 8, 24, 128, 64, 20), "two_pass": (2, 8, 24, 256, 128, 20)}


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["no_fold", "fold_relu"])
@pytest.mark.parametrize("case", list(PARTIAL_SHAPES))
def test_partials_model_matches_reference(case, mode, dt):
    """The plain model of the kernels' partials (``_fwd_partials_dense``,
    ``_bwd_partials_dense``) against the reference's Pallas kernels, with
    pad rows that hold non-zero x: one partial row for each block of the
    ranges ``_geometry`` assigns; their sums give s1, s2, dW and, with the
    fold, dscale and doffset; and the partials of the second block and of
    the last, whose ranges end inside a W' row, are the reference's on x
    zeroed outside the block's rows (s1 and s2 of the forward's blocks;
    without the fold dW of the dW splits; with it dscale of the backward's
    blocks, to which a zero x adds nothing)."""
    N, H, Wp, K, C, wv = PARTIAL_SHAPES[case]
    fold, relu = MODES[mode]
    x, w, sc, of, dy, ds1, ds2 = _inputs(N, H, Wp, K, C, wv, fold, seed=K + C)
    x = np.random.RandomState(K).randn(*x.shape).astype(np.float32)  # pad rows non-zero
    M = N * H * Wp
    plan = port._geometry(M, K, C, dt == "bf16")
    assert plan.one_pass == (dt == "bf16" and case == "one_pass")
    for rows in (plan.fwd_rows, plan.bwd_rows, plan.dw_rows):  # ranges ending inside W' rows
        assert port._blocks(M, rows) > 1 and rows % Wp
    args = (w, sc, of, dy, ds1, ds2, relu, wv, dt)
    want_out, want_grads = _ref(x, *args)
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    xt, wt, dyt = (torch.from_numpy(a).to(tdt) for a in (x, w.reshape(K, C), dy))
    st, ot = (None, None) if sc is None else (torch.from_numpy(sc), torch.from_numpy(of))
    y = (port._fwd_fold_dense(xt, wt, st, ot, relu, wv) if fold else port._fwd_plain(xt, wt))[0]
    s_part = port._fwd_partials_dense(y, K)
    dw_part, part = port._bwd_partials_dense(
        dyt, y, xt, wt, st, ot, torch.from_numpy(ds1), torch.from_numpy(ds2), relu, wv)
    assert s_part.shape == (2, port._blocks(M, plan.fwd_rows), C)
    assert dw_part.shape == (port._blocks(M, plan.dw_rows), K, C)
    assert (part is None) == (not fold)
    got = {"s1": s_part[0].sum(0), "s2": s_part[1].sum(0), "dw": dw_part.sum(0).reshape(1, 1, K, C)}
    want = {"s1": want_out[1], "s2": want_out[2], "dw": want_grads[1]}
    if fold:
        assert part.shape == (2, port._blocks(M, plan.bwd_rows), K)
        got.update(dscale=part[0].sum(0)[None], doffset=part[1].sum(0)[None])
        want.update(dscale=want_grads[2], doffset=want_grads[3])
    tol = F32_TOL if dt == "f32" else BF16_TOL
    errs = {name: _rel(g, want[name]) for name, g in got.items()}

    def on_rows(rows, b):  # the reference on x zeroed outside block b's rows
        lo = (b % port._blocks(M, rows)) * rows
        hi = min(M, lo + rows)
        xb = x.reshape(M, K).copy()
        xb[:lo], xb[hi:] = 0.0, 0.0
        return _ref(xb.reshape(x.shape), *args)

    for b in (1, -1):
        if not fold:
            out, _ = on_rows(plan.fwd_rows, b)
            errs[f"s1[{b}]"], errs[f"s2[{b}]"] = (_rel(s_part[i][b], out[1 + i]) for i in (0, 1))
            errs[f"dw[{b}]"] = _rel(dw_part[b].reshape(1, 1, K, C), on_rows(plan.dw_rows, b)[1][1])
        else:
            errs[f"dscale[{b}]"] = _rel(part[0][b][None], on_rows(plan.bwd_rows, b)[1][2])
    bad = {k: v for k, v in errs.items() if not v <= tol}
    assert not bad, f"of max |reference| (tol {tol}): {bad}"
