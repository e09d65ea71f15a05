"""Fused 1x1 convolution + BatchNorm statistics, forward and backward
(counterpart of paddle_tpu/ops/fused_conv_bn.py), the ResNet bottleneck's
fast path in NHWC training.

``conv1x1_bn(x, w, scale=None, offset=None, relu=True, wv=None)`` returns
(y, s1, s2): y = conv1x1(act(x * scale + offset)) with the columns w >= wv
of the W'-padded input masked to zero, and the f32 per-channel sum and sum
of squares of the rounded y.  x is NHWC [N, H, W', K] (W' % 8 == 0), w is
[1, 1, K, C], scale and offset f32 [1, K] (None: the input is already
normalised, no fold).  The numerics are the reference kernel's: the fold in
f32, rounded to x's dtype before an f32-accumulated product that is
rounded to x's dtype; the statistics over the rounded y.  It is a
``torch.autograd.Function`` that saves (x, w, scale, offset, y) as the
reference's custom VJP does; its backward forms dy_tot = dy + (bf(ds1) + y
* bf(2 ds2)) in the activation dtype, zero on pad rows, then dX, dW (f32,
returned in w's dtype) and, with the fold, the ReLU mask, dscale and
doffset.  A ``None`` cotangent of s1 or s2 counts as zeros.

Routing.  A CPU tensor takes the plain versions (``_fwd_fold_dense``,
``_bwd_dense``), which are also the kernels' oracle.  A CUDA tensor
launches ``csrc/fused_conv_bn.cu`` (``fused_conv_bn_fwd`` with the fold;
``fused_conv_bn_bwd`` with or without it) or raises: there is no fallback.
The forward without the fold has no TPU kernel in the reference (XLA's
product and sums); here it is ``torch.matmul`` and torch sums on any
device.  ``supported`` is the reference's admission and decides the
model's routing before any launch.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

__all__ = ["conv1x1_bn", "supported", "fused_conv_bn_kernel", "fused_conv_bn_bwd_kernel"]

_SMS = 132  # SMs of an H100 SXM: the bf16 grids aim at one block on each


def supported(x_shape, w_shape):
    """Fast-path admission: 4-D NHWC, 1x1 kernel, channels multiples of 64,
    W a multiple of 8 (the caller pads)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    N, H, Wp, K = x_shape
    kh, kw, K2, Cout = w_shape
    return (kh == 1 and kw == 1 and K2 == K and Wp % 8 == 0
            and K % 64 == 0 and Cout % 64 == 0 and N >= 1)


def _row_live(M, Wp, wv, device):
    """[M, 1] bool: the flattened row's column w = m % W' is below wv."""
    return (torch.arange(M, device=device) % Wp < wv)[:, None]


def _fold(x2, scale, offset, relu, Wp, wv):
    """(a, xf): a = x * scale + offset in f32 (unmasked), xf = act(a) with
    pad rows zeroed, rounded to x's dtype."""
    a = x2.float() * scale.reshape(-1) + offset.reshape(-1)
    xf = torch.relu(a) if relu else a
    if Wp != wv:
        xf = torch.where(_row_live(x2.shape[0], Wp, wv, x2.device), xf, 0.0)
    return a, xf.to(x2.dtype)


def _sums(y2):
    yf = y2.float()
    return yf.sum(0), (yf * yf).sum(0)


def _fwd_fold_dense(x, w2, scale, offset, relu, wv):
    """The plain forward with the fold on x [N, H, W', K] and w2 [K, C]:
    (y, s1, s2), the product in f32 on the rounded folded input."""
    N, H, Wp, K = x.shape
    _, xf = _fold(x.reshape(-1, K), scale, offset, relu, Wp, wv)
    y2 = (xf.float() @ w2.float()).to(x.dtype)
    return (y2.reshape(N, H, Wp, -1), *_sums(y2))


def _fwd_plain(x, w2):
    """The forward without the fold, on any device: an f32-accumulated
    product rounded to x's dtype, then the sums of the rounded y (the
    reference's XLA path, which has no kernel)."""
    N, H, Wp, K = x.shape
    y2 = torch.matmul(x.reshape(-1, K), w2.to(x.dtype))
    return (y2.reshape(N, H, Wp, -1), *_sums(y2))


def _dyt(dy2, y2, ds1, ds2, Wp, wv):
    """dy + (bf(ds1) + y * bf(2 ds2)) in the activation dtype, each
    operation rounded to it, zero on pad rows."""
    dt = dy2.dtype
    dyt = dy2 + (ds1.to(dt) + y2 * (2.0 * ds2).to(dt))
    if Wp != wv:
        dyt = torch.where(_row_live(dy2.shape[0], Wp, wv, dy2.device), dyt,
                          torch.zeros((), dtype=dt, device=dy2.device))
    return dyt


def _bwd_dense(dy, y, x, w2, scale, offset, ds1, ds2, relu, wv):
    """The plain backward: (dx [N, H, W', K] in x's dtype, dw [K, C] f32,
    dscale and doffset f32 [1, K] or None without the fold)."""
    N, H, Wp, K = x.shape
    C = w2.shape[1]
    x2 = x.reshape(-1, K)
    dyt = _dyt(dy.reshape(-1, C), y.reshape(-1, C), ds1.float(), ds2.float(), Wp, wv).float()
    if scale is not None:
        a, xf = _fold(x2, scale, offset, relu, Wp, wv)
    else:
        xf = x2
    dw = xf.float().T @ dyt
    dxf = dyt @ w2.float().T
    if scale is None:
        return dxf.to(x.dtype).reshape(x.shape), dw, None, None
    g = torch.where(a > 0.0, dxf, 0.0) if relu else dxf
    dx = (g * scale.reshape(-1)).to(x.dtype).reshape(x.shape)
    return dx, dw, (g * x2.float()).sum(0)[None], g.sum(0)[None]


# (K, C) of the bf16 backward's one-pass kernels, fcbn_bwd1_bf16<K, C> of
# csrc/fused_conv_bn.cu: each holds its block's f32 dW in registers.  Every
# other shape takes the two passes.
_ONE_PASS = ((64, 64), (64, 128), (64, 256), (128, 64), (128, 128), (256, 64))


class _Plan(NamedTuple):
    """The kernels' plan for one shape, which the entries run or refuse:
    the rows a block owns in the forward, the backward (its dX pass) and
    the dW splits; the bf16 backward in one pass or two; and the bf16
    tiles' column width (the forward's and the dW pass's)."""
    fwd_rows: int
    bwd_rows: int
    dw_rows: int
    one_pass: bool
    bn: int


def _geometry(M, K, C, bf16):
    """The ``_Plan`` of csrc/fused_conv_bn.cu for [M, K] -> C: the kernels'
    blocks each own a contiguous range of that many rows (the last range
    shorter) and write one partial row over it, which the wrapper sums in
    block order.

    bf16: the forward's persistent blocks walk tiles of 128 rows, about one
    block an SM across the C / bn column slices; the backward runs one pass
    (tiles of 64 rows, one block an SM) for the (K, C) in ``_ONE_PASS``,
    else a dX pass (tiles of 128 rows, about one block an SM across its
    slices of at most 256 of K) and a dW pass whose M splits (of 64-row
    units) fill the SMs with 128 x bn dW tiles.  f32: blocks of one 64-row
    tile, and dW splits of a multiple of 32 rows (at least 256), about four
    dW blocks of 64 x 64 an SM."""
    if not bf16:
        want = max(1, -(-4 * _SMS // (-(-K // 64) * -(-C // 64))))
        per = -(-M // want)
        return _Plan(64, 64, max(256, -(-per // 32) * 32), False, 64)

    def per_block(tile, blocks):
        tiles = -(-M // tile)
        return -(-tiles // max(1, blocks)) * tile

    bn = 256 if C >= 256 else 128 if C > 64 else 64
    fwd_rows = per_block(128, _SMS // -(-C // bn))
    if (K, C) in _ONE_PASS:
        rows = per_block(64, _SMS)
        return _Plan(fwd_rows, rows, rows, True, bn)
    bwd_rows = per_block(128, _SMS // -(-K // 256))
    dw_tiles = -(-K // 128) * -(-C // bn)
    return _Plan(fwd_rows, bwd_rows, per_block(64, _SMS // dw_tiles), False, bn)


def _blocks(M, rows):
    """The partial rows of blocks of ``rows`` rows: ceil(M / rows)."""
    return -(-M // rows)


def _ranges(M, rows):
    """The row ranges [b, e) of blocks of ``rows`` rows, in block order."""
    return [(b, min(M, b + rows)) for b in range(0, M, rows)]


def _fwd_partials_dense(y, K):
    """The plain model of the forward kernel's partials: f32 [2, blocks, C],
    the column sums and sums of squares of y [N, H, W', C] (the kernel's own
    y) over each forward block's rows (used by the tests and chip_smoke.py
    only)."""
    C = y.shape[-1]
    yf = y.reshape(-1, C).float()
    rows = _geometry(yf.shape[0], K, C, y.dtype == torch.bfloat16).fwd_rows
    blocks = [yf[b:e] for b, e in _ranges(yf.shape[0], rows)]
    return torch.stack([torch.stack([v.sum(0) for v in blocks]),
                        torch.stack([(v * v).sum(0) for v in blocks])])


def _bwd_partials_dense(dy, y, x, w2, scale, offset, ds1, ds2, relu, wv):
    """The plain model of the backward kernel's partials (used by the tests
    and chip_smoke.py only): (dw_part f32 [splits, K, C], one dW over each
    dW split's rows; part f32 [2, blocks, K], dscale and doffset over each
    dX block's rows, or None without the fold), as ``_geometry`` assigns
    the rows.  Their sums over the blocks are ``_bwd_dense``'s dw, dscale
    and doffset."""
    N, H, Wp, K = x.shape
    C = w2.shape[1]
    M = N * H * Wp
    plan = _geometry(M, K, C, x.dtype == torch.bfloat16)
    x2 = x.reshape(-1, K)
    dyt = _dyt(dy.reshape(-1, C), y.reshape(-1, C), ds1.float(), ds2.float(), Wp, wv).float()
    if scale is not None:
        a, xf = _fold(x2, scale, offset, relu, Wp, wv)
    else:
        xf = x2
    xf = xf.float()
    dw = torch.stack([xf[b:e].T @ dyt[b:e] for b, e in _ranges(M, plan.dw_rows)])
    if scale is None:
        return dw, None
    dxf = dyt @ w2.float().T
    g = torch.where(a > 0.0, dxf, 0.0) if relu else dxf
    gx = g * x2.float()
    ranges = _ranges(M, plan.bwd_rows)
    return dw, torch.stack([torch.stack([gx[b:e].sum(0) for b, e in ranges]),
                            torch.stack([g[b:e].sum(0) for b, e in ranges])])


def _check(cond, msg):
    if not cond:
        raise ValueError(f"fused_conv_bn kernel: {msg}")


def _kernel_inputs(x, w2, scale, offset, wv):
    """The kernels' admission: CUDA, x [N, H, W', K] and w2 [K, C] of one
    dtype (bf16 or f32), ``supported`` shapes, 0 < wv <= W', scale and
    offset f32 [1, K] or both None.  Returns the contiguous operands and
    the shape numbers."""
    dev = x.device
    _check(dev.type == "cuda", f"input is on {dev}, not a CUDA device")
    _check(x.dtype in (torch.bfloat16, torch.float32),
           f"dtype {x.dtype}, need bfloat16 or float32")
    _check(x.dim() == 4 and w2.dim() == 2, f"x {tuple(x.shape)} and w {tuple(w2.shape)}: need "
           "[N, H, W', K] and [K, C]")
    N, H, Wp, K = x.shape
    C = w2.shape[1]
    _check(supported(x.shape, (1, 1, *w2.shape)), f"unsupported shapes {tuple(x.shape)} "
           f"{tuple(w2.shape)} (K and C multiples of 64, W' of 8)")
    _check(w2.device == dev and w2.dtype == x.dtype, f"w: {w2.device} {w2.dtype}, need {dev} "
           f"{x.dtype}")
    _check(0 < wv <= Wp, f"wv={wv} outside (0, {Wp}]")
    _check((scale is None) == (offset is None), "scale and offset go together")
    aff = []
    for name, t in (("scale", scale), ("offset", offset)):
        if t is not None:
            _check(t.device == dev and t.numel() == K, f"{name} must hold {K} values on {dev}")
            aff.append(t.detach().float().reshape(K).contiguous())
    return x.contiguous(), w2.contiguous(), aff, (N * H * Wp, K, C, Wp)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


_FWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _fwd_launch(x, w2, scale, offset, relu, wv):
    """One launch of ``fused_conv_bn_fwd``: (y, part f32 [2, blocks, C], the
    column sums and sums of squares of y over each block's rows)."""
    _check(scale is not None, "the forward kernel takes the fold (scale and offset)")
    x, w2, (sc, of), (M, K, C, Wp) = _kernel_inputs(x, w2, scale, offset, wv)
    bf16 = x.dtype == torch.bfloat16
    plan = _geometry(M, K, C, bf16)
    y = torch.empty(*x.shape[:3], C, dtype=x.dtype, device=x.device)
    part = torch.empty(2, _blocks(M, plan.fwd_rows), C, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch("fused_conv_bn", _FWD_ARGS, x.data_ptr(), w2.data_ptr(), sc.data_ptr(),
                      of.data_ptr(), y.data_ptr(), part.data_ptr(), M, K, C, Wp, wv,
                      int(bool(relu)), int(bf16), plan.fwd_rows, plan.bn, _stream(x.device),
                      entry="fused_conv_bn_fwd")
    _build.count(fused_conv_bn_kernel)
    return y, part


def fused_conv_bn_kernel(x, w2, scale, offset, relu=True, wv=None):
    """Launch ``fused_conv_bn_fwd`` of ``csrc/fused_conv_bn.cu`` on CUDA
    tensors: x [N, H, W', K], w2 [K, C], scale and offset f32 (K values).
    Returns (y [N, H, W', C] in x's dtype, s1, s2 f32 [C]).  Raises
    ValueError on anything else.  Every launch adds one to
    ``fused_conv_bn_kernel.launches``."""
    y, part = _fwd_launch(x, w2, scale, offset, relu, x.shape[2] if wv is None else int(wv))
    s = part.sum(1)
    return y, s[0], s[1]


fused_conv_bn_kernel.launches = 0

_BWD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def _bwd_launch(dy, y, x, w2, scale, offset, ds1, ds2, relu, wv):
    """One launch of ``fused_conv_bn_bwd``: (dx, dw_part f32 [splits, K, C],
    part f32 [2, blocks, K] of dscale and doffset or None without the
    fold), the partials over the row ranges ``_geometry`` assigns."""
    x, w2, aff, (M, K, C, Wp) = _kernel_inputs(x, w2, scale, offset, wv)
    dev = x.device
    for name, t in (("dy", dy), ("y", y)):
        _check(t.device == dev and t.dtype == x.dtype and tuple(t.shape) == (*x.shape[:3], C),
               f"{name}: {t.device} {t.dtype} {tuple(t.shape)}, need {dev} {x.dtype} "
               f"{(*x.shape[:3], C)}")
    dy, y = dy.contiguous(), y.contiguous()
    ds = torch.stack([ds1.detach().float().reshape(C), ds2.detach().float().reshape(C)]).to(dev)
    bf16 = x.dtype == torch.bfloat16
    plan = _geometry(M, K, C, bf16)
    dx = torch.empty_like(x)
    part = torch.empty(2, _blocks(M, plan.bwd_rows), K, dtype=torch.float32, device=dev)
    dwp = torch.empty(_blocks(M, plan.dw_rows), K, C, dtype=torch.float32, device=dev)
    # the two-pass bf16 backward hands dyt from its dX pass to its dW pass
    dyt = (torch.empty(M, C, dtype=x.dtype, device=dev) if bf16 and not plan.one_pass
           else None)
    sc, of = aff if aff else (None, None)
    with torch.cuda.device(dev):
        _build.launch("fused_conv_bn", _BWD_ARGS, dy.data_ptr(), y.data_ptr(), x.data_ptr(),
                      w2.data_ptr(), None if sc is None else sc.data_ptr(),
                      None if of is None else of.data_ptr(), ds.data_ptr(), dx.data_ptr(),
                      part.data_ptr(), dwp.data_ptr(), None if dyt is None else dyt.data_ptr(),
                      M, K, C, Wp, wv, int(bool(relu)), int(bf16), plan.bwd_rows, plan.dw_rows,
                      int(plan.one_pass), plan.bn, _stream(dev), entry="fused_conv_bn_bwd")
    _build.count(fused_conv_bn_bwd_kernel)
    return dx, dwp, None if sc is None else part


def fused_conv_bn_bwd_kernel(dy, y, x, w2, scale, offset, ds1, ds2, relu=True, wv=None):
    """Launch ``fused_conv_bn_bwd`` of ``csrc/fused_conv_bn.cu`` on CUDA
    tensors: dy and y [N, H, W', C], x [N, H, W', K], w2 [K, C], scale and
    offset f32 (K values) or both None (no fold), ds1 and ds2 (C values).
    Returns (dx in x's dtype, dw f32 [K, C], dscale and doffset f32 [1, K]
    or None without the fold).  Every launch adds one to
    ``fused_conv_bn_bwd_kernel.launches``."""
    wv = x.shape[2] if wv is None else int(wv)
    dx, dwp, part = _bwd_launch(dy, y, x, w2, scale, offset, ds1, ds2, relu, wv)
    if part is None:
        return dx, dwp.sum(0), None, None
    s = part.sum(1)
    return dx, dwp.sum(0), s[0][None], s[1][None]


fused_conv_bn_bwd_kernel.launches = 0


class _Conv1x1BN(torch.autograd.Function):
    """Saves (x, w, scale, offset, y), as the reference's custom VJP."""

    @staticmethod
    def forward(ctx, x, w, scale, offset, relu, wv):
        K, C = w.shape[2], w.shape[3]
        w2 = w.reshape(K, C)
        if scale is None:
            y, s1, s2 = _fwd_plain(x, w2)
        elif x.device.type == "cpu":
            y, s1, s2 = _fwd_fold_dense(x, w2, scale, offset, relu, wv)
        else:
            y, s1, s2 = fused_conv_bn_kernel(x, w2, scale, offset, relu, wv)
        ctx.save_for_backward(x, w, scale, offset, y)
        ctx.relu, ctx.wv = relu, wv
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, scale, offset, y = ctx.saved_tensors
        K, C = w.shape[2], w.shape[3]
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        zeros = torch.zeros(C, dtype=torch.float32, device=y.device)
        ds1 = zeros if ds1 is None else ds1
        ds2 = zeros if ds2 is None else ds2
        args = (dy, y, x, w.reshape(K, C), scale, offset, ds1, ds2, ctx.relu, ctx.wv)
        if x.device.type == "cpu":
            dx, dw, dsc, dof = _bwd_dense(*args)
        else:
            dx, dw, dsc, dof = fused_conv_bn_bwd_kernel(*args)
        if dsc is not None:
            dsc, dof = dsc.reshape(scale.shape), dof.reshape(offset.shape)
        return dx, dw.to(w.dtype).reshape(w.shape), dsc, dof, None, None


def conv1x1_bn(x, w, scale=None, offset=None, relu=True, wv=None):
    """y = conv1x1(act(x * scale + offset)), plus per-channel (sum, sumsq)
    of y.

    x: [N, H, W', Cin] (W' % 8 == 0; columns >= wv hold zeros).  w: [1, 1,
    Cin, Cout].  scale/offset: f32 [1, Cin] fold of the previous BatchNorm
    (None = input already normalised; no fold).  Returns (y, s1, s2); s1/s2
    are f32 [Cout] sums over valid columns.  Raises ValueError on shapes
    ``supported`` rejects."""
    wv = wv or x.shape[2]
    if not supported(x.shape, w.shape):
        raise ValueError(f"conv1x1_bn: unsupported shapes {tuple(x.shape)} {tuple(w.shape)}")
    return _Conv1x1BN.apply(x, w, scale, offset, bool(relu), int(wv))
