"""2-D convolution (counterpart of paddle_tpu/nn/functional/conv.py).

The reference leaves convolutions to XLA, outside any Pallas kernel, so the
port hands them to ``torch.nn.functional.conv2d`` (cuDNN on the card), as
it hands a plain matrix product to ``torch.matmul``.  The weight is
``[Cout, Cin / groups, kh, kw]`` in both packages.  ``data_format="NHWC"``
passes ``x.permute(0, 3, 1, 2)``, a channels-last view that cuDNN takes
as it is, and permutes the result back: no full activation is copied to
change its layout.  Padding takes the reference's forms: an int, one per
spatial dim, a (before, after) pair per dim, ``[[0, 0], [0, 0], [h0, h1],
[w0, w1]]`` (which the reference's 2-D conv means but raises TypeError on:
it reads four entries as the flat form first), or "SAME"/"VALID" (XLA's
meaning: SAME pads the excess of the strided window over the input, the
smaller half first).  A float32
convolution on the card runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; the reference's tests compare
in full float32, so the port's tests and ``chip_smoke.py`` turn it off.
"""
from __future__ import annotations

import torch.nn.functional as tF

__all__ = ["conv2d"]


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _conv_padding(padding, nd):
    """The reference's padding forms -> a string or [(lo, hi)] per dim."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * nd
    padding = list(padding)
    if len(padding) == nd + 2 and isinstance(padding[0], (list, tuple)):
        return [(int(p[0]), int(p[1])) for p in padding[2:]]
    if len(padding) == nd:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * nd:
        return [(int(padding[2 * i]), int(padding[2 * i + 1])) for i in range(nd)]
    raise ValueError(f"bad padding {padding}")


def _same_pads(sizes, ksize, strides, dilations):
    """XLA's SAME padding: the window's excess over the input, split with
    the smaller half before."""
    pads = []
    for n, k, s, d in zip(sizes, ksize, strides, dilations):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def spatial_pads(padding, sizes, ksize, strides, dilations=(1, 1)):
    """[(lo, hi)] per spatial dim for any of the reference's padding forms
    (shared with pooling)."""
    pad = _conv_padding(padding, len(sizes))
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad == "SAME":
        return _same_pads(sizes, ksize, strides, dilations)
    if isinstance(pad, str):
        raise ValueError(f"bad padding {padding}")
    return pad


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution of x ([N, C, H, W], or [N, H, W, C] with
    ``data_format="NHWC"``) with weight [Cout, Cin / groups, kh, kw]; the
    weight and bias take x's dtype, as in the reference."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"conv2d: data_format must be NCHW or NHWC, got {data_format!r}")
    nhwc = data_format == "NHWC"
    v = x.permute(0, 3, 1, 2) if nhwc else x
    w = weight if weight.dtype == v.dtype else weight.to(v.dtype)
    b = None if bias is None else bias.to(v.dtype)
    strides, dilations = _pair(stride), _pair(dilation)
    pads = spatial_pads(padding, v.shape[2:], w.shape[2:], strides, dilations)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        (h0, h1), (w0, w1) = pads
        v = tF.pad(v, (w0, w1, h0, h1))
        sym = (0, 0)
    out = tF.conv2d(v, w, b, strides, sym, dilations, groups)
    return out.permute(0, 2, 3, 1) if nhwc else out
