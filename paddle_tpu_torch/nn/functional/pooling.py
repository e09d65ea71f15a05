"""2-D pooling (counterpart of paddle_tpu/nn/functional/pooling.py).

The reference lowers pooling to XLA's ReduceWindow, outside any Pallas
kernel; the port calls torch's pooling.  ``data_format="NHWC"`` pools a
channels-last view, as ``conv2d`` does.  ``max_pool2d`` pads with -inf
(padding that torch takes as it is when it is symmetric and at most half
the window; other padding is applied first); ``adaptive_avg_pool2d`` uses
the reference's bins, ``floor(i * n / out)`` to ``ceil((i + 1) * n /
out)``, which are torch's.  Not ported yet: ``return_mask`` and
``ceil_mode``, which raise NotImplementedError (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import torch.nn.functional as tF

from .conv import _pair, spatial_pads

__all__ = ["max_pool2d", "adaptive_avg_pool2d"]


def _not_ported(what):
    return NotImplementedError(f"max_pool2d({what}) is not ported yet (ROADMAP.md Queue 1 "
                               "item 6: the rest of the surface)")


def _channels_first(x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be NCHW or NHWC, got {data_format!r}")
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _back(out, data_format):
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False, ceil_mode=False,
               data_format="NCHW", name=None):
    """Max over windows of ``kernel_size`` (default stride: the window),
    padded with -inf."""
    if return_mask:
        raise _not_ported("return_mask=True")
    if ceil_mode:
        raise _not_ported("ceil_mode=True")
    ks = _pair(kernel_size)
    st = _pair(stride) if stride is not None else ks
    v = _channels_first(x, data_format)
    pads = spatial_pads(padding, v.shape[2:], ks, st)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ks)):
        sym = tuple(lo for lo, _ in pads)
    else:
        (h0, h1), (w0, w1) = pads
        v = tF.pad(v, (w0, w1, h0, h1), value=float("-inf"))
        sym = (0, 0)
    return _back(tF.max_pool2d(v, ks, st, sym), data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over the reference's adaptive bins, to ``output_size``."""
    return _back(tF.adaptive_avg_pool2d(_channels_first(x, data_format), _pair(output_size)),
                 data_format)
