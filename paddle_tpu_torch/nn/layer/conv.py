"""Conv2D (counterpart of paddle_tpu/nn/layer/conv.py)."""
from __future__ import annotations

import math

import torch
from torch import nn

from ..functional.conv import _pair, conv2d


class Conv2D(nn.Module):
    """2-D convolution with weight [Cout, Cin / groups, kh, kw] (the same
    layout in both packages, so ``convert`` carries it as it is), the
    reference's Kaiming-uniform init (limit sqrt(6 / fan_in)) and a
    uniform(±1 / sqrt(fan_in)) bias; ``bias_attr=False`` leaves the bias
    out.  ``data_format`` is "NCHW" or "NHWC"."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW", *, device=None, dtype=None):
        super().__init__()
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"Conv2D(padding_mode={padding_mode!r}) is not ported yet (ROADMAP.md "
                "Queue 1 item 6: the rest of the surface)")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _pair(kernel_size)
        self._stride, self._dilation = _pair(stride), _pair(dilation)
        self._padding, self._groups, self._data_format = padding, groups, data_format
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                               *self._kernel_size, **kw))
        self.bias = (nn.Parameter(torch.empty(out_channels, **kw)) if bias_attr is not False
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in = self._in_channels // self._groups * self._kernel_size[0] * self._kernel_size[1]
        limit = math.sqrt(2.0) * math.sqrt(3.0 / fan_in)
        with torch.no_grad():
            self.weight.uniform_(-limit, limit, generator=generator)
            if self.bias is not None:
                bound = 1.0 / math.sqrt(fan_in)
                self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self._stride, self._padding,
                      self._dilation, self._groups, self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size={self._kernel_size}, "
                f"stride={self._stride}, padding={self._padding}, "
                f"data_format={self._data_format}")
