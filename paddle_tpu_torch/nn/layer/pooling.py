"""MaxPool2D and AdaptiveAvgPool2D (counterpart of paddle_tpu/nn/layer/pooling.py)."""
from __future__ import annotations

from torch import nn

from ..functional.pooling import adaptive_avg_pool2d, max_pool2d


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding, return_mask, ceil_mode, data_format)

    def forward(self, x):
        return max_pool2d(x, *self.args)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format

    def forward(self, x):
        return adaptive_avg_pool2d(x, self.output_size, self.data_format)
