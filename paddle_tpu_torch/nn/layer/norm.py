"""RMSNorm, LayerNorm and BatchNorm2D (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import batch_norm, layer_norm, rms_norm


class RMSNorm(nn.Module):
    """LLaMA-family RMSNorm with a ones-initialized weight."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size, device=device,
                                              dtype=dtype))
        self._epsilon = epsilon

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        return rms_norm(x, self.weight, self._epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims: weight ones,
    bias zeros; ``weight_attr=False`` / ``bias_attr=False`` leave either out."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None, *,
                 device=None, dtype=None):
        super().__init__()
        ns = normalized_shape if isinstance(normalized_shape, (list, tuple)) else [normalized_shape]
        self._normalized_shape = list(ns)
        self._epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = (nn.Parameter(torch.ones(ns, **kw)) if weight_attr is not False
                       else None)
        self.bias = nn.Parameter(torch.zeros(ns, **kw)) if bias_attr is not False else None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}, epsilon={self._epsilon}"


class BatchNorm2D(nn.Module):
    """BatchNorm over [N, C, H, W] (or [N, H, W, C] with
    ``data_format="NHWC"``): weight ones, bias zeros
    (``weight_attr=False`` / ``bias_attr=False`` leave either out), and
    the running statistics as f32 buffers named as the reference names
    them, ``_mean`` (zeros) and ``_variance`` (ones).  ``momentum`` is
    Paddle's: the share of the old running value kept at each update."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None, *,
                 device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = (nn.Parameter(torch.ones(num_features, **kw)) if weight_attr is not False
                       else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **kw)) if bias_attr is not False
                     else None)
        self.register_buffer("_mean", torch.zeros(num_features, device=device))
        self.register_buffer("_variance", torch.ones(num_features, device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                          training=self.training, momentum=self._momentum,
                          epsilon=self._epsilon, data_format=self._data_format,
                          use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}, data_format={self._data_format}")
