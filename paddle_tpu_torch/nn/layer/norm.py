"""RMSNorm and LayerNorm (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import layer_norm, rms_norm


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
