"""RMSNorm (counterpart of paddle_tpu/nn/layer/norm.py RMSNorm)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional.norm import rms_norm


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
