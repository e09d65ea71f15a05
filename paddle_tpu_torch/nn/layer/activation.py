"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py)."""
from __future__ import annotations

from torch import nn

from ..functional.activation import relu


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return relu(x)
