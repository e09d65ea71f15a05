"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as _F


def silu(x):
    """x * sigmoid(x)."""
    return _F.silu(x)


def gelu(x, approximate=False):
    """GELU: exact (erf) by default, the tanh form with ``approximate``."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x):
    return torch.tanh(x)


def relu(x):
    """max(x, 0)."""
    return torch.relu(x)
