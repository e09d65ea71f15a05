"""Activations (counterpart of paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch.nn.functional as _F


def silu(x):
    """x * sigmoid(x)."""
    return _F.silu(x)
