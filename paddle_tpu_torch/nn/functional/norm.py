"""Normalization functionals (counterpart of paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

import torch


def rms_norm(x, weight=None, epsilon=1e-6):
    """LLaMA RMSNorm.  As in the reference: the statistic and the scaling
    run in f32, the result is cast back to x's dtype, and only THEN is it
    multiplied by the weight (in the weight/input dtype)."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight
    return out
