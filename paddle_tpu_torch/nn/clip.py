"""Gradient clipping configurations (counterpart of the clip classes in
paddle_tpu/nn/__init__.py).

As in the reference, these are configuration objects only: an optimizer
built with ``grad_clip=`` applies them to its gradients before the update
(``Optimizer._clipped_grads``).
"""
from __future__ import annotations

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]


class ClipGradByGlobalNorm:
    """Scale every gradient by clip_norm / (global norm + 1e-6) when the
    global L2 norm over all of them exceeds ``clip_norm``."""

    def __init__(self, clip_norm=1.0, group_name="default", auto_skip_clip=False):
        self.clip_norm = clip_norm

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"


class ClipGradByNorm:
    """Scale each gradient on its own when its L2 norm exceeds
    ``clip_norm``."""

    def __init__(self, clip_norm=1.0):
        self.clip_norm = clip_norm


class ClipGradByValue:
    """Clamp each gradient element to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max
