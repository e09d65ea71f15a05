"""Dropout (counterpart of paddle_tpu/nn/functional/common.py ``dropout``).

The reference has no kernel here: its dropout is a JAX custom VJP whose only
residual is the random key, and whose backward regenerates the mask from it
(``_dropout_mask_mul``, common.py:41-62), so no mask is stored.  The port
draws the mask with torch ops from the device's seeded generator
(framework/random.py) and lets autograd keep it instead: a bool tensor of
the mask's shape, one byte an element (50 MB at the ERNIE embeddings,
[512, 128, 768]).  The two give different masks from the same seed; the
keep probability and the scaling are the reference's.
"""
from __future__ import annotations

import torch

from ...framework.random import get_generator

__all__ = ["dropout"]


def _keep(shape, rate, device):
    """Bernoulli(1 - rate) keep mask of ``shape`` from ``device``'s generator."""
    gen = get_generator(device)
    return torch.rand(shape, generator=gen, device=device) >= rate


def _mask_mul(v, keep, rate, upscale):
    """where(keep, v * scale, 0), the scale 1 / (1 - rate) (or 1) rounded to
    v's dtype first, as the reference does."""
    scale = 1.0 / (1.0 - rate) if upscale else 1.0
    return torch.where(keep, v * torch.tensor(scale, dtype=v.dtype), 0.0)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train"):
    """Paddle's dropout: in training each element (or, with ``axis``, each
    slice along the axes not named) is zeroed with probability ``p``, the
    rest scaled by 1 / (1 - p) (``mode="upscale_in_train"``) or left
    (``"downscale_in_infer"``, which scales by 1 - p at inference); p = 1
    gives zeros."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training and p > 0.0:
            return x * torch.tensor(1.0 - float(p), dtype=x.dtype)
        return x
    rate = float(p)
    if rate >= 1.0:  # drop everything (1/(1-rate) would divide by zero)
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    return _mask_mul(x, _keep(shape, rate, x.device), rate, mode == "upscale_in_train")
