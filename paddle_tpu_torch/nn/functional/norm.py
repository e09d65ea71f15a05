"""Normalization functionals (counterpart of paddle_tpu/nn/functional/norm.py).

``fused_dropout_add_layer_norm`` routes as the reference does, with CUDA in
its accelerator's place: the fused kernel (``ops/fused_ln.py``) for a CUDA
tensor whose rows it admits (``supported(n, h)``) when both weight and
bias are given, with a fresh seed pair per call at rate > 0; the composed
math everywhere else, CPU tensors included, as the reference does off its
accelerator.  The two round differently, as in the reference: the kernel
rounds s = residual + dropout(x) to the input dtype and applies weight and
bias in f32; the composed math takes the statistics on the f32 s and casts
the normalised value before the weight and bias.
"""
from __future__ import annotations

import torch

from ...ops import fused_ln as _fused
from ...ops._prng import draw_seed
from .common import _keep, _mask_mul


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


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dims, in the
    reference's numerics: shifted single-pass f32 statistics (sum and sum of
    squares of x minus the row's first element, which keeps them at the
    scale of the spread), normalise, cast to x's dtype, then times weight
    and plus bias."""
    ns = normalized_shape if isinstance(normalized_shape, (list, tuple)) else [normalized_shape]
    nd = len(ns)
    lead = x.shape[:x.dim() - nd]
    vf = x.float().reshape(*lead, -1)
    n = vf.shape[-1]
    d = vf - vf[..., :1]
    dmean = d.sum(-1, keepdim=True) / n
    var = torch.clamp((d * d).sum(-1, keepdim=True) / n - dmean * dmean, min=0.0)
    mean = vf[..., :1] + dmean
    out = ((vf - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def _use_fused_kernel(x, weight, bias, n, h):
    """The reference's routing: the kernel on the accelerator (here CUDA)
    for admitted rows, given both weight and bias."""
    return x.is_cuda and weight is not None and bias is not None and _fused.supported(n, h)


def fused_dropout_add_layer_norm(x, residual, weight, bias, p=0.0, epsilon=1e-5,
                                 training=True):
    """out = LayerNorm(residual + dropout(x)) over the last dim, the
    transformer encoder's glue."""
    rate = float(p) if training else 0.0
    eps = float(epsilon)
    h = x.shape[-1]
    n = x.numel() // max(h, 1)
    if _use_fused_kernel(x, weight, bias, n, h):
        # no dropout, no draw: the stream advances only when a mask is made
        seed = (draw_seed(x.device) if rate > 0.0
                else torch.zeros(2, dtype=torch.int32, device=x.device))
        return _fused.fused_dropout_add_layer_norm(x, residual, weight, bias, seed, rate, eps)
    xv = x
    if rate > 0.0:
        xv = _mask_mul(x, _keep(x.shape, rate, x.device), rate, True)
    s = residual.float() + xv.float()
    mean = s.mean(-1, keepdim=True)
    c = s - mean
    var = (c * c).mean(-1, keepdim=True)
    out = (c * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
