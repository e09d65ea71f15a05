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
from ...optimizer.optimizer import _like
from ...ops._prng import draw_seed
from .common import _keep, _mask_mul


@torch.no_grad()
def update_running(running_mean, running_var, mean, var, n, momentum):
    """The reference's running-statistics update, in place:
    ``running = momentum * running + (1 - momentum) * stat`` with the
    variance debiased by n / (n - 1); ``mean`` and ``var`` are the f32
    batch statistics.  On bf16 buffers ``momentum * running`` rounds
    momentum to bf16 (0.8984375 for 0.9: ``_like``, as JAX rounds a weakly
    typed scalar) and stays bf16, and the sum is taken in f32 and rounded
    back, as JAX promotes it."""
    factor = n / max(n - 1, 1)
    running_mean.copy_(_like(momentum, running_mean) * running_mean
                       + (1 - momentum) * mean.detach())
    running_var.copy_(_like(momentum, running_var) * running_var
                      + (1 - momentum) * (var.detach() * factor))


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None,
               name=None):
    """BatchNorm over every axis but the channel one (axis 1 for "NC..."
    formats, the last otherwise).  In training (unless
    ``use_global_stats``) it normalises with the batch statistics and
    updates ``running_mean`` and ``running_var`` in place; otherwise it
    normalises with them."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != ch)
    use_batch_stats = training and not use_global_stats
    if use_batch_stats:
        vf = x.float()
        n = 1
        for i in axes:
            n *= x.shape[i]
        m = vf.sum(axes) / n
        var = torch.clamp((vf * vf).sum(axes) / n - m * m, min=0.0)
    else:
        m, var = running_mean, running_var
    scale = torch.rsqrt(var.float() + epsilon)
    if weight is not None:
        scale = scale * weight.float()
    offset = -m.float() * scale
    if bias is not None:
        offset = offset + bias.float()
    shape = [1] * x.dim()
    shape[ch] = x.shape[ch]
    out = x * scale.reshape(shape).to(x.dtype) + offset.reshape(shape).to(x.dtype)
    if use_batch_stats and running_mean is not None:
        update_running(running_mean, running_var, m, var, n, momentum)
    return out


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
