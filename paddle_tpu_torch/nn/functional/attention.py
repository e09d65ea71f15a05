"""Attention functionals (counterpart of paddle_tpu/nn/functional/attention.py).

``scaled_dot_product_attention`` routes exactly as the reference does on its
accelerator, with CUDA in the accelerator's place: with ``backend="auto"``
and no mask, the short-sequence encoder kernel for self-attention at
S % 128 == 0, S <= 512, D in {64, 128}, with its in-kernel dropout at
``dropout_p`` when training (a fresh seed pair per call); flash attention
at S >= 1024 on tileable lengths, D in {64, 128, 256}, only without
dropout; the dense math (``_dense_sdpa``, whose dropout masks the
probabilities) everywhere else.  ``backend="flash"`` asks for flash on any
device where the lengths tile, as in the reference.  The gates are the reference's, measured
on its TPU; new ones wait for H100 ledger lines.  CPU tensors take the dense
path, as the reference does off its accelerator.  Every path is
differentiable: the encoder and flash kernels are ``torch.autograd.Function``s
whose backward launches their backward kernels (the dense math is plain
autograd), so training takes the same routing as inference.
"""
from __future__ import annotations

import warnings

import torch

from ...ops._prng import draw_seed
from ...ops.encoder_attention import encoder_attention
from ...ops.encoder_attention import supported as _encoder_supported
from ...ops.flash_attention import flash_attention, supports_seq
from .common import _keep, _mask_mul


def _dense_sdpa(q, k, v, mask, is_causal, scale, rate=0.0):
    """q/k/v [B, S, H, D] (paddle layout) -> [B, S, H, D].  Bottom-right
    causal alignment (query i sees keys <= i + Sk - Sq); f32 softmax, the
    probabilities in q's dtype, then dropout of them at ``rate``."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", qT, kT) * s
    neg = torch.finfo(logits.dtype).min
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=logits.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~causal, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, neg)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if rate > 0.0:
        probs = _mask_mul(probs, _keep(probs.shape, rate, probs.device), rate, True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vT)
    return out.transpose(1, 2)


def _reference_kernel(q, k, attn_mask, is_causal, backend, dropout=False):
    """Name of the kernel the reference picks for these shapes on its
    accelerator (its encoder and flash admission rules; flash has no
    dropout), or None for the dense math."""
    if attn_mask is not None or backend not in ("auto", "flash"):
        return None
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    if backend == "auto" and _encoder_supported(q.shape[0] * q.shape[2], S, D, Sk):
        return "encoder_attention"
    if dropout:
        return None
    tiles = supports_seq(S) and supports_seq(Sk)
    causal_ok = not is_causal or S <= Sk
    if backend == "flash" and tiles and causal_ok:
        return "flash_attention"
    if S >= 1024 and tiles and causal_ok and D in (64, 128, 256):
        return "flash_attention"
    return None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, backend="auto"):
    """query/key/value: [batch, seq, num_heads, head_dim] (paddle layout).
    ``backend="math"`` is the dense path on any device; ``"auto"`` launches
    the encoder or flash kernel on CUDA where the reference would run its
    Pallas kernel; ``"flash"`` takes flash on any device (CPU tensors then
    run its plain version)."""
    rate = float(dropout_p) if (dropout_p and training) else 0.0
    if backend == "flash" and rate > 0.0:
        warnings.warn(
            "backend='flash' with active attention dropout falls back to the "
            "dense SDPA path (the flash kernel has no dropout); full "
            "[B,H,S,S] attention probs will be materialized")
    kern = _reference_kernel(query, key, attn_mask, is_causal, backend, rate > 0.0)
    if kern == "encoder_attention" and query.is_cuda:
        seed = draw_seed(query.device) if rate > 0.0 else None
        return encoder_attention(query, key, value, seed=seed, scale=scale,
                                 dropout_rate=rate, causal=is_causal)
    if kern == "flash_attention" and (query.is_cuda or backend == "flash"):
        return flash_attention(query, key, value, causal=is_causal, scale=scale)
    return _dense_sdpa(query, key, value, attn_mask, is_causal, scale, rate)
