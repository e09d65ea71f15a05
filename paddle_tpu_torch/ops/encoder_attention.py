"""Fused short-sequence self-attention, forward at dropout rate 0
(counterpart of paddle_tpu/ops/encoder_attention.py).

``encoder_attention(q, k, v, seed, scale, dropout_rate, causal)`` takes
q/k/v [B, S, H, D] (paddle layout) and returns softmax(scale * q k^T) v
[B, S, H, D], each row's softmax taken whole (max and sum first, then the
normalised probabilities rounded to v's dtype before P.V), optionally
causal.  ``supported`` keeps the reference's admission: self-attention
only (Sq == Sk), S % 128 == 0, S <= 512, D in {64, 128}; the reference's
heads-per-step choice (``pick_g``, a VMEM budget) is TPU tiling, and no
admitted shape ever failed it.

A CPU tensor takes the plain version ``_encoder_dense``; a CUDA tensor
launches ``csrc/encoder_attention.cu`` (bf16) or raises.  Not ported yet,
and raising NotImplementedError: dropout (the reference draws its mask from
an in-kernel PRNG; ROADMAP.md Queue 2 item 4, with the encoder slice,
Queue 1 item 4) and the backward (``_bwd_kernel``, the same slice).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

__all__ = ["encoder_attention", "encoder_attention_kernel", "supported"]


def supported(bh, s, d, seq_kv=None):
    """The reference's admission (``bh``, the batch times heads, is kept
    for its signature; every count is admitted)."""
    if seq_kv is not None and seq_kv != s:
        return False  # self-attention only
    return s % 128 == 0 and s <= 512 and d in (64, 128)


def _encoder_dense(q, k, v, scale, causal):
    """Plain version: scores in f32, the causal mask added as -1e30 (as the
    reference does), whole-row softmax, p rounded to v's dtype before
    P.V.  Returns [B, S, H, D] in q's dtype."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s + torch.where(pos[:, None] >= pos[None, :], 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _check(cond, msg):
    if not cond:
        raise ValueError(f"encoder attention kernel: {msg}")


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def encoder_attention_kernel(q, k, v, scale=None, causal=False):
    """Launch ``csrc/encoder_attention.cu`` on CUDA tensors: q/k/v
    [B, S, H, D] bf16 with a ``supported`` shape.  Returns O [B, S, H, D]
    bf16.  Raises ValueError on anything else.  Every launch adds one to
    ``encoder_attention_kernel.launches``."""
    B, S, H, D = q.shape
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == torch.bfloat16, f"{name} dtype {t.dtype}, need bfloat16")
        _check(tuple(t.shape) == (B, S, H, D),
               f"{name} shape {tuple(t.shape)}, need {(B, S, H, D)}")
    _check(supported(B * H, S, D), f"S={S} D={D}: need S % 128 == 0, "
           "S <= 512, D in (64, 128)")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    with torch.cuda.device(dev):
        _build.launch("encoder_attention", _ARGS, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), B, H, S, D, float(scale),
                      int(bool(causal)), torch.cuda.current_stream(dev).cuda_stream)
    encoder_attention_kernel.launches += 1
    return o


encoder_attention_kernel.launches = 0


def encoder_attention(q, k, v, seed=None, scale=None, dropout_rate=0.0,
                      causal=False):
    """q/k/v [B, S, H, D] -> [B, S, H, D].  ``seed`` is accepted for the
    reference's signature; it only matters with dropout, which raises."""
    b, s, h, d = q.shape
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "encoder attention dropout is not ported yet (ROADMAP.md Queue 2 "
            "item 4: the _prng Philox function, with the encoder slice, "
            "Queue 1 item 4)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the encoder attention backward is not ported yet (ROADMAP.md "
            "Queue 2 item 5, with the encoder slice, Queue 1 item 4); call "
            "it under torch.no_grad()")
    if not supported(b * h, s, d, k.shape[1]):
        raise ValueError(
            f"encoder_attention: shape B*H={b * h} S={s} D={d} unsupported "
            "(need S%128==0, S<=512, D in (64,128)) - use the dense SDPA path")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q.device.type == "cpu":
        return _encoder_dense(q, k, v, scale, causal)
    return encoder_attention_kernel(q, k, v, scale, causal)
