"""FlashAttention forward (counterpart of the forward half of
paddle_tpu/ops/flash_attention.py).

``flash_attention(q, k, v, causal, scale)`` and ``flash_attention_with_lse``
take q [B, Sq, H, D] and k/v [B, Sk, H, D] (paddle layout, equal head
counts: the caller repeats GQA heads) and return O [B, Sq, H, D], plus the
per-query natural-log logsumexp [B, H, Sq] in f32.  Causal masks are
bottom-right aligned (query i sees keys <= i + Sk - Sq), and causal with
Sq > Sk raises, as the reference's admission does.

A CPU tensor takes the plain version ``_flash_dense``; a CUDA tensor
launches ``csrc/flash_attention.cu`` (bf16, D in {64, 128}) or raises.  The
reference's block-size rules (``_auto_block``, ``block_q``/``block_k``,
its autotune hook) describe TPU tiling, not the function: the Hopper kernel
picks its own tiles and masks its ragged edge, so they are not carried
over.  ``supports_seq`` stays, because the SDPA routing reads it.

Forward only: calling with autograd on raises until the recompute backward
(``_dq_kernel``, ``_dkv_kernel``) is ported with training (ROADMAP.md
Queue 1 item 3).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_kernel", "supports_seq"]


def supports_seq(seq):
    """Sequence lengths the reference's kernel tiles without degenerate
    blocks (the SDPA routing gates flash vs dense on it)."""
    return seq % 128 == 0 or (seq <= 512 and seq % 8 == 0)


def _flash_dense(q, k, v, causal, scale):
    """Plain version: (O [B, Sq, H, D] in q's dtype, LSE [B, H, Sq] f32).
    Scores in f32; p is rounded to v's dtype before P.V, as the kernel
    does."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        vis = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.to(q.dtype), lse


def _check(cond, msg):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def flash_attention_kernel(q, k, v, causal=False, scale=None):
    """Launch ``csrc/flash_attention.cu`` on CUDA tensors: q [B, Sq, H, D],
    k/v [B, Sk, H, D], bf16, D in {64, 128}.  Returns (O [B, Sq, H, D]
    bf16, LSE [B * H, Sq] f32).  Raises ValueError on anything else.  Every
    launch adds one to ``flash_attention_kernel.launches``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    _check(D in (64, 128), f"head dim {D}, the kernel is built for 64 and 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == torch.bfloat16, f"{name} dtype {t.dtype}, need bfloat16")
    _check(tuple(k.shape) == (B, Sk, H, D) and tuple(v.shape) == (B, Sk, H, D),
           f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)}, need {(B, Sk, H, D)}")
    _check(Sq > 0 and Sk > 0, "empty sequence")
    _check(not causal or Sq <= Sk, f"causal needs Sq <= Sk, got {Sq} > {Sk}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(B * H, Sq, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch("flash_attention", _ARGS, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, Sq, Sk,
                      D, float(scale), int(bool(causal)),
                      torch.cuda.current_stream(dev).cuda_stream)
    flash_attention_kernel.launches += 1
    return o, lse


flash_attention_kernel.launches = 0


def _forward(q, k, v, causal, scale):
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash attention backward is not ported yet (ROADMAP.md "
            "Queue 1 item 3: flash attention forward/backward with "
            "training); call it under torch.no_grad()")
    if causal and Sq > Sk:
        # queries 0..Sq-Sk-1 would see no key at all; the dense path is the
        # tool for that shape, as in the reference
        raise ValueError(
            f"flash_attention(causal=True) requires Sq <= Sk, got Sq={Sq} "
            f"Sk={Sk}; use the dense SDPA path")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return _flash_dense(q, k, v, causal, scale)
    o, lse = flash_attention_kernel(q, k, v, causal, scale)
    return o, lse.reshape(B, H, Sq)


def flash_attention(q, k, v, causal=False, scale=None):
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> O [B, Sq, H, D]."""
    return _forward(q, k, v, causal, scale)[0]


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """Like flash_attention, plus the per-query logsumexp [B, H, Sq] (f32),
    the hook for blockwise combines (ring attention)."""
    return _forward(q, k, v, causal, scale)
