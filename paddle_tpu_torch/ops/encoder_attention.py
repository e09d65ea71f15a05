"""Fused short-sequence self-attention at dropout rate 0, forward and
backward (counterpart of paddle_tpu/ops/encoder_attention.py).

``encoder_attention(q, k, v, seed, scale, dropout_rate, causal)`` takes
q/k/v [B, S, H, D] (paddle layout) and returns softmax(scale * q k^T) v
[B, S, H, D], each row's softmax taken whole (max and sum first, then the
normalised probabilities rounded to v's dtype before P.V), optionally
causal.  ``supported`` keeps the reference's admission: self-attention
only (Sq == Sk), S % 128 == 0, S <= 512, D in {64, 128}; the reference's
heads-per-step choice (``pick_g``, a VMEM budget) is TPU tiling, and no
admitted shape ever failed it.

It is a ``torch.autograd.Function`` that saves only q, k and v, as the
reference does: the backward (``_bwd_kernel``) recomputes P, then dV =
P^T dO and dP = dO V^T in f32, dS = P (dP - rowsum(dP * P)) * scale rounded
to the input dtype, dQ = dS K and dK = dS^T Q.

A CPU tensor takes the plain versions, ``_encoder_dense`` forward and
``_encoder_bwd_dense`` backward; a CUDA tensor launches
``csrc/encoder_attention.cu`` forward and ``csrc/encoder_attention_bwd.cu``
backward (bf16) or raises.  Not ported yet, and raising
NotImplementedError: dropout (the reference draws its mask from an
in-kernel PRNG; ROADMAP.md Queue 2 item 4, with the encoder slice, Queue 1
item 4).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

__all__ = ["encoder_attention", "encoder_attention_kernel",
           "encoder_attention_bwd_kernel", "supported"]


def supported(bh, s, d, seq_kv=None):
    """The reference's admission (``bh``, the batch times heads, is kept
    for its signature; every count is admitted)."""
    if seq_kv is not None and seq_kv != s:
        return False  # self-attention only
    return s % 128 == 0 and s <= 512 and d in (64, 128)


def _probs(q, k, scale, causal):
    """f32 probabilities [B, H, S, S]: scores in f32, the causal mask added
    as -1e30 (as the reference does), whole-row softmax."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s + torch.where(pos[:, None] >= pos[None, :], 0.0, NEG_INF)
    return torch.softmax(s, dim=-1)


def _encoder_dense(q, k, v, scale, causal):
    """Plain version: p rounded to v's dtype before P.V.  Returns
    [B, S, H, D] in q's dtype."""
    p = _probs(q, k, scale, causal).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _encoder_bwd_dense(q, k, v, do, scale, causal):
    """Plain backward in the order of the reference's ``_bwd_kernel`` at
    rate 0: dV = P^T dO and dP = dO V^T in f32, dS = P (dP - rowsum(dP *
    P)) * scale, rounded to the input dtype before dQ = dS K and dK = dS^T
    Q.  Returns (dq, dk, dv) in the inputs' dtypes."""
    p = _probs(q, k, scale, causal)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(cond, msg):
    if not cond:
        raise ValueError(f"encoder attention kernel: {msg}")


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _check_inputs(tensors):
    """The kernels' admission: CUDA, bf16, one [B, S, H, D] shape that
    ``supported`` admits, 16-byte aligned storage.  Returns the tensors
    made contiguous."""
    q = tensors["q"]
    B, S, H, D = q.shape
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    for name, t in tensors.items():
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == torch.bfloat16, f"{name} dtype {t.dtype}, need bfloat16")
        _check(tuple(t.shape) == (B, S, H, D),
               f"{name} shape {tuple(t.shape)}, need {(B, S, H, D)}")
    _check(supported(B * H, S, D), f"S={S} D={D}: need S % 128 == 0, "
           "S <= 512, D in (64, 128)")
    out = [t.contiguous() for t in tensors.values()]
    _check(all(t.data_ptr() % 16 == 0 for t in out), "storage not 16-byte aligned")
    return out


def encoder_attention_kernel(q, k, v, scale=None, causal=False):
    """Launch ``csrc/encoder_attention.cu`` on CUDA tensors: q/k/v
    [B, S, H, D] bf16 with a ``supported`` shape.  Returns O [B, S, H, D]
    bf16.  Raises ValueError on anything else.  Every launch adds one to
    ``encoder_attention_kernel.launches``."""
    q, k, v = _check_inputs({"q": q, "k": k, "v": v})
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    o = torch.empty_like(q)
    dev = q.device
    with torch.cuda.device(dev):
        _build.launch("encoder_attention", _ARGS, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), B, H, S, D, float(scale),
                      int(bool(causal)), torch.cuda.current_stream(dev).cuda_stream)
    encoder_attention_kernel.launches += 1
    return o


encoder_attention_kernel.launches = 0

_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def encoder_attention_bwd_kernel(q, k, v, do, scale=None, causal=False):
    """Launch ``csrc/encoder_attention_bwd.cu`` (the port of ``_bwd_kernel``
    at rate 0) on CUDA tensors: q/k/v/do [B, S, H, D] bf16 with a
    ``supported`` shape.  Returns (dQ, dK, dV) [B, S, H, D] bf16.  Raises
    ValueError on anything else.  Every launch adds one to
    ``encoder_attention_bwd_kernel.launches``."""
    q, k, v, do = _check_inputs({"q": q, "k": k, "v": v, "do": do})
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    dev = q.device
    # per-row statistics (lse, rowsum(dP * P)) the kernel recomputes and
    # passes from its dQ half to its dK/dV half
    lse = torch.empty(B * H, S, dtype=torch.float32, device=dev)
    dsum = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(dev):
        _build.launch("encoder_attention_bwd", _BWD_ARGS,
                      *(t.data_ptr() for t in (q, k, v, do, lse, dsum, dq, dk, dv)),
                      B, H, S, D, float(scale), int(bool(causal)),
                      torch.cuda.current_stream(dev).cuda_stream)
    encoder_attention_bwd_kernel.launches += 1
    return dq, dk, dv


encoder_attention_bwd_kernel.launches = 0


class _EncoderAttention(torch.autograd.Function):
    """Encoder attention at rate 0; saves only q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.causal = scale, causal
        if q.device.type == "cpu":
            return _encoder_dense(q, k, v, scale, causal)
        return encoder_attention_kernel(q, k, v, scale, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = _encoder_bwd_dense(q, k, v, do, ctx.scale, ctx.causal)
        else:
            dq, dk, dv = encoder_attention_bwd_kernel(q, k, v, do, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


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
    if not supported(b * h, s, d, k.shape[1]):
        raise ValueError(
            f"encoder_attention: shape B*H={b * h} S={s} D={d} unsupported "
            "(need S%128==0, S<=512, D in (64,128)) - use the dense SDPA path")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    return _EncoderAttention.apply(q, k, v, float(scale), bool(causal))
