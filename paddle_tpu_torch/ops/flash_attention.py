"""FlashAttention forward and backward (counterpart of
paddle_tpu/ops/flash_attention.py).

``flash_attention(q, k, v, causal, scale)`` and ``flash_attention_with_lse``
take q [B, Sq, H, D] and k/v [B, Sk, H, D] (paddle layout, equal head
counts: the caller repeats GQA heads) and return O [B, Sq, H, D], plus the
per-query natural-log logsumexp [B, H, Sq] in f32.  Causal masks are
bottom-right aligned (query i sees keys <= i + Sk - Sq), and causal with
Sq > Sk raises, as the reference's admission does.

Both are ``torch.autograd.Function``s with the reference's recompute
backward (``_dq_kernel``, ``_dkv_kernel``): the forward saves q, k, v, O and
the f32 LSE; the backward recomputes P = exp(S - lse), takes dsum =
rowsum(dO * O) - dlse, and returns dQ, dK and dV, with dS = P (dP - dsum)
and, for dV, P rounded to the input dtype as the reference rounds them.
``flash_attention_with_lse`` honours the LSE's cotangent (ring attention's
combine needs it).

A CPU tensor takes the plain versions, ``_flash_dense`` forward and
``_flash_bwd_dense`` backward; a CUDA tensor launches
``csrc/flash_attention.cu`` forward (bf16, D in {64, 128, 256}) and
``csrc/flash_attention_bwd.cu`` backward (bf16, D in {64, 128}; its dsum
pass runs once per backward) or raises.  The reference's block-size
rules (``_auto_block``, ``block_q``/``block_k``, its autotune hook) describe
TPU tiling, not the function: the Hopper kernels pick their own tiles and
mask their ragged edge, so they are not carried over.  ``supports_seq``
stays, because the SDPA routing reads it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

__all__ = ["flash_attention", "flash_attention_with_lse", "flash_attention_kernel",
           "flash_attention_bwd_stats", "flash_attention_dq_kernel", "flash_attention_dkv_kernel",
           "supports_seq"]


def supports_seq(seq):
    """Sequence lengths the reference's kernel tiles without degenerate
    blocks (the SDPA routing gates flash vs dense on it)."""
    return seq % 128 == 0 or (seq <= 512 and seq % 8 == 0)


def _scores(q, k, causal, scale):
    """f32 scores [B, H, Sq, Sk], masked to NEG_INF past each row's causal
    end."""
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        vis = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril(Sk - Sq)
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    return s


def _flash_dense(q, k, v, causal, scale):
    """Plain version: (O [B, Sq, H, D] in q's dtype, LSE [B, H, Sq] f32).
    Scores in f32; p is rounded to v's dtype before P.V, as the kernel
    does."""
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.to(q.dtype), lse


def _flash_bwd_dense(q, k, v, o, lse, do, causal, scale, dlse=None):
    """Plain backward, in the reference's order (``_dq_kernel`` and
    ``_dkv_kernel``) and in f32 on the given values: P = exp(S - lse), dsum
    = rowsum(dO * O) - dlse, dV = round(P)^T dO, dP = dO V^T, dS =
    round(P (dP - dsum)), dQ = dS K * scale, dK = dS^T Q * scale, where
    round() is a cast to the input dtype (a no-op in f32).  lse and dlse
    are [B, H, Sq] f32.  Returns (dq, dk, dv) in the inputs' dtypes."""
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None].float())
    dof = do.float()
    dsum = torch.einsum("bqhd,bqhd->bhq", dof, o.float())
    if dlse is not None:
        dsum = dsum - dlse.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - dsum[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(cond, msg):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


FWD_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128)


def _check_head_dim(D, backward=False):
    """The head dims the kernels are built for: 64, 128 and 256 forward,
    64 and 128 backward."""
    if backward and D == 256:
        # dK and dV accumulators of 64 key rows x 256 f32 would take 256
        # registers a thread on their own: the backward needs its own tiling
        raise ValueError(
            "flash attention kernel: head dim 256 has a forward kernel but no "
            "backward one yet (ROADMAP Queue 2, item 8): train at head dim 64 or "
            "128, or call the D = 256 forward without gradients")
    dims = BWD_HEAD_DIMS if backward else FWD_HEAD_DIMS
    _check(D in dims, f"head dim {D}, the kernel is built for {dims}")


def _check_inputs(tensors, B, Sq, Sk, H, D, causal, backward=False):
    """The kernels' common admission: CUDA, bf16, the head dim (see
    ``_check_head_dim``), the shapes, 16-byte aligned storage."""
    dev = tensors["q"].device
    _check(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    _check_head_dim(D, backward)
    for name, t in tensors.items():
        S = Sk if name in ("k", "v") else Sq
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == torch.bfloat16, f"{name} dtype {t.dtype}, need bfloat16")
        _check(tuple(t.shape) == (B, S, H, D),
               f"{name} shape {tuple(t.shape)}, need {(B, S, H, D)}")
    _check(Sq > 0 and Sk > 0, "empty sequence")
    _check(not causal or Sq <= Sk, f"causal needs Sq <= Sk, got {Sq} > {Sk}")


def _ptrs(*tensors):
    """data_ptr()s of contiguous tensors, 16-byte aligned as TMA needs."""
    out = []
    for t in tensors:
        _check(t.data_ptr() % 16 == 0, "storage not 16-byte aligned")
        out.append(t.data_ptr())
    return out


_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def flash_attention_kernel(q, k, v, causal=False, scale=None):
    """Launch ``csrc/flash_attention.cu`` on CUDA tensors: q [B, Sq, H, D],
    k/v [B, Sk, H, D], bf16, D in {64, 128, 256}.  Returns (O [B, Sq, H, D]
    bf16, LSE [B * H, Sq] f32).  Raises ValueError on anything else.  Every
    launch adds one to ``flash_attention_kernel.launches``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_inputs({"q": q, "k": k, "v": v}, B, Sq, Sk, H, D, causal)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty(B * H, Sq, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch("flash_attention", _ARGS, *_ptrs(q, k, v, o, lse), B, H, Sq, Sk,
                      D, float(scale), int(bool(causal)),
                      torch.cuda.current_stream(dev).cuda_stream)
    flash_attention_kernel.launches += 1
    return o, lse


flash_attention_kernel.launches = 0

# q, k, v, o, dO, lse, dlse, stats, then the outputs
_BWD_HEAD = [ctypes.c_void_p] * 8
_BWD_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check_stats(stats, B, H, Sq, dev):
    for name, t in stats.items():
        _check(t.device == dev and t.dtype == torch.float32 and t.numel() == B * H * Sq,
               f"{name} must be f32 [B * H, Sq] = {B * H * Sq} values on {dev}")


def _stats_shape(B, H, Sq):
    """The backward's statistics scratch: [2, B * H, Sq rounded up to 64]."""
    return (2, B * H, -(-Sq // 64) * 64)


def _bwd_args(q, k, v, o, do, lse, dlse, causal, scale, stats):
    """Checked, contiguous inputs of the two backward kernels and the
    pointers they share: (tensors, head pointers, shape, scale, stats_ready).
    Without ``stats`` the entry fills fresh scratch itself."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check_inputs({"q": q, "k": k, "v": v, "o": o, "do": do}, B, Sq, Sk, H, D, causal,
                  backward=True)
    _check_stats({"lse": lse} if dlse is None else {"lse": lse, "dlse": dlse}, B, H, Sq,
                 q.device)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    dlse = None if dlse is None else dlse.contiguous()
    ready = stats is not None
    if stats is None:
        stats = torch.empty(_stats_shape(B, H, Sq), dtype=torch.float32, device=q.device)
    _check(stats.dtype == torch.float32 and tuple(stats.shape) == _stats_shape(B, H, Sq)
           and stats.is_contiguous() and stats.device == q.device,
           f"stats must be contiguous f32 {_stats_shape(B, H, Sq)} on {q.device}")
    head = _ptrs(q, k, v, o, do, lse) + [None if dlse is None else dlse.data_ptr(),
                                         stats.data_ptr()]
    keep = (q, k, v, o, do, lse, dlse, stats)  # alive until the launch is queued
    return keep, head, (B, H, Sq, Sk, D), float(scale), int(ready)


def flash_attention_bwd_stats(o, do, lse, dlse=None):
    """The backward's per-query statistics, by the dsum pass of
    ``csrc/flash_attention_bwd.cu``: f32 [2, B * H, Sqp] (Sqp = Sq rounded
    up to 64) holding lse * log2(e) and dsum = rowsum(dO * O) - dlse, zero
    past Sq.  o, do [B, Sq, H, D] bf16 on the card; lse and dlse f32 with
    B * H * Sq values (dlse may be None).  The autograd backward fills it
    once and hands it to both kernels below."""
    B, Sq, H, D = o.shape
    _check_inputs({"q": o, "do": do}, B, Sq, Sq, H, D, False, backward=True)
    _check_stats({"lse": lse} if dlse is None else {"lse": lse, "dlse": dlse}, B, H, Sq,
                 o.device)
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    dlse = None if dlse is None else dlse.contiguous()
    stats = torch.empty(_stats_shape(B, H, Sq), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        _build.launch("flash_attention_bwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p], *_ptrs(o, do, lse),
                      None if dlse is None else dlse.data_ptr(), stats.data_ptr(), B, H, Sq, D,
                      torch.cuda.current_stream(o.device).cuda_stream,
                      entry="flash_attention_dsum")
    return stats


def flash_attention_dq_kernel(q, k, v, o, do, lse, causal=False, scale=None, dlse=None,
                              stats=None):
    """Launch ``flash_attention_dq`` of ``csrc/flash_attention_bwd.cu`` (the
    port of ``_dq_kernel``) on CUDA tensors: q, o, do [B, Sq, H, D], k, v
    [B, Sk, H, D] bf16, D in {64, 128}, lse (and the optional dlse) f32 with
    B * H * Sq values; ``stats`` from ``flash_attention_bwd_stats``, or None
    to have the entry compute them first.  Returns dQ [B, Sq, H, D] bf16.
    Raises ValueError on anything else.  Every launch adds one to
    ``flash_attention_dq_kernel.launches``."""
    keep, head, shape, scale, ready = _bwd_args(q, k, v, o, do, lse, dlse, causal, scale, stats)
    dq = torch.empty_like(keep[0])
    dev = dq.device
    with torch.cuda.device(dev):
        _build.launch("flash_attention_bwd", _BWD_HEAD + [ctypes.c_void_p] + _BWD_TAIL,
                      *head, *_ptrs(dq), *shape, scale, int(bool(causal)), ready,
                      torch.cuda.current_stream(dev).cuda_stream, entry="flash_attention_dq")
    flash_attention_dq_kernel.launches += 1
    return dq


flash_attention_dq_kernel.launches = 0


def flash_attention_dkv_kernel(q, k, v, o, do, lse, causal=False, scale=None, dlse=None,
                               stats=None):
    """Launch ``flash_attention_dkv`` of ``csrc/flash_attention_bwd.cu`` (the
    port of ``_dkv_kernel``), with the inputs of
    ``flash_attention_dq_kernel``.  Returns (dK, dV) [B, Sk, H, D] bf16.
    Every launch adds one to ``flash_attention_dkv_kernel.launches``."""
    keep, head, shape, scale, ready = _bwd_args(q, k, v, o, do, lse, dlse, causal, scale, stats)
    dk, dv = torch.empty_like(keep[1]), torch.empty_like(keep[2])
    dev = dk.device
    with torch.cuda.device(dev):
        _build.launch("flash_attention_bwd", _BWD_HEAD + [ctypes.c_void_p] * 2 + _BWD_TAIL,
                      *head, *_ptrs(dk, dv), *shape, scale, int(bool(causal)), ready,
                      torch.cuda.current_stream(dev).cuda_stream, entry="flash_attention_dkv")
    flash_attention_dkv_kernel.launches += 1
    return dk, dv


flash_attention_dkv_kernel.launches = 0


class _FlashAttention(torch.autograd.Function):
    """O and LSE of flash attention, with the recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        B, Sq, H, _ = q.shape
        if q.device.type == "cpu":
            o, lse = _flash_dense(q, k, v, causal, scale)
        else:
            o, lse = flash_attention_kernel(q, k, v, causal, scale)
            lse = lse.reshape(B, H, Sq)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:  # only the LSE reached the loss
            do = torch.zeros_like(o)
        if q.device.type == "cpu":
            dq, dk, dv = _flash_bwd_dense(q, k, v, o, lse, do, ctx.causal, ctx.scale, dlse)
        else:
            args = (q, k, v, o, do, lse, ctx.causal, ctx.scale, dlse)
            stats = flash_attention_bwd_stats(o, do, lse, dlse)  # once for both kernels
            dq = flash_attention_dq_kernel(*args, stats=stats)
            dk, dv = flash_attention_dkv_kernel(*args, stats=stats)
        return dq, dk, dv, None, None


def _forward(q, k, v, causal, scale):
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    if causal and Sq > Sk:
        # queries 0..Sq-Sk-1 would see no key at all; the dense path is the
        # tool for that shape, as in the reference
        raise ValueError(
            f"flash_attention(causal=True) requires Sq <= Sk, got Sq={Sq} "
            f"Sk={Sk}; use the dense SDPA path")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))


def flash_attention(q, k, v, causal=False, scale=None):
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> O [B, Sq, H, D];
    differentiable through the recompute backward."""
    return _forward(q, k, v, causal, scale)[0]


def flash_attention_with_lse(q, k, v, causal=False, scale=None):
    """Like flash_attention, plus the per-query logsumexp [B, H, Sq] (f32),
    the hook for blockwise combines (ring attention); the backward honours
    the LSE's cotangent."""
    return _forward(q, k, v, causal, scale)
