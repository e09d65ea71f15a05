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
``csrc/flash_attention.cu`` forward and ``csrc/flash_attention_bwd.cu``
backward or raises.  Both run on the tensor cores at every type (one
``wgmma`` design each, instantiated at the inputs' type, D in {64, 128,
256}; at float32 each f32 operand is read as two bf16 planes, hi and lo,
modelled by ``_split_planes_dense``, and each product as three bf16
products: the forward splits its f32 tiles in shared memory, the backward
takes the planes from its split pass ``flash_attention_bwd_split``), as
``_admit.admit`` decides.  The backward's statistics pass (and at float32
its split pass) runs once per backward.  Nothing is cast to reach a
kernel.  The reference's block-size
rules (``_auto_block``, ``block_q``/``block_k``, its autotune hook) describe
TPU tiling, not the function: the Hopper kernels pick their own tiles and
mask their ragged edge, so they are not carried over.  ``supports_seq``
stays, because the SDPA routing reads it.
"""
from __future__ import annotations

import ctypes

import torch

from . import _admit, _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634  # csrc/wgmma_attention.cuh kLog2e

__all__ = ["flash_attention", "flash_attention_with_lse", "flash_attention_kernel",
           "flash_attention_bwd_stats", "flash_attention_bwd_split", "flash_attention_dq_kernel",
           "flash_attention_dkv_kernel", "supports_seq"]


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
    B, Sq, H, _ = q.shape
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None].float())
    dof = do.float()
    dsum = _flash_bwd_stats_dense(o, do, lse, dlse)[1, :, :Sq].reshape(B, H, Sq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    ds = (p * (dp - dsum[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_stats_dense(o, do, lse, dlse=None):
    """Plain version of the backward's statistics pass
    (``flash_attention_bwd_stats``): o, do [B, Sq, H, D], lse and the
    optional dlse f32 with B * H * Sq values -> f32 [2, B * H, Sqp] (Sqp =
    Sq rounded up to 64) holding lse * log2(e) and dsum = rowsum(dO * O) -
    dlse (the sum in f32, as ``_dq_kernel`` and ``_dkv_kernel`` take it),
    zero past Sq."""
    B, Sq, H, _ = o.shape
    dsum = torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).reshape(B * H, Sq)
    if dlse is not None:
        dsum = dsum - dlse.float().reshape(B * H, Sq)
    stats = torch.zeros(_stats_shape(B, H, Sq), dtype=torch.float32, device=o.device)
    stats[0, :, :Sq] = lse.float().reshape(B * H, Sq) * LOG2E
    stats[1, :, :Sq] = dsum
    return stats


def _split_planes_dense(x):
    """Plain version of the float32 kernels' split of an operand (the
    backward's split pass, the forward's split of its tiles in shared
    memory): f32 x [..., D] -> bf16 [..., 2, D], hi = x rounded to nearest
    bf16 and lo = (x - hi) rounded to nearest (x - hi is exact in f32), lo
    = 0 where hi is not finite; hi + lo carries about 16 of x's 24 bits."""
    hi = x.float().to(torch.bfloat16)
    h = hi.float()
    lo = torch.where(torch.isfinite(h), x.float() - h, torch.zeros_like(h)).to(torch.bfloat16)
    return torch.stack((hi, lo), dim=-2)


def _check(cond, msg):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


FWD_HEAD_DIMS = (64, 128, 256)  # csrc/flash_attention.cu FLASH_DIMS
BWD_HEAD_DIMS = (64, 128, 256)  # csrc/flash_attention_bwd.cu FLASH_BWD_DIMS
# The tensor-core kernels' element types and the type codes their entries
# take (csrc/flash_attention.cu FLASH_TYPES, flash_attention_bwd.cu
# FLASH_BWD_TYPES; _admit.TC_TYPES admits them): the encoder's table too.
TYPE_CODES = _admit.TC_TYPE_CODES


def _check_head_dim(D, backward=False):
    """The head dims the kernels are built for: 64, 128 and 256, forward
    and backward."""
    dims = BWD_HEAD_DIMS if backward else FWD_HEAD_DIMS
    _check(D in dims, f"head dim {D}, the kernel is built for {dims}")


def _check_inputs(tensors, B, Sq, Sk, H, D, causal, backward=False):
    """The kernels' common admission: a type ``_admit.admit`` admits to the
    tensor-core kernels (bfloat16, float16 or float32, forward and
    backward), CUDA, the head dim (see ``_check_head_dim``), one dtype, the
    shapes, 16-byte aligned storage."""
    q = tensors["q"]
    dev = q.device
    _admit.admit("flash_bwd" if backward else "flash", q.dtype, q.dtype, D)
    _check(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    _check_head_dim(D, backward)
    for name, t in tensors.items():
        S = Sk if name in ("k", "v") else Sq
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype}, q is {q.dtype}")
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
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def flash_attention_kernel(q, k, v, causal=False, scale=None):
    """Launch ``csrc/flash_attention.cu`` on CUDA tensors: q [B, Sq, H, D],
    k/v [B, Sk, H, D], bfloat16, float16 or float32 (one type; float32 as
    split-bf16 products), D in {64, 128, 256}.
    Returns (O [B, Sq, H, D] in q's dtype, LSE [B * H, Sq] f32).  Raises
    ValueError on anything else.  Every launch adds one to
    ``flash_attention_kernel.launches``."""
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
                      D, float(scale), int(bool(causal)), TYPE_CODES[q.dtype],
                      torch.cuda.current_stream(dev).cuda_stream)
    _build.count(flash_attention_kernel)
    return o, lse


flash_attention_kernel.launches = 0

# q, k, v, o, dO, lse, dlse, stats, planes, then the outputs
_BWD_HEAD = [ctypes.c_void_p] * 9
_BWD_TAIL = [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check_stats(stats, B, H, Sq, dev):
    for name, t in stats.items():
        _check(t.device == dev and t.dtype == torch.float32 and t.numel() == B * H * Sq,
               f"{name} must be f32 [B * H, Sq] = {B * H * Sq} values on {dev}")


def _stats_shape(B, H, Sq):
    """The backward's statistics scratch: [2, B * H, Sq rounded up to 64]."""
    return (2, B * H, -(-Sq // 64) * 64)


def _planes_numel(B, H, Sq, Sk, D):
    """bf16 values of the float32 backward's planes: two of each of q and
    dO [B, Sq, H, D] and of k and v [B, Sk, H, D]."""
    return 4 * B * H * D * (Sq + Sk)


def _bwd_args(q, k, v, o, do, lse, dlse, causal, scale, stats, planes):
    """Checked, contiguous inputs of the two backward kernels and the
    pointers they share: (tensors, head pointers, shape, scale, stats_ready).
    Without ``stats`` the entry fills fresh scratch itself; at float32
    without ``planes`` the split pass runs first (and counts its launch)."""
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
    if q.dtype == torch.float32:
        if planes is None:
            planes = flash_attention_bwd_split(q, k, v, do)
        n = _planes_numel(B, H, Sq, Sk, D)
        _check(planes.dtype == torch.bfloat16 and planes.numel() == n and planes.is_contiguous()
               and planes.device == q.device,
               f"planes must be {n} contiguous bf16 values on {q.device}")
    else:
        _check(planes is None, f"planes are the float32 backward's; q is {q.dtype}")
    head = _ptrs(q, k, v, o, do, lse) + [None if dlse is None else dlse.data_ptr(),
                                         stats.data_ptr(),
                                         None if planes is None else _ptrs(planes)[0]]
    keep = (q, k, v, o, do, lse, dlse, stats, planes)  # alive until the launch is queued
    return keep, head, (B, H, Sq, Sk, D), float(scale), int(ready)


def flash_attention_bwd_stats(o, do, lse, dlse=None):
    """The backward's per-query statistics, by the dsum pass of
    ``csrc/flash_attention_bwd.cu``: f32 [2, B * H, Sqp] (Sqp = Sq rounded
    up to 64) holding lse * log2(e) and dsum = rowsum(dO * O) - dlse, zero
    past Sq.  o, do [B, Sq, H, D] bfloat16, float16 or float32 on the card,
    D in {64, 128, 256}; lse and dlse f32 with B * H * Sq values (dlse may
    be None).  The pass streams o and dO in memory order with 16-byte
    loads; ``_flash_bwd_stats_dense`` is its plain version.  The autograd
    backward fills it once and hands it to both kernels below.  Every
    launch adds one to ``flash_attention_bwd_stats.launches``."""
    B, Sq, H, D = o.shape
    _check_inputs({"q": o, "do": do}, B, Sq, Sq, H, D, False, backward=True)
    _check_stats({"lse": lse} if dlse is None else {"lse": lse, "dlse": dlse}, B, H, Sq,
                 o.device)
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    dlse = None if dlse is None else dlse.contiguous()
    stats = torch.empty(_stats_shape(B, H, Sq), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        _build.launch("flash_attention_bwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p], *_ptrs(o, do, lse),
                      None if dlse is None else dlse.data_ptr(), stats.data_ptr(), B, H, Sq, D,
                      TYPE_CODES[o.dtype], torch.cuda.current_stream(o.device).cuda_stream,
                      entry="flash_attention_dsum")
    _build.count(flash_attention_bwd_stats)
    return stats


flash_attention_bwd_stats.launches = 0


def flash_attention_bwd_split(q, k, v, do):
    """The float32 backward's operand planes, by the split pass of
    ``csrc/flash_attention_bwd.cu`` (``flash_attention_split``; one launch
    for the four tensors): q, do [B, Sq, H, D] and k, v [B, Sk, H, D]
    float32 on the card, D in {64, 128, 256}, into one contiguous bf16
    tensor holding ``_split_planes_dense`` of q, k, v and do, flattened, in
    that order.  The autograd backward makes it once and hands it to the dq
    and dkv kernels.  Every launch adds one to
    ``flash_attention_bwd_split.launches``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    _check(q.dtype == torch.float32, f"the split pass takes float32, got {q.dtype}")
    _check_inputs({"q": q, "k": k, "v": v, "do": do}, B, Sq, Sk, H, D, False, backward=True)
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    planes = torch.empty(_planes_numel(B, H, Sq, Sk, D), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        _build.launch("flash_attention_bwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_void_p], *_ptrs(q, k, v, do, planes), B, H, Sq, Sk, D,
                      torch.cuda.current_stream(q.device).cuda_stream,
                      entry="flash_attention_split")
    _build.count(flash_attention_bwd_split)
    return planes


flash_attention_bwd_split.launches = 0


def flash_attention_dq_kernel(q, k, v, o, do, lse, causal=False, scale=None, dlse=None,
                              stats=None, planes=None):
    """Launch ``flash_attention_dq`` of ``csrc/flash_attention_bwd.cu`` (the
    port of ``_dq_kernel``) on CUDA tensors: q, o, do [B, Sq, H, D], k, v
    [B, Sk, H, D] of one type, bfloat16, float16 or float32, D in {64, 128,
    256}, lse (and the optional dlse) f32 with B * H * Sq values; ``stats``
    from ``flash_attention_bwd_stats``, or None to have the entry compute
    them first; at float32 ``planes`` from ``flash_attention_bwd_split``, or
    None to run the split pass first.  Returns dQ [B, Sq, H, D] in q's
    dtype.  Raises ValueError on anything else.  Every launch adds one to
    ``flash_attention_dq_kernel.launches``."""
    keep, head, shape, scale, ready = _bwd_args(q, k, v, o, do, lse, dlse, causal, scale, stats,
                                                planes)
    dq = torch.empty_like(keep[0])
    dev = dq.device
    with torch.cuda.device(dev):
        _build.launch("flash_attention_bwd", _BWD_HEAD + [ctypes.c_void_p] + _BWD_TAIL,
                      *head, *_ptrs(dq), *shape, scale, int(bool(causal)), ready,
                      TYPE_CODES[dq.dtype], torch.cuda.current_stream(dev).cuda_stream,
                      entry="flash_attention_dq")
    _build.count(flash_attention_dq_kernel)
    return dq


flash_attention_dq_kernel.launches = 0


def flash_attention_dkv_kernel(q, k, v, o, do, lse, causal=False, scale=None, dlse=None,
                               stats=None, planes=None):
    """Launch ``flash_attention_dkv`` of ``csrc/flash_attention_bwd.cu`` (the
    port of ``_dkv_kernel``), with the inputs of
    ``flash_attention_dq_kernel``.  Returns (dK, dV) [B, Sk, H, D] in their
    dtype.
    Every launch adds one to ``flash_attention_dkv_kernel.launches``."""
    keep, head, shape, scale, ready = _bwd_args(q, k, v, o, do, lse, dlse, causal, scale, stats,
                                                planes)
    dk, dv = torch.empty_like(keep[1]), torch.empty_like(keep[2])
    dev = dk.device
    with torch.cuda.device(dev):
        _build.launch("flash_attention_bwd", _BWD_HEAD + [ctypes.c_void_p] * 2 + _BWD_TAIL,
                      *head, *_ptrs(dk, dv), *shape, scale, int(bool(causal)), ready,
                      TYPE_CODES[dk.dtype], torch.cuda.current_stream(dev).cuda_stream,
                      entry="flash_attention_dkv")
    _build.count(flash_attention_dkv_kernel)
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
            # the statistics and the float32 planes, once for both kernels
            stats = flash_attention_bwd_stats(o, do, lse, dlse)
            planes = flash_attention_bwd_split(q, k, v, do) if q.dtype == torch.float32 else None
            dq = flash_attention_dq_kernel(*args, stats=stats, planes=planes)
            dk, dv = flash_attention_dkv_kernel(*args, stats=stats, planes=planes)
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
