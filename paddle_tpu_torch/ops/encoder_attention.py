"""Fused short-sequence self-attention with dropout of the probabilities,
forward and backward (counterpart of paddle_tpu/ops/encoder_attention.py).

``encoder_attention(q, k, v, seed, scale, dropout_rate, causal)`` takes
q/k/v [B, S, H, D] (paddle layout) and returns dropout(softmax(scale *
q k^T)) v [B, S, H, D], each row's softmax taken whole (max and sum first,
then the normalised probabilities, masked and scaled by 1 / (1 - rate),
rounded to v's dtype before P.V), optionally causal.  The mask is Philox
from the int32 [2] ``seed`` (``ops/_prng.py``: element (bh, i, j) of the
[B * H, S, S] probabilities reads counter (oct(i), oct(j), bh, 0)), not the
TPU's bits.  ``supported`` keeps the reference's admission: self-attention
only (Sq == Sk), S % 128 == 0, S <= 512, D in {64, 128}; the reference's
heads-per-step choice (``pick_g``, a VMEM budget) is TPU tiling, and no
admitted shape ever failed it.

It is a ``torch.autograd.Function`` that saves q, k, v and the seed, as
the reference does, and on the card also the rows' logsumexp [B * H, S]
f32 (which the streamed backward kernels read: ``_whole_head``).  The
backward (the reference's ``_bwd_kernel``) recomputes P and regenerates
the mask, then dV = P_d^T dO
with P_d = where(keep, P / (1 - rate), 0) and dP = where(keep, dO V^T /
(1 - rate), 0) in f32, dS = P (dP - rowsum(dP * P)) * scale rounded to the
input dtype, dQ = dS K and dK = dS^T Q.  Nothing of size [B * H, S, S] is
stored.

A CPU tensor takes the plain versions, ``_encoder_dense`` forward and
``_encoder_bwd_dense`` backward; a CUDA tensor launches
``csrc/encoder_attention.cu`` forward and ``csrc/encoder_attention_bwd.cu``
backward or raises.  Both run on the tensor cores at bfloat16, float16 and
float32 (one ``wgmma`` design each, instantiated at the inputs' type; at
float32 each f32 tile is split into two bf16 planes in shared memory and
each product runs as three bf16 products, the same Philox mask from the
same seed), as ``_admit.admit`` decides.  Nothing is cast to reach a
kernel.  The kernels read q, k, v and dO through TMA with their own
strides, so strided views such as the three slices of one packed
[B, S, 3, H, D] projection launch without copies; only a view they cannot
read (``tma_readable``) is copied, and counted.
"""
from __future__ import annotations

import ctypes

import torch

from . import _admit, _build
from ._prng import encoder_bits, keep_mask, launch_args

NEG_INF = -1e30

__all__ = ["encoder_attention", "encoder_attention_kernel", "encoder_attention_bwd_kernel",
           "supported", "tma_readable"]


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


def dropout_keep(seed, B, H, S, rate):
    """The keep mask [B, H, S, S] of a call with this seed and rate (the
    kernels' bits, ops/_prng.py)."""
    return keep_mask(encoder_bits(seed, B * H, S), rate).reshape(B, H, S, S)


def _drop(x, keep, rate):
    return x if keep is None else torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)


def _encoder_lse(q, k, scale, causal):
    """Plain version of the forward kernel's second output: each row's
    natural-log logsumexp of the scaled (and causally masked) scores,
    [B * H, S] f32."""
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        s = s + torch.where(pos[:, None] >= pos[None, :], 0.0, NEG_INF)
    return torch.logsumexp(s, dim=-1).reshape(-1, S)


def _encoder_dense(q, k, v, scale, causal, keep=None, rate=0.0):
    """Plain version: p masked by ``keep`` [B, H, S, S] (None: no dropout)
    and scaled by 1 / (1 - rate), then rounded to v's dtype before P.V.
    Returns [B, S, H, D] in q's dtype."""
    p = _drop(_probs(q, k, scale, causal), keep, rate).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float()).to(q.dtype)


def _encoder_bwd_dense(q, k, v, do, scale, causal, keep=None, rate=0.0):
    """Plain backward in the order of the reference's ``_bwd_kernel``: dV =
    P_d^T dO and dP = where(keep, dO V^T / (1 - rate), 0) in f32, dS = P
    (dP - rowsum(dP * P)) * scale, rounded to the input dtype before dQ =
    dS K and dK = dS^T Q.  Returns (dq, dk, dv) in the inputs' dtypes."""
    p = _probs(q, k, scale, causal)
    dof = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", _drop(p, keep, rate), dof)
    dp = _drop(torch.einsum("bqhd,bkhd->bhqk", dof, v.float()), keep, rate)
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(q.dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(cond, msg):
    if not cond:
        raise ValueError(f"encoder attention kernel: {msg}")


def tma_readable(shape, strides, data_ptr, itemsize=2):
    """Whether the kernels' TMA loads can read a [B, S, H, D] view in place:
    the last dimension contiguous, the heads D apart, the row and batch
    strides positive multiples of 16 bytes (or their dimension of size 1),
    and the storage 16-byte aligned.  The three slices of one packed
    [B, S, 3, H, D] tensor qualify; a transposed [B, H, S, D] tensor does
    not."""
    B, S, H, D = shape
    sb, ss, sh, sd = strides
    return (sd == 1 and (H == 1 or sh == D) and data_ptr % 16 == 0
            and all(n == 1 or (st > 0 and st * itemsize % 16 == 0)
                    for n, st in ((S, ss), (B, sb))))


def _tma_strides(t):
    """(head, row, batch) element strides of a TMA-readable view, with a
    valid stand-in for a dimension of size 1."""
    B, S, H, D = t.shape
    ss = t.stride(1) if S > 1 else H * D
    return D, ss, t.stride(0) if B > 1 else S * ss


def _check_inputs(tensors, regime="encoder"):
    """The kernels' admission: a type ``_admit.admit`` admits to the
    tensor-core kernels (bfloat16, float16 or float32; ``regime``
    "encoder" or "encoder_bwd"), CUDA, one dtype, one [B, S, H, D] shape
    that ``supported`` admits.  Returns the tensors as they are where the
    kernels can read them in place (``tma_readable``), else a contiguous
    copy; each copy adds one to ``_check_inputs.copies``."""
    q = tensors["q"]
    B, S, H, D = q.shape
    dev = q.device
    _admit.admit(regime, q.dtype, q.dtype, D)
    _check(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    for name, t in tensors.items():
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == q.dtype, f"{name} dtype {t.dtype}, q is {q.dtype}")
        _check(tuple(t.shape) == (B, S, H, D),
               f"{name} shape {tuple(t.shape)}, need {(B, S, H, D)}")
    _check(supported(B * H, S, D), f"S={S} D={D}: need S % 128 == 0, "
           "S <= 512, D in (64, 128)")
    out = []
    for t in tensors.values():
        if not tma_readable(tuple(t.shape), t.stride(), t.data_ptr(), t.element_size()):
            t = t.clone(memory_format=torch.contiguous_format)  # fresh, aligned storage
            _check_inputs.copies += 1
            _check(t.data_ptr() % 16 == 0, "storage not 16-byte aligned")
        out.append(t)
    return out


_check_inputs.copies = 0


def _strides(*ts):
    return [st for t in ts for st in _tma_strides(t)]


_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9
         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_float, ctypes.c_void_p])


def encoder_attention_kernel(q, k, v, scale=None, causal=False, seed=None, rate=0.0):
    """Launch ``csrc/encoder_attention.cu`` on CUDA tensors: q/k/v
    [B, S, H, D] views of one type, bfloat16, float16 or float32 (as
    split-bf16 products), with a
    ``supported`` shape (strided views that ``tma_readable`` admits are
    read in place); with ``rate`` > 0, dropout from ``seed`` (int32 [2] on
    q's device).  Returns (O [B, S, H, D] in q's dtype, contiguous, the
    rows' natural-log logsumexp [B * H, S] f32).  Raises
    ValueError on anything else.  Every launch adds one to
    ``encoder_attention_kernel.launches``."""
    q, k, v = _check_inputs({"q": q, "k": k, "v": v})
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    dev = q.device
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=dev)
    lse = torch.empty(B * H, S, dtype=torch.float32, device=dev)
    sp, thresh, inv = launch_args(seed, rate, 1.0 / (1.0 - rate), dev)
    with torch.cuda.device(dev):
        _build.launch("encoder_attention", _ARGS, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, S, D,
                      *_strides(q, k, v), float(scale), int(bool(causal)),
                      _admit.TC_TYPE_CODES[q.dtype], sp, thresh, float(inv),
                      torch.cuda.current_stream(dev).cuda_stream)
    encoder_attention_kernel.launches += 1
    return o, lse


encoder_attention_kernel.launches = 0

_BWD_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint32,
                ctypes.c_float, ctypes.c_void_p])


def _whole_head(S, D, itemsize):
    """Whether the backward runs the whole-head kernel, which needs nothing
    from the forward: S = 128 and a row of q at most 256 bytes (bfloat16
    and float16 at head dims 64 and 128, float32 at 64), the rule of
    ``csrc/encoder_attention_bwd.cu`` (``kHeadFits``).  Every other shape
    runs the streamed kernels, which read the forward's lse."""
    return S == 128 and D * itemsize <= 256


def encoder_attention_bwd_kernel(q, k, v, do, scale=None, causal=False, seed=None,
                                 rate=0.0, lse=None):
    """Launch ``csrc/encoder_attention_bwd.cu`` (the port of ``_bwd_kernel``)
    on CUDA tensors: q/k/v/do [B, S, H, D] views of one type, bfloat16,
    float16 or float32, with a ``supported`` shape, the forward's ``seed``
    and ``rate`` and, where ``_whole_head`` is false, its rows' ``lse`` (the
    forward kernel's second output).  Returns (dQ, dK, dV) [B, S, H, D] in
    q's dtype, contiguous.  Raises ValueError on anything else.  Every
    launch adds one to ``encoder_attention_bwd_kernel.launches``."""
    q, k, v, do = _check_inputs({"q": q, "k": k, "v": v, "do": do}, "encoder_bwd")
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    dev = q.device
    stats = bits = None
    if not _whole_head(S, D, q.element_size()):
        _check(lse is not None,
               f"S={S} D={D} at {q.dtype} needs the forward's lse (its kernel's second output)")
        _check(tuple(lse.shape) == (B * H, S) and lse.dtype == torch.float32
               and lse.device == dev, "lse must be [B * H, S] f32 on q's device")
        lse = lse.contiguous()
        stats = torch.empty(2, B * H, S, dtype=torch.float32, device=dev)
        if rate > 0.0:
            bits = torch.empty(B * H * S * S // 8, dtype=torch.uint8, device=dev)
    dq, dk, dv = (torch.empty(B, S, H, D, dtype=q.dtype, device=dev) for _ in range(3))
    sp, thresh, inv = launch_args(seed, rate, 1.0 / (1.0 - rate), dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        _build.launch("encoder_attention_bwd", _BWD_ARGS,
                      *(ptr(t) for t in (q, k, v, do, lse, stats, bits, dq, dk, dv)),
                      B, H, S, D, *_strides(q, k, v, do), float(scale), int(bool(causal)),
                      _admit.TC_TYPE_CODES[q.dtype], sp, thresh, float(inv),
                      torch.cuda.current_stream(dev).cuda_stream)
    encoder_attention_bwd_kernel.launches += 1
    return dq, dk, dv


encoder_attention_bwd_kernel.launches = 0


def _plain_keep(q, seed, rate):
    B, S, H, _ = q.shape
    return dropout_keep(seed, B, H, S, rate) if rate > 0.0 else None


class _EncoderAttention(torch.autograd.Function):
    """Encoder attention; saves only q, k, v and the seed pair."""

    @staticmethod
    def forward(ctx, q, k, v, seed, scale, rate, causal):
        ctx.scale, ctx.rate, ctx.causal = scale, rate, causal
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, seed)
            return _encoder_dense(q, k, v, scale, causal, _plain_keep(q, seed, rate), rate)
        o, lse = encoder_attention_kernel(q, k, v, scale, causal, seed, rate)
        ctx.save_for_backward(q, k, v, seed, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seed, *fwd = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = _encoder_bwd_dense(q, k, v, do, ctx.scale, ctx.causal,
                                            _plain_keep(q, seed, ctx.rate), ctx.rate)
        else:
            dq, dk, dv = encoder_attention_bwd_kernel(q, k, v, do, ctx.scale, ctx.causal, seed,
                                                      ctx.rate, *fwd)
        return dq, dk, dv, None, None, None, None


def encoder_attention(q, k, v, seed=None, scale=None, dropout_rate=0.0,
                      causal=False):
    """q/k/v [B, S, H, D] -> [B, S, H, D].  ``seed``: int32 [2] on q's
    device, required when ``dropout_rate`` > 0."""
    b, s, h, d = q.shape
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("encoder_attention: dropout_rate > 0 requires a seed")
    if seed is None:
        seed = torch.zeros(2, dtype=torch.int32, device=q.device)
    if not supported(b * h, s, d, k.shape[1]):
        raise ValueError(
            f"encoder_attention: shape B*H={b * h} S={s} D={d} unsupported "
            "(need S%128==0, S<=512, D in (64,128)) - use the dense SDPA path")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    return _EncoderAttention.apply(q, k, v, seed, float(scale), float(dropout_rate),
                                   bool(causal))
