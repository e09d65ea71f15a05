"""The fused Adam / AdamW update (``csrc/fused_adam.cu``) and its plain
version.

The reference has no Pallas kernel here: it updates each parameter with
jnp code (paddle_tpu/optimizer/optimizer.py ``_apply_update`` around
``Adam._update_rule``) that XLA fuses into its one jitted train step.  The
port's plain version is that chain as torch ops, about a dozen elementwise
kernels a parameter (``adam_update_dense``); on CUDA one launch of the
hand-written kernel updates every parameter of a (dtype, decay mode) group
instead, with the same operations and roundings, so that its bits are the
chain's.  ``adam_update`` dispatches: CPU parameters take the plain
version, CUDA ones the kernel (or it raises).  Both write the parameter,
its moments and its ``beta1_pow`` / ``beta2_pow`` in place, which a
captured train step (jit/train_step.py) needs: a graph replays on the
tensors it saw at capture.

The kernel is bound by bytes: p, g, m and v read once and p, m and v
written, 14 bytes a bf16 parameter and 28 a float32 one (3.1 and 6.2 ms
for the 738.3 M parameters of the LLaMA training configuration at the
H100's 3.35 TB/s).  Its launches add one each to
``fused_adam_kernel.launches``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..optimizer.optimizer import _like
from . import _build

__all__ = ["adam_rule", "adam_update", "adam_update_dense", "fused_adam_kernel"]

TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_PARAMS = 384  # csrc/fused_adam.cu kMaxParams: the parameters one launch's table holds


def adam_rule(p, g, m, v, b1p, b2p, lr, beta1, beta2, eps):
    """The reference's ``Adam._update_rule``: (new p in f32, m, v, b1p, b2p)
    from p, g, the moments (in p's dtype), the f32 pows and the f32 ``lr``;
    each Python scalar rounded to the moments' dtype first, as JAX rounds
    a weakly typed scalar (``_like``)."""
    m = _like(beta1, g) * m + _like(1 - beta1, g) * g
    v = _like(beta2, g) * v + _like(1 - beta2, g) * g.square()
    b1p = b1p * beta1
    b2p = b2p * beta2
    mhat = m / (1 - b1p).to(m.dtype)
    vhat = v / (1 - b2p).to(v.dtype)
    new_p = p.float() - lr * mhat.float() / (vhat.sqrt() + _like(eps, v)).float()
    return new_p, m, v, b1p, b2p


@torch.no_grad()
def adam_update_dense(p, g, state, lr, coeff, mode, beta1, beta2, eps):
    """The plain version: one parameter's update by the chain of
    ``Optimizer._apply_update`` around ``adam_rule`` (g cast to p's dtype,
    an L2 decay added to g or a decoupled one subtracted from the new
    value, p restored to its dtype), written into ``p`` and ``state``
    (moment1, moment2, beta1_pow, beta2_pow) in place.  ``lr`` is an f32
    scalar tensor, ``coeff`` the parameter's decay coefficient, ``mode``
    "l2" or "decoupled"."""
    pv = p.detach()
    if g.dtype != pv.dtype:
        g = g.to(pv.dtype)
    if coeff and mode == "l2":
        g = g + _like(coeff, pv) * pv
    new_p, m, v, b1p, b2p = adam_rule(pv, g, state["moment1"], state["moment2"],
                                      state["beta1_pow"], state["beta2_pow"], lr, beta1, beta2,
                                      eps)
    if coeff and mode == "decoupled":
        new_p = new_p.float() - (lr * coeff) * pv.float()
    for k, t in (("moment1", m), ("moment2", v), ("beta1_pow", b1p), ("beta2_pow", b2p)):
        state[k].copy_(t)
    pv.copy_(new_p.to(pv.dtype))


_TICKETS = {}


def _tickets(dev, stream):
    """The pows' ticket counters for launches on ``stream`` of ``dev``:
    MAX_PARAMS uint32, zero between launches (the last block of each
    parameter resets its own).  One buffer a stream, so launches that may
    overlap never share a counter.  A captured program (jit/graphs.py)
    bakes in the buffer of its capture stream: its warm-up makes it, and
    the capture checks that this table did not change."""
    t = _TICKETS.get((dev, stream))
    if t is None:
        t = _TICKETS[(dev, stream)] = torch.zeros(MAX_PARAMS, dtype=torch.int32, device=dev)
    return t


_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_float] * 7
             + [ctypes.c_int] + [ctypes.c_void_p] * 2)


def _check(cond, msg):
    if not cond:
        raise ValueError(f"fused_adam_kernel: {msg}")


def fused_adam_kernel(params, grads, moments1, moments2, pows1, pows2, lr, coeffs, decoupled,
                      beta1, beta2, eps):
    """Launch ``csrc/fused_adam.cu`` once over up to MAX_PARAMS parameters of
    one dtype (float32, bfloat16 or float16) on one CUDA device: each
    parameter, its gradient (the same dtype) and its moments contiguous
    with as many elements, its pows f32 scalars, ``lr`` an f32 scalar on the
    device, ``coeffs`` each parameter's decay coefficient (0 for none),
    ``decoupled`` the mode (AdamW's, else Adam's L2).  Updates the
    parameters, moments and pows in place.  Raises ValueError on anything
    else.  Every launch adds one to ``fused_adam_kernel.launches``."""
    n = len(params)
    _check(0 < n <= MAX_PARAMS, f"takes 1 to {MAX_PARAMS} parameters, got {n}")
    dev, dt = params[0].device, params[0].dtype
    _check(dev.type == "cuda" and dt in TYPE_CODES,
           f"parameters must be float32, bfloat16 or float16 on CUDA, got {dt} on {dev}")
    _check(lr.device == dev and lr.dtype == torch.float32 and lr.numel() == 1,
           f"lr must be an f32 scalar on {dev}")
    ptrs = np.empty((n, 6), dtype=np.int64)
    numel = np.empty(n, dtype=np.int64)
    coeff = np.empty(n, dtype=np.float32)
    for i, (p, g, m, v, a, b) in enumerate(zip(params, grads, moments1, moments2, pows1, pows2)):
        for t in (p, g, m, v):
            _check(t.device == dev and t.dtype == dt and t.is_contiguous()
                   and t.numel() == p.numel(),
                   f"parameter {i}: p, g, m and v must be contiguous {dt} on {dev} with "
                   f"{p.numel()} elements")
        for t in (a, b):
            _check(t.device == dev and t.dtype == torch.float32 and t.numel() == 1,
                   f"parameter {i}: the pows must be f32 scalars on {dev}")
        ptrs[i] = [p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), a.data_ptr(),
                   b.data_ptr()]
        numel[i] = p.numel()
        c = float(coeffs[i])
        coeff[i] = c if decoupled or not c else _like(c, p)
    rounded = [_like(x, params[0]) for x in (beta1, 1 - beta1, beta2, 1 - beta2, eps)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _tickets(dev, stream)
    with torch.cuda.device(dev):
        _build.launch("fused_adam", _ARGTYPES, TYPE_CODES[dt], n, ptrs.ctypes.data,
                      numel.ctypes.data, coeff.ctypes.data, lr.data_ptr(), *rounded,
                      beta1, beta2, int(bool(decoupled)), tickets.data_ptr(), stream)
    _build.count(fused_adam_kernel)


fused_adam_kernel.launches = 0


@torch.no_grad()
def adam_update(items, lr, mode, beta1, beta2, eps):
    """Update ``items``, [(param, grad, state, coeff)] of one device, dtype
    and decay ``mode`` ("l2" or "decoupled"), in place: by the plain chain
    for CPU parameters, by ``fused_adam_kernel`` for CUDA ones (one launch
    per MAX_PARAMS parameters; a gradient of another dtype is cast and a
    strided one copied first, as the chain's first operation does)."""
    if items[0][0].device.type != "cuda":
        for p, g, st, coeff in items:
            adam_update_dense(p, g, st, lr, coeff, mode, beta1, beta2, eps)
        return
    for i in range(0, len(items), MAX_PARAMS):
        chunk = items[i:i + MAX_PARAMS]
        ps = [p.detach() for p, _, _, _ in chunk]
        gs = [g.to(p.dtype).contiguous() for p, g, _, _ in chunk]
        sts = [st for _, _, st, _ in chunk]
        fused_adam_kernel(ps, gs, [s["moment1"] for s in sts], [s["moment2"] for s in sts],
                          [s["beta1_pow"] for s in sts], [s["beta2_pow"] for s in sts], lr,
                          [c for _, _, _, c in chunk], mode == "decoupled", beta1, beta2, eps)
