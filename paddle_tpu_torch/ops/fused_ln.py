"""Fused dropout + residual add + LayerNorm, forward and backward
(counterpart of paddle_tpu/ops/fused_ln.py).

``fused_dropout_add_layer_norm(branch, residual, gamma, beta, seed, rate,
eps, upscale)`` returns LayerNorm(residual + dropout(branch)) over the last
dimension, with the reference kernel's numerics: s = residual +
where(keep, branch / (1 - rate), 0) in f32, rounded to the residual's dtype;
two-pass f32 statistics on the rounded s; out = (s - mean) rstd gamma +
beta in f32, rounded.  It is a ``torch.autograd.Function`` that saves only
s, gamma and the seed pair, as the reference does: the backward recomputes
the statistics from s and regenerates the mask from the seed, and gives
dbranch, dresidual and per-team dgamma/dbeta partials summed outside the
kernel.  The mask is Philox (``ops/_prng.py``: element (row, col) reads
counter (col >> 2, row, 0, 0), word col & 3), not the TPU's bits.

``supported(n, h)`` is the reference's admission (h % 128 == 0 up to
32768), which decides the routing of
``nn.functional.fused_dropout_add_layer_norm``.  A CPU tensor takes the
plain versions (``_fused_ln_dense``, ``_fused_ln_bwd_dense``); a CUDA tensor
launches ``csrc/fused_ln.cu`` (float32, bfloat16 or float16, the
reference's kernels typing their outputs by their input) at every admitted
shape, on the plan ``_plan`` gives, or raises ValueError.

The kernels replace the reference's ``_fwd_kernel`` (paddle_tpu/ops/
fused_ln.py:55) and ``_bwd_kernel`` (:77).  Both are bound by bytes: two
[n, h] tensors read and two written, 0.120 ms at the ERNIE shape (n 65,536,
h 768, bf16) and 0.160 ms at h 4096 (n 16,384) or h 32768 (n 2,048) on the
H100's 3.35 TB/s.  Up to h = 1024 the forward keeps one row in a warp's
registers; the backward runs persistent blocks whose warps stream rows
through rings in shared memory fed by bulk copies, so the next rows' bytes
are in flight while a warp reduces the current one.  Above 1024 a team of
1 to 8 blocks (a thread block cluster) shares each row, with cross-block
sums through distributed shared memory (``csrc/fused_ln.cu`` says more).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from ._prng import fused_ln_bits, keep_mask, launch_args

__all__ = ["fused_dropout_add_layer_norm", "fused_ln_kernel", "fused_ln_bwd_kernel",
           "supported"]

NARROW_MAX_H = 1024  # up to here a row is one warp's (csrc/fused_ln.cu narrow kernels)
BWD_ROWS = 8         # narrow backward: the rows a team (a block, a row a warp) takes at a time
BLOCK_THREADS = 256  # threads a block: 8 warps (narrow), at most (wide)
WIDE_VALUES = 16     # wide kernels: values of a tensor a thread holds
CLUSTERS = (1, 2, 4, 8)
# csrc/fused_ln.cu FUSED_LN_TYPES: the element types and their type codes
TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class _Plan(NamedTuple):
    """What a call runs: ``wide`` or not; ``k`` = h / 128 (narrow) or the
    16-byte pieces a thread holds (wide); ``cl`` blocks a team (a thread
    block cluster); ``threads`` a block; ``rows`` a team takes at a time
    (its rows are those with (row // rows) % teams == team)."""
    wide: bool
    k: int
    cl: int
    threads: int
    rows: int


def _plan(h, dtype):
    """The kernels' plan for rows of h (a multiple of 128 up to 32768) of
    ``dtype`` (a key of TYPE_CODES).  Narrow up to h = 1024.  Wide: 16-byte
    pieces of V = 8 (bfloat16, float16: the same plan) or 4 (float32)
    values, the fewest blocks a team (1, 2, 4, 8) whose slices fit
    BLOCK_THREADS threads of at most WIDE_VALUES values, then the fewest
    pieces a thread.  ``csrc/fused_ln.cu`` instantiates exactly these
    (tests/test_torch_fused_ln.py holds the two lists together)."""
    if h <= NARROW_MAX_H:
        return _Plan(False, h // 128, 1, BLOCK_THREADS, BWD_ROWS)
    v = 128 // torch.finfo(dtype).bits
    pieces = h // v
    kmax = WIDE_VALUES // v
    cl = next(c for c in CLUSTERS if -(-pieces // c) <= BLOCK_THREADS * kmax)
    per = -(-pieces // cl)
    k = next(k for k in (1, 2, 4) if -(-per // k) <= BLOCK_THREADS)
    return _Plan(True, k, cl, 32 * -(-per // (32 * k)), 1)


def _pick_bn(n, h):
    """The reference's row block: the largest of 512 .. 8 that divides n
    within its VMEM budget (only ``supported`` reads it)."""
    budget = 256 * 1024
    for bn in (512, 256, 128, 64, 32, 16, 8):
        if n % bn == 0 and bn * h <= budget:
            return bn
    return None


def supported(n, h):
    """The reference's admission: h % 128 == 0 and rows that split into a
    block of 8 .. 512."""
    return h % 128 == 0 and _pick_bn(n, h) is not None


def _scale(rate, upscale):
    return 1.0 / (1.0 - rate) if upscale else 1.0


def dropout_keep(seed, n, h, rate):
    """The keep mask [n, h] of a call with this seed and rate (the kernels'
    bits, ops/_prng.py)."""
    return keep_mask(fused_ln_bits(seed, n, h), rate)


def _stats(s, eps):
    mean = s.mean(-1, keepdim=True)
    c = s - mean
    return mean, torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)


def _fused_ln_dense(x, y, gamma, beta, seed, rate, eps, upscale, keep=None):
    """Plain forward on x (residual) and y (branch) [n, h]: (out, s), both
    in x's dtype, in the reference kernel's order.  ``keep`` overrides the
    seed's mask."""
    yf = y.float()
    if rate > 0.0:
        keep = dropout_keep(seed, *x.shape, rate) if keep is None else keep
        yf = torch.where(keep, yf * _scale(rate, upscale), 0.0)
    s = (x.float() + yf).to(x.dtype)
    sf = s.float()
    mean, rstd = _stats(sf, eps)
    out = (sf - mean) * rstd * gamma.float() + beta.float()
    return out.to(x.dtype), s


def _fused_ln_bwd_dense(s, gamma, dz, seed, rate, eps, upscale, keep=None, teams=None,
                        rows=BWD_ROWS):
    """Plain backward: (dx, dy, dgamma partials, dbeta partials), dx and dy
    in s's dtype, the partials f32 [teams, h] as the kernel's: team t sums
    the rows with (row // rows) % teams == t (``_team_partials``).
    ``teams`` defaults to one per 128 rows.  ``keep`` overrides the seed's
    mask."""
    n, h = s.shape
    sf = s.float()
    mean, rstd = _stats(sf, eps)
    xhat = (sf - mean) * rstd
    dzf = dz.float()
    dxhat = dzf * gamma.float()
    a = dxhat.mean(-1, keepdim=True)
    b = (dxhat * xhat).mean(-1, keepdim=True)
    ds = rstd * (dxhat - a - xhat * b)
    dy = ds
    if rate > 0.0:
        keep = dropout_keep(seed, n, h, rate) if keep is None else keep
        dy = torch.where(keep, ds * _scale(rate, upscale), 0.0)
    teams = -(-n // 128) if teams is None else teams
    return (ds.to(s.dtype), dy.to(s.dtype), _team_partials(dzf * xhat, teams, rows),
            _team_partials(dzf, teams, rows))


def _team_partials(t, teams, rows):
    """[teams, h]: team k's row sums the rows r of t with (r // rows) %
    teams == k, the kernels' assignment (a narrow block's 8 warps take 8
    rows at a time, a wide team one)."""
    n, h = t.shape
    sweep = teams * rows
    sweeps = -(-n // sweep)
    t = torch.nn.functional.pad(t, (0, 0, 0, sweeps * sweep - n))
    return t.reshape(sweeps, teams, rows, h).sum((0, 2))


def _check(cond, msg):
    if not cond:
        raise ValueError(f"fused_ln kernel: {msg}")


def _kernel_inputs(tensors, gamma):
    """The kernels' admission: CUDA, one dtype of TYPE_CODES (float32,
    bfloat16, float16) for the [n, h] tensors, a shape ``supported``
    admits, 16-byte aligned storage.
    Returns the tensors made contiguous and gamma (and beta) as f32."""
    first = next(iter(tensors.values()))
    n, h = first.shape
    dev = first.device
    _check(first.dtype in TYPE_CODES, f"dtype {first.dtype}, need float32, bfloat16 or float16")
    _check(dev.type == "cuda", f"input is on {dev}, not a CUDA device")
    for name, t in tensors.items():
        _check(t.device == dev and t.dtype == first.dtype and tuple(t.shape) == (n, h),
               f"{name}: {t.device} {t.dtype} {tuple(t.shape)}, need {dev} "
               f"{first.dtype} {(n, h)}")
    _check(supported(n, h), f"rows {n} x h {h} outside the reference's admission "
           "(h % 128 == 0, rows in blocks of 8..512 of at most 256K elements)")
    for name, t in gamma.items():
        _check(t is not None and t.device == dev and tuple(t.shape) == (h,),
               f"{name} must be a [{h}] tensor on {dev}")
    out = [t.contiguous() for t in tensors.values()]
    aff = [t.detach().float().contiguous() for t in gamma.values()]
    _check(all(t.data_ptr() % 16 == 0 for t in out + aff), "storage not 16-byte aligned")
    return out, aff


_TEAMS = {}


def _teams(bwd, n, h, type_code, plan, device):
    """The persistent grid of a launch: the teams that run on the card at
    once (``fused_ln_teams``, cached per device and plan), at most one per
    ``plan.rows`` rows; 0 for the narrow forward (a block per 8 rows)."""
    key = (bwd, h, type_code, device.index)
    cap = _TEAMS.get(key)
    if cap is None:
        lib = _build.load("fused_ln")
        fn, msg = lib.fused_ln_teams, lib.fused_ln_error_string
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        msg.argtypes, msg.restype = [ctypes.c_int], ctypes.c_char_p
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(int(bwd), h, type_code, plan.k, plan.cl, plan.threads, ctypes.byref(out))
        if err:
            raise RuntimeError(f"fused_ln_teams failed: {msg(err).decode()}")
        cap = _TEAMS[key] = out.value
    return min(cap, -(-n // plan.rows))


_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
    ctypes.c_uint32, ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_ln_kernel(x, y, gamma, beta, seed, rate, eps, upscale=True):
    """Launch ``fused_ln_fwd`` of ``csrc/fused_ln.cu`` on CUDA tensors: x
    (residual) and y (branch) [n, h], gamma and beta [h], seed int32 [2]
    (read when rate > 0).  Returns (out, s) [n, h] in x's dtype.  Raises
    ValueError on anything else.  Every launch adds one to
    ``fused_ln_kernel.launches``."""
    (x, y), (g, b) = _kernel_inputs({"x": x, "y": y}, {"gamma": gamma, "beta": beta})
    n, h = x.shape
    code = TYPE_CODES[x.dtype]
    plan = _plan(h, x.dtype)
    teams = _teams(False, n, h, code, plan, x.device)
    sp, thresh, scale = launch_args(seed, rate, _scale(rate, upscale), x.device)
    out, s = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch("fused_ln", _FWD_ARGS, x.data_ptr(), y.data_ptr(), g.data_ptr(),
                      b.data_ptr(), sp, out.data_ptr(), s.data_ptr(), n, h, code, thresh,
                      float(scale), float(eps), plan.k, plan.cl, plan.threads, teams,
                      torch.cuda.current_stream(x.device).cuda_stream, entry="fused_ln_fwd")
    _build.count(fused_ln_kernel)
    return out, s


fused_ln_kernel.launches = 0

_BWD_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
    ctypes.c_uint32, ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def fused_ln_bwd_kernel(s, gamma, dz, seed, rate, eps, upscale=True):
    """Launch ``fused_ln_bwd`` of ``csrc/fused_ln.cu`` on CUDA tensors: s
    and dz [n, h], gamma [h], seed as the forward's.  Returns (dx, dy,
    dgamma partials, dbeta partials): dx and dy [n, h] in s's dtype, the
    partials f32 [teams, h], team t's row the sum over the rows with (row
    // _plan(h, ...).rows) % teams == t (``_team_partials``).  Every launch
    adds one to ``fused_ln_bwd_kernel.launches``."""
    (s, dz), (g,) = _kernel_inputs({"s": s, "dz": dz}, {"gamma": gamma})
    n, h = s.shape
    code = TYPE_CODES[s.dtype]
    plan = _plan(h, s.dtype)
    teams = _teams(True, n, h, code, plan, s.device)
    sp, thresh, scale = launch_args(seed, rate, _scale(rate, upscale), s.device)
    dx, dy = torch.empty_like(s), torch.empty_like(s)
    dgp = torch.empty(teams, h, dtype=torch.float32, device=s.device)
    dbp = torch.empty_like(dgp)
    with torch.cuda.device(s.device):
        _build.launch("fused_ln", _BWD_ARGS, s.data_ptr(), g.data_ptr(), dz.data_ptr(), sp,
                      dx.data_ptr(), dy.data_ptr(), dgp.data_ptr(), dbp.data_ptr(), n, h,
                      code, thresh, float(scale), float(eps), plan.k, plan.cl,
                      plan.threads, teams, torch.cuda.current_stream(s.device).cuda_stream,
                      entry="fused_ln_bwd")
    _build.count(fused_ln_bwd_kernel)
    return dx, dy, dgp, dbp


fused_ln_bwd_kernel.launches = 0


def philox_kernel(words):
    """Philox4x32-10 on the card (``philox_launch`` of ``csrc/fused_ln.cu``):
    words int32 [m, 6] (counter c0..c3, key k0, k1) -> int32 [m, 4]; for the
    known-answer check."""
    words = words.contiguous()
    _check(words.is_cuda and words.dtype == torch.int32 and words.shape[-1] == 6,
           "philox_kernel takes int32 [m, 6] on a CUDA device")
    out = torch.empty(words.shape[0], 4, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        _build.launch("fused_ln", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p],
                      words.data_ptr(), out.data_ptr(), words.shape[0],
                      torch.cuda.current_stream(words.device).cuda_stream, entry="philox")
    return out


class _FusedLN(torch.autograd.Function):
    """Saves only s, gamma and the seed pair."""

    @staticmethod
    def forward(ctx, x, y, gamma, beta, seed, rate, eps, upscale):
        if x.device.type == "cpu":
            out, s = _fused_ln_dense(x, y, gamma, beta, seed, rate, eps, upscale)
        else:
            out, s = fused_ln_kernel(x, y, gamma, beta, seed, rate, eps, upscale)
        ctx.save_for_backward(s, gamma, seed)
        ctx.rate, ctx.eps, ctx.upscale = rate, eps, upscale
        return out

    @staticmethod
    def backward(ctx, dz):
        s, gamma, seed = ctx.saved_tensors
        args = (s, gamma, dz.contiguous(), seed, ctx.rate, ctx.eps, ctx.upscale)
        if s.device.type == "cpu":
            dx, dy, dgp, dbp = _fused_ln_bwd_dense(*args)
        else:
            dx, dy, dgp, dbp = fused_ln_bwd_kernel(*args)
        return (dx, dy, dgp.sum(0).to(gamma.dtype), dbp.sum(0).to(gamma.dtype),
                None, None, None, None)


def fused_dropout_add_layer_norm(branch, residual, gamma, beta, seed, rate=0.0,
                                 eps=1e-12, upscale=True):
    """out = LayerNorm(residual + dropout(branch)) over the last dim, the
    reference's argument order: ``branch`` is dropped, ``residual`` kept.
    branch/residual [..., h]; gamma/beta [h]; seed int32 [2] (read only at
    rate > 0).  Raises ValueError on a shape ``supported`` rejects and on
    rate >= 1."""
    shape = branch.shape
    h = shape[-1]
    n = 1
    for d in shape[:-1]:
        n *= d
    if not supported(n, h):
        raise ValueError(
            f"fused_dropout_add_layer_norm: shape rows={n} h={h} not tileable "
            "(h must be a multiple of 128 and rows divisible by a block size "
            "of 8..512) - check ops.fused_ln.supported(n, h) and fall back to "
            "the composed nn.functional path")
    if rate >= 1.0:
        raise ValueError("fused_dropout_add_layer_norm requires rate < 1 "
                         "(rate>=1 drops the whole branch; compute LN(residual) "
                         "directly instead)")
    if seed is None:
        seed = torch.zeros(2, dtype=torch.int32, device=residual.device)
    out = _FusedLN.apply(residual.reshape(n, h), branch.reshape(n, h), gamma, beta, seed,
                         float(rate), float(eps), bool(upscale))
    return out.reshape(shape)
