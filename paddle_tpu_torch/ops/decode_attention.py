"""Ragged paged attention (counterpart of the paged half of
paddle_tpu/ops/decode_attention.py).

The kv cache is a global page pool [P, Hkv, page_size, D] plus per-slot page
tables [B, max_pages]; page 0 is the trash page (models/kv_cache.py).  ONE
attention entry serves every query block the paged engine produces — S = 1
decode ticks and S = C prefill chunks at any per-slot offset: query s of
slot b attends keys [0, offset[b] + s].

``paged_decode_attention`` dispatches on the tensor's device and nothing
else: a CPU tensor takes the plain version (``_paged_dense``: gather the
pages, then dense math), a CUDA tensor launches the Hopper kernel
(``csrc/paged_attention.cu``) or raises on a dtype or shape the kernel does
not take.  There is no fallback from the kernel to the plain version.  The
reference's ``off_tile`` and ``query_rows_over_vmem`` gates encode TPU
tiling and VMEM limits; the Hopper kernel takes every shape the engine
produces, so they do not apply.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

NEG_INF = -1e30

__all__ = ["gather_pages", "paged_decode_attention", "paged_attention_kernel"]


def gather_pages(pool, page_tbl):
    """[P, H, ps, D] pool + [B, M] table -> contiguous [B, H, M*ps, D]
    (scale pools [P, H, ps] -> [B, H, M*ps]).  The plain version's view of
    the paged cache; also the test oracle."""
    g = pool[page_tbl.long()]  # [B, M, H, ps, ...]
    if g.dim() == 5:
        B, M, H, ps, D = g.shape
        return g.permute(0, 2, 1, 3, 4).reshape(B, H, M * ps, D)
    B, M, H, ps = g.shape
    return g.permute(0, 2, 1, 3).reshape(B, H, M * ps)


def _offsets(offset, B, device):
    """Scalar or per-slot [B] offset -> int64 [B] tensor on ``device``."""
    off = torch.as_tensor(offset, device=device)
    return off.to(torch.int64).expand(B) if off.dim() == 0 else off.to(torch.int64)


def _decode_dense(q, k, v, offset, k_scale, v_scale, scale):
    """Dense attention of q [B, S, H, D] against head-major k/v [B, Hkv, L, D]
    whose first offset + s + 1 rows are visible to query s (the reference's
    ``_decode_dense``, offset path)."""
    B, S, H, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    rep = H // Hkv
    if k_scale is not None:
        k = k.to(q.dtype) * k_scale.to(q.dtype)[..., None]
        v = v.to(q.dtype) * v_scale.to(q.dtype)[..., None]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bshd,bhld->bhsl", q, k).float() * scale
    kpos = torch.arange(L, device=q.device)[None, None, None, :]
    qpos = (_offsets(offset, B, q.device)[:, None, None, None]
            + torch.arange(S, device=q.device)[None, None, :, None])
    s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhsl,bhld->bshd", p, v)


def _paged_dense(q, k_pages, v_pages, offset, page_tbl, k_scale, v_scale,
                 scale):
    """Plain version: gather each slot's pages into a contiguous view, then
    the dense math.  The gather is capped at the batch-max logical length
    (no slot has valid keys past max(offset) + S)."""
    S, M, ps = q.shape[1], page_tbl.shape[1], k_pages.shape[2]
    off = _offsets(offset, q.shape[0], q.device)
    used = min(M, -(-(int(off.max()) + S) // ps))
    page_tbl = page_tbl[:, :max(used, 1)]
    scales = ((None, None) if k_scale is None else
              (gather_pages(k_scale, page_tbl), gather_pages(v_scale, page_tbl)))
    return _decode_dense(q, gather_pages(k_pages, page_tbl),
                         gather_pages(v_pages, page_tbl), off, *scales, scale)


_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = _build.load("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        lib.paged_attention_launch.argtypes = _ARGTYPES
        lib.paged_attention_launch.restype = ctypes.c_int
        lib.paged_attention_error_string.argtypes = [ctypes.c_int]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond, msg):
    if not cond:
        raise ValueError(f"paged attention kernel: {msg}")


def paged_attention_kernel(q, k_pages, v_pages, lengths, page_tbl,
                           k_scale=None, v_scale=None, scale=None):
    """Launch ``csrc/paged_attention.cu`` on CUDA tensors.

    q [B, S, H, D] bf16; pools [P, Hkv, ps, D] bf16, or int8 with f32 scale
    pools [P, Hkv, ps]; lengths [B] (= offset + S); page_tbl [B, M]; D = 128.
    Returns [B, S, H, D] bf16.  Raises ValueError on anything else.  Every
    launch adds one to ``paged_attention_kernel.launches``."""
    B, S, H, D = q.shape
    P, Hkv, ps = k_pages.shape[:3]
    quant = k_scale is not None
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    _check(q.dtype == torch.bfloat16, f"q dtype {q.dtype}, need bfloat16")
    _check(D == 128, f"head dim {D}, the kernel is built for 128")
    _check(Hkv > 0 and H % Hkv == 0, f"H={H} is not a multiple of Hkv={Hkv}")
    want = torch.int8 if quant else torch.bfloat16
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == want, f"{name} dtype {t.dtype}, need {want}")
        _check(tuple(t.shape) == (P, Hkv, ps, D),
               f"{name} shape {tuple(t.shape)}, need {(P, Hkv, ps, D)}")
        _check(t.is_contiguous() and t.data_ptr() % 16 == 0,
               f"{name} must be contiguous and 16-byte aligned")
    if quant:
        _check(v_scale is not None, "k_scale given without v_scale")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t.device == dev and t.dtype == torch.float32
                   and tuple(t.shape) == (P, Hkv, ps) and t.is_contiguous(),
                   f"{name} must be contiguous float32 {(P, Hkv, ps)} on {dev}")
    _check(page_tbl.dim() == 2 and page_tbl.shape[0] == B,
           f"page_tbl shape {tuple(page_tbl.shape)}, need ({B}, M)")
    _check(page_tbl.device == dev and lengths.device == dev,
           "lengths and page_tbl must be on q's device")
    _check(lengths.shape == (B,), f"lengths shape {tuple(lengths.shape)}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q = q.contiguous()
    page_tbl = page_tbl.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            lengths.data_ptr(), page_tbl.data_ptr(), out.data_ptr(),
            B, S, H, Hkv, D, ps, page_tbl.shape[1], float(scale), int(quant),
            stream)
    if err != 0:
        raise RuntimeError("paged attention kernel launch failed: "
                           + lib.paged_attention_error_string(err).decode())
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0


def paged_decode_attention(q, k_pages, v_pages, offset, page_tbl,
                           k_scale=None, v_scale=None, scale=None):
    """Attention of q [B, S, H, D] against a PAGED cache: pool
    [P, Hkv, page_size, D] + page table [B, max_pages], with the first
    offset + s + 1 positions of each slot visible to query position s
    (offset a scalar or a per-slot [B] vector).  int8 pools pass
    per-(head, token) scale pools [P, Hkv, page_size].  CPU tensors take the
    plain version; CUDA tensors the Hopper kernel.  Returns [B, S, H, D] in
    q's dtype."""
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return _paged_dense(q, k_pages, v_pages, offset, page_tbl, k_scale,
                            v_scale, scale)
    lengths = (_offsets(offset, B, q.device) + S).to(torch.int32)
    return paged_attention_kernel(q, k_pages, v_pages, lengths, page_tbl,
                                  k_scale, v_scale, scale)
