"""Decode attention over static and paged kv caches (counterpart of
paddle_tpu/ops/decode_attention.py).

Two cache layouts, one attention contract: query position s of slot b
attends the first offset[b] + s + 1 positions of its cache (offset a scalar
or a per-slot [B] vector), and query head h reads kv head h // (H / Hkv).
- STATIC: head-major k/v [B, Hkv, L, D] (int8 with f32 scales [B, Hkv, L]),
  the layout of generate() and the dense engine: ``decode_attention``.
- PAGED: a global page pool [P, Hkv, page_size, D] plus per-slot page
  tables [B, max_pages]; page 0 is the trash page (models/kv_cache.py):
  ``paged_decode_attention``.  One entry serves every query block the
  paged engine produces, S = 1 decode ticks and S = C prefill chunks.

Both dispatch on the tensor's device first: a CPU tensor takes the plain
version (``_decode_dense``; ``_paged_dense`` gathers the pages first), a
CUDA tensor launches a Hopper kernel or raises on a dtype or shape no
kernel takes.  On the card every (q, cache) type pair of
``_admit.KV_PAIRS`` runs ``csrc/decode_attention.cu`` and
``csrc/paged_attention.cu`` on the tensor cores: bfloat16 q against
bfloat16 or int8 caches, float32 q against float32 or int8, float16 q
against float16, float32 (a float16 model's engines) or int8; float32
operands as split-bf16 products (``csrc/kv_attention.cuh``).  Nothing is
cast to reach a kernel, and there is no fallback from a kernel to a plain
version.  The reference's gates encode TPU measurements and tiling, so they
are not copied: its ``B*H <= 192`` static-kernel gate (a v5e timing) and
its ``off_tile`` / ``query_rows_over_vmem`` paged gates.  Both Hopper
kernels take every shape the engines produce, S > 1 included (per-row
causal ends), at head dims 64, 128 and 256 (others raise: ROADMAP Queue 2,
item 9).

The kernels run in two regimes on rows = S * (H / Hkv): up to 16 rows
(decode ticks) split the keys into ``_split_plan``'s splits, fixed by the
capacity and never by the lengths, and the last split of each (kv head,
slot) merges the partials in split order within the launch; more rows
(prefill chunks) run in ``wgmma`` tiles of 128 rows (64 at head dim 256
where q or the cache is split into planes).  ``_split_merge_dense`` is the
plain model of that merge and of the kernels' rounding, for the tests and
chip_smoke.py.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _admit, _build

NEG_INF = -1e30
# The head dims the kernels are built for, their key tile, and the most
# query rows of one kv head (S * H / Hkv) the split-K decode regime takes.
KV_HEAD_DIMS = _admit.KV_DIMS
KEY_TILE = 64
DECODE_ROWS = 16
# Decode regime: split the keys until the grid holds about this many blocks
# a SM (two rounds of the two that fit a SM at D <= 128), in at most
# MAX_SPLITS splits (the kernel's kMaxSplits).
BLOCKS_PER_SM = 4
MAX_SPLITS = 64

__all__ = ["KV_HEAD_DIMS", "decode_attention", "decode_attention_kernel", "gather_pages",
           "paged_decode_attention", "paged_attention_kernel"]


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
    ``_decode_dense``, offset path).  A float16 q meets float32 caches in
    the engines of a float16 model: the math runs in the promoted type, p
    in v's type as the reference kernel rounds it, the output in q's."""
    B, S, H, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    rep = H // Hkv
    if k_scale is not None:
        k = k.to(q.dtype) * k_scale.to(q.dtype)[..., None]
        v = v.to(q.dtype) * v_scale.to(q.dtype)[..., None]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    ct = torch.promote_types(q.dtype, k.dtype)
    s = torch.einsum("bshd,bhld->bhsl", q.to(ct), k.to(ct)).float() * scale
    kpos = torch.arange(L, device=q.device)[None, None, None, :]
    qpos = (_offsets(offset, B, q.device)[:, None, None, None]
            + torch.arange(S, device=q.device)[None, None, :, None])
    s = torch.where(kpos <= qpos, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(ct)
    return torch.einsum("bhsl,bhld->bshd", p, v.to(ct)).to(q.dtype)


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


def _split_plan(B, Hkv, cap, sms):
    """(splits, keys a split) of the decode regime for a cache of ``cap``
    keys a slot: enough whole-tile splits that B * Hkv * splits blocks
    fill ``sms`` SMs about twice over, from the capacity alone (the host
    never reads the lengths, which would sync every tick)."""
    tiles = -(-cap // KEY_TILE)
    want = max(1, min(tiles, MAX_SPLITS, -(-BLOCKS_PER_SM * sms // (B * Hkv))))
    split_keys = -(-tiles // want) * KEY_TILE
    return -(-cap // split_keys), split_keys


def _split_merge_dense(q, k, v, offset, k_scale, v_scale, scale, split_keys):
    """Plain model of the kernels' arithmetic over a head-major cache
    k/v [B, Hkv, L, D] (a paged cache gathered by ``gather_pages``): the
    decode regime's split-K, each split of ``split_keys`` keys keeping its
    own (m, l, acc) per query row, with p = 0 where no key of the split is
    visible (m stays NEG_INF), the int8 k-scales on the scores after the dot
    and the v-scales on p after l; the partials then merge in split order,
    and a row that sees no key at all gives zeros.  Scores and products run
    in f32 on the stored values; p is rounded to v's dtype, or to bfloat16
    for an int8 cache whatever q's dtype (the reference widens int8 to
    bfloat16).  Returns [B, S, H, D] in q's dtype."""
    B, S, H, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    rep = H // Hkv
    p_dtype = torch.bfloat16 if k_scale is not None else v.dtype
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf, vf = kf.repeat_interleave(rep, dim=1), vf.repeat_interleave(rep, dim=1)
    s = torch.einsum("bshd,bhld->bhsl", q.float(), kf) * scale
    if k_scale is not None:
        s = s * k_scale.float().repeat_interleave(rep, dim=1)[:, :, None, :]
    kpos = torch.arange(L, device=q.device)[None, None, None, :]
    qpos = (_offsets(offset, B, q.device)[:, None, None, None]
            + torch.arange(S, device=q.device)[None, None, :, None])
    visible = kpos <= qpos
    s = torch.where(visible, s, torch.full_like(s, NEG_INF))
    parts = []
    for k0 in range(0, L, split_keys):
        sl = slice(k0, k0 + split_keys)
        m = s[..., sl].amax(-1, keepdim=True)
        p = torch.where(visible[..., sl], torch.exp(s[..., sl] - m), torch.zeros_like(m))
        l = p.sum(-1, keepdim=True)
        if v_scale is not None:
            p = p * v_scale.float().repeat_interleave(rep, dim=1)[:, :, None, sl]
        acc = torch.einsum("bhsl,bhld->bhsd", p.to(p_dtype).float(), vf[:, :, sl])
        parts.append((m, l, acc))
    m_all = torch.stack([m for m, _, _ in parts])
    top = m_all.amax(0)
    top = torch.where(top == NEG_INF, torch.zeros_like(top), top)
    w = torch.where(m_all == NEG_INF, torch.zeros_like(m_all), torch.exp(m_all - top))
    l_tot = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    o = sum(wi * acc for wi, (_, _, acc) in zip(w, parts))
    o = o / torch.where(l_tot <= 0, torch.ones_like(l_tot), l_tot)
    return o.transpose(1, 2).to(q.dtype)


def _check(cond, msg):
    if not cond:
        raise ValueError(f"attention kernel: {msg}")


def _check_kv(q, k, v, k_scale, v_scale, kv_shape, regime):
    """Shared checks of the kv-cache kernels: a (q, kv) type pair and head
    dim ``_admit.admit`` admits, q [B, S, H, D] on CUDA, k/v contiguous
    ``kv_shape`` of one dtype, int8 with contiguous f32 scales of
    ``kv_shape[:3]``.  Returns (q contiguous, quant)."""
    H, D = q.shape[2:]
    Hkv = kv_shape[1]
    _check(Hkv > 0 and H % Hkv == 0, f"H={H} is not a multiple of Hkv={Hkv}")
    _admit.admit(regime, q.dtype, k.dtype, D)
    quant = k_scale is not None
    dev = q.device
    _check(dev.type == "cuda", f"q is on {dev}, not a CUDA device")
    _check(quant == (k.dtype == torch.int8),
           "int8 caches take k_scale and v_scale, other caches neither")
    for name, t in (("k", k), ("v", v)):
        _check(t.device == dev, f"{name} on {t.device}, q on {dev}")
        _check(t.dtype == k.dtype, f"{name} dtype {t.dtype}, k is {k.dtype}")
        _check(tuple(t.shape) == tuple(kv_shape),
               f"{name} shape {tuple(t.shape)}, need {tuple(kv_shape)}")
        _check(t.is_contiguous() and t.data_ptr() % 16 == 0,
               f"{name} must be contiguous and 16-byte aligned")
    if quant:
        _check(v_scale is not None, "k_scale given without v_scale")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            _check(t.device == dev and t.dtype == torch.float32
                   and tuple(t.shape) == tuple(kv_shape[:3]) and t.is_contiguous(),
                   f"{name} must be contiguous float32 {tuple(kv_shape[:3])} on {dev}")
    return q.contiguous(), quant


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS = {}


def _tickets(dev, stream, n):
    """The split-K merge's ticket counters for launches on ``stream`` of
    ``dev``: int32, at least n, zero between launches (the last block of
    each (kv head, slot) resets its own).  One buffer a stream, so launches
    that may overlap never share a counter; grown, never shrunk."""
    t = _TICKETS.get((dev, stream))
    if t is None or t.numel() < n:
        t = _TICKETS[(dev, stream)] = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
    return t


def _workspace(q, Hkv, cap, stream):
    """(part, ticket, splits, split_keys) of one launch: the decode regime's
    split plan and, when it splits, the partials from the caching allocator
    (f32 [splits * B * Hkv * 16 * (D + 2)]) and the ticket counters."""
    B, S, H, D = q.shape
    if S * (H // Hkv) > DECODE_ROWS:  # chunk regime: no split
        return None, None, 1, -(-cap // KEY_TILE) * KEY_TILE
    splits, split_keys = _split_plan(B, Hkv, cap, _sm_count(q.device.index))
    if splits == 1:
        return None, None, 1, split_keys
    part = torch.empty(splits * B * Hkv * DECODE_ROWS * (D + 2), dtype=torch.float32,
                       device=q.device)
    return (part.data_ptr(), _tickets(q.device, stream, B * Hkv).data_ptr(), splits,
            split_keys)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_PAGED_ARGS = [_PTR] * 10 + [_INT] * 8 + [ctypes.c_float] + [_INT] * 4 + [_PTR]
_DECODE_ARGS = [_PTR] * 9 + [_INT] * 6 + [ctypes.c_float] + [_INT] * 4 + [_PTR]


def _types(q, k):
    """The (q, kv) type codes the C entries take (kv_attention.cuh KV_TYPES)."""
    return _admit.KV_TYPE_CODES[q.dtype], _admit.KV_TYPE_CODES[k.dtype]


def paged_attention_kernel(q, k_pages, v_pages, lengths, page_tbl,
                           k_scale=None, v_scale=None, scale=None):
    """Launch ``csrc/paged_attention.cu`` on CUDA tensors.

    q [B, S, H, D] bfloat16, float16 or float32; pools [P, Hkv, ps, D] of a
    type ``_admit.KV_PAIRS`` pairs with q's (int8 with f32 scale pools
    [P, Hkv, ps]); lengths [B] (= offset + S); page_tbl [B, M]; D in
    KV_HEAD_DIMS.  Returns [B, S, H, D] in q's dtype.  Raises ValueError on
    anything else.  Every launch adds one to
    ``paged_attention_kernel.launches``."""
    B, S, H, D = q.shape
    P, Hkv, ps = k_pages.shape[:3]
    q, quant = _check_kv(q, k_pages, v_pages, k_scale, v_scale, (P, Hkv, ps, D), "paged")
    dev = q.device
    _check(page_tbl.dim() == 2 and page_tbl.shape[0] == B,
           f"page_tbl shape {tuple(page_tbl.shape)}, need ({B}, M)")
    _check(page_tbl.device == dev and lengths.device == dev,
           "lengths and page_tbl must be on q's device")
    _check(lengths.shape == (B,), f"lengths shape {tuple(lengths.shape)}")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    page_tbl = page_tbl.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    M = page_tbl.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        part, ticket, splits, split_keys = _workspace(q, Hkv, M * ps, stream)
        _build.launch("paged_attention", _PAGED_ARGS, q.data_ptr(), k_pages.data_ptr(),
                      v_pages.data_ptr(), k_scale.data_ptr() if quant else None,
                      v_scale.data_ptr() if quant else None, lengths.data_ptr(),
                      page_tbl.data_ptr(), out.data_ptr(), part, ticket, B, S, H, Hkv, D, P, ps,
                      M, float(scale), *_types(q, k_pages), splits, split_keys, stream)
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0


def decode_attention_kernel(q, k, v, lengths, k_scale=None, v_scale=None,
                            scale=None):
    """Launch ``csrc/decode_attention.cu`` on CUDA tensors.

    q [B, S, H, D] bfloat16, float16 or float32; head-major caches k/v
    [B, Hkv, L, D] of a type ``_admit.KV_PAIRS`` pairs with q's (int8 with
    f32 scales [B, Hkv, L]); lengths [B] (= offset + S); D in KV_HEAD_DIMS.
    Returns [B, S, H, D] in q's dtype.  Raises ValueError on anything else.
    Every launch adds one to ``decode_attention_kernel.launches``."""
    B, S, H, D = q.shape
    Hkv, L = k.shape[1], k.shape[2]
    q, quant = _check_kv(q, k, v, k_scale, v_scale, (B, Hkv, L, D), "decode")
    dev = q.device
    _check(lengths.device == dev and lengths.shape == (B,),
           f"lengths must be [{B}] on q's device")
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        part, ticket, splits, split_keys = _workspace(q, Hkv, L, stream)
        _build.launch("decode_attention", _DECODE_ARGS, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      k_scale.data_ptr() if quant else None,
                      v_scale.data_ptr() if quant else None, lengths.data_ptr(), out.data_ptr(),
                      part, ticket, B, S, H, Hkv, D, L, float(scale), *_types(q, k), splits,
                      split_keys, stream)
    decode_attention_kernel.launches += 1
    return out


decode_attention_kernel.launches = 0


def decode_attention(q, k, v, offset, k_scale=None, v_scale=None, scale=None):
    """Attention of q [B, S, H, D] against a head-major STATIC cache
    k/v [B, Hkv, L, D] whose first offset + s + 1 positions are visible to
    query position s (offset a scalar or a per-slot [B] vector).  int8
    caches pass per-(head, token) scales [B, Hkv, L].  CPU tensors take the
    plain version; CUDA tensors the Hopper kernel.  Returns [B, S, H, D]
    in q's dtype."""
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return _decode_dense(q, k, v, offset, k_scale, v_scale, scale)
    lengths = (_offsets(offset, B, q.device) + S).to(torch.int32)
    return decode_attention_kernel(q, k, v, lengths, k_scale, v_scale, scale)


def paged_decode_attention(q, k_pages, v_pages, offset, page_tbl,
                           k_scale=None, v_scale=None, scale=None):
    """Attention of q [B, S, H, D] against a PAGED cache: pool
    [P, Hkv, page_size, D] + page table [B, max_pages], with the first
    offset + s + 1 positions of each slot visible to query position s
    (offset a scalar or a per-slot [B] vector).  int8 pools pass
    per-(head, token) scale pools [P, Hkv, page_size].  CPU tensors take the
    plain version; CUDA tensors the Hopper kernel.  Returns [B, S, H, D]
    in q's dtype."""
    B, S, H, D = q.shape
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    if q.device.type == "cpu":
        return _paged_dense(q, k_pages, v_pages, offset, page_tbl, k_scale,
                            v_scale, scale)
    lengths = (_offsets(offset, B, q.device) + S).to(torch.int32)
    return paged_attention_kernel(q, k_pages, v_pages, lengths, page_tbl, k_scale, v_scale,
                                  scale)
