"""Static and paged kv-cache layouts (counterpart of
paddle_tpu/models/kv_cache.py).

Four layouts, distinguished by tuple length:
  (k_buf, v_buf, pos)                      — STATIC plain: head-major
                                             [B, H, L, D] buffers
  (k_q, v_q, pos, k_scale, v_scale)        — STATIC int8: per-(head, token)
                                             absmax scales [B, H, L] f32
  (k_pages, v_pages, pos, page_tbl)        — PAGED plain: global page pool
                                             [P, H, page_size, D] + per-slot
                                             page tables [B, max_pages]
  (k_pages, v_pages, pos, page_tbl,
   k_scale_pages, v_scale_pages)           — PAGED int8: per-(head, token)
                                             absmax scale pools [P, H, ps] f32

``pos`` is the number of rows already written: a Python int or 0-d
tensor (every row at the same depth: generate()) or a per-slot [B] tensor
(continuous batching).  New k/v arrive from the projections as
[B, S, H, D] and land at rows pos .. pos + S - 1 of each slot.

Paged contract (as in the reference):
  - page 0 is the TRASH page: never allocated to a slot; unused page-table
    entries point at it, so padded scatters land there, and the attention
    never reads it for a live slot (its walk stops at the valid length).
  - a token at absolute position t of slot b lives in page
    page_tbl[b, t // page_size] at row t % page_size.
  - capacity follows actual sequence lengths: admission is by free pages.
  - SHARING (the prefix cache, inference/prefix_cache.py): a page may sit in
    several slots' tables and in the cache at once; the engine refcounts
    it.  Shared full pages are only read (writes land past the prompt); a
    shared partly filled tail page is forked copy-on-write
    (``cow_copy_pages``) before a slot writes its own rows into it.

One difference: JAX updates the buffers and pools functionally (the
engine donates them to the compiled step); the port writes IN PLACE (slice
assignment or ``index_put_``), so the returned buffers are the same tensors
that came in.  The static scatter needs every written row inside the
buffer (pos + S <= L), where the reference drops rows past it: its callers
keep a speculative verify's K + 1 rows inside (generate pads the cache by
K rows, the dense engine verifies only with K rows of headroom).
"""
from __future__ import annotations

import torch

TRASH_PAGE = 0  # reserved pool slot: padding/garbage writes land here


def _quantize_kv(kv):
    """Per-(head, token) absmax int8 quantization of a HEAD-MAJOR
    [B, H, S, D] slice: returns (int8 values, f32 scale [B, H, S])."""
    f = kv.float()
    scale = torch.clamp(f.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(f / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _to_head_major(kv):
    """[B, S, H, D] (projection layout) -> [B, H, S, D] (cache layout)."""
    return kv.permute(0, 2, 1, 3)


def _scatter(buf, hm, offset):
    """Write head-major new kv [B, H, S, ...] into the static buffer
    [B, H, L, ...] in place at rows offset .. offset + S - 1: one offset
    for every slot (an int or 0-d tensor) or one per slot ([B]).  Returns
    the buffer."""
    S = hm.shape[2]
    if isinstance(offset, int):
        buf[:, :, offset:offset + S] = hm
        return buf
    B, H = buf.shape[0], buf.shape[1]
    dev = buf.device
    off = torch.as_tensor(offset, device=dev).to(torch.int64)
    rows = off.reshape(-1, 1, 1) + torch.arange(S, device=dev)[None, None, :]
    bi = torch.arange(B, device=dev)[:, None, None]
    hi = torch.arange(H, device=dev)[None, :, None]
    buf.index_put_((bi, hi, rows.expand(B, 1, S)), hm)
    return buf


def update_plain_cache(cache, k, v, offset):
    """Scatter new k/v [B, S, H, D] into the static (k_buf, v_buf, pos)
    layout.  Returns (new_cache, k_buf, v_buf), the buffers head-major
    [B, H, L, D]."""
    S = k.shape[1]
    k_buf, v_buf = cache[0], cache[1]
    _scatter(k_buf, _to_head_major(k.to(k_buf.dtype)), offset)
    _scatter(v_buf, _to_head_major(v.to(v_buf.dtype)), offset)
    return (k_buf, v_buf, offset + S), k_buf, v_buf


def update_quant_cache(cache, k, v, offset):
    """Quantize (per head and token) and scatter new k/v [B, S, H, D] into
    the static int8 5-tuple.  Returns (new_cache, k_q, v_q, k_scale,
    v_scale)."""
    S = k.shape[1]
    k_buf, v_buf, _, k_sc, v_sc = cache
    for buf, sbuf, kv in ((k_buf, k_sc, k), (v_buf, v_sc, v)):
        kv_q, scale = _quantize_kv(_to_head_major(kv))
        _scatter(buf, kv_q, offset)
        _scatter(sbuf, scale, offset)
    return (k_buf, v_buf, offset + S, k_sc, v_sc), k_buf, v_buf, k_sc, v_sc


def static_attention_update(cache, q, k, v, offset):
    """Scatter new k/v [B, S, H, D] into the static cache, then attend q
    against it (the static decode kernel on CUDA, the plain version on the
    CPU).  Returns (new_cache, out [B, S, Hq, D])."""
    from ..ops.decode_attention import decode_attention

    if len(cache) == 5:
        new_cache, k_q, v_q, k_sc, v_sc = update_quant_cache(cache, k, v, offset)
        return new_cache, decode_attention(q, k_q, v_q, offset, k_sc, v_sc)
    new_cache, k_b, v_b = update_plain_cache(cache, k, v, offset)
    return new_cache, decode_attention(q, k_b, v_b, offset)


def pages_for(n_tokens, page_size):
    """Pages needed to hold n_tokens (host-side allocator arithmetic)."""
    return -(-int(n_tokens) // int(page_size))


def cow_copy_pages(caches, src, dst):
    """Copy page ``src``'s rows into page ``dst`` in every layer's pools, in
    place: the device side of a copy-on-write fork.  ``caches`` is the
    engine's per-layer list of pool tuples (k/v pools, plus the scale pools
    of the int8 layout; every element is page-major [P, ...]).  The caller
    then points the writing slot's table entry at ``dst``; readers of
    ``src`` keep the frozen rows."""
    for c in caches:
        for x in c:
            x[dst] = x[src]
    return caches


def gather_pages_to_host(caches, pages):
    """Gather the rows of the page ids ``pages`` ([N] int64 tensor on the
    pools' device) from every layer's pools (k/v, plus the scale pools of
    the int8 layout: every element is page-major [P, ...]): the device half
    of a DEMOTION to the host tier.  One batched ``index_select`` a pool
    for all N pages; returns per-layer tuples of new [N, ...] tensors on
    the device, so later in-place writes to the pools (which queue behind
    the gather on the stream) cannot reach them.  The caller copies them to
    the host outside the engine lock."""
    return [tuple(x.index_select(0, pages) for x in c) for c in caches]


def upload_host_pages(caches, pages, blocks):
    """Scatter staged page blocks back into the pools in place: the device
    half of a PROMOTION, the dual of :func:`gather_pages_to_host`.
    ``blocks`` mirrors the gather's output (per-layer tuples of [N, ...]
    tensors, on the host or the device), scattered to the page ids
    ``pages`` ([N] int64 on the pools' device).  Returns ``caches``."""
    for c, blk in zip(caches, blocks, strict=True):
        for x, b in zip(c, blk, strict=True):
            x.index_copy_(0, pages, b.to(device=x.device, non_blocking=True))
    return caches


def _token_pages_rows(pos, page_tbl, S, page_size, max_pages):
    """Per-token (page id, row) for S new tokens starting at `pos` (scalar
    or [B]).  Positions past the table's coverage route to TRASH_PAGE
    explicitly — a clip to the last entry would alias a full table's REAL
    last page and clobber live rows."""
    B = page_tbl.shape[0]
    dev = page_tbl.device
    pos = torch.as_tensor(pos, device=dev).to(torch.int64)
    if pos.dim() == 0:
        pos = pos.expand(B)
    tpos = pos[:, None] + torch.arange(S, device=dev)[None, :]  # [B, S]
    in_table = tpos < max_pages * page_size
    pidx = torch.clamp(tpos // page_size, 0, max_pages - 1)
    page = torch.gather(page_tbl.to(torch.int64), 1, pidx)
    page = torch.where(in_table, page, torch.full_like(page, TRASH_PAGE))
    return page, tpos % page_size


def _paged_scatter(pool, hm, pos, page_tbl):
    """Write head-major new kv [B, H, S, D] into the page pool
    [P, H, page_size, D] in place at positions pos..pos+S-1 of each slot,
    routed through that slot's page-table row.  Returns the pool."""
    H, ps = pool.shape[1], pool.shape[2]
    S = hm.shape[2]
    page, row = _token_pages_rows(pos, page_tbl, S, ps, page_tbl.shape[1])
    hi = torch.arange(H, device=pool.device)[None, None, :]
    vals = hm.permute(0, 2, 1, 3)  # [B, S, H, D]
    pool.index_put_((page[..., None], hi, row[..., None]), vals)
    return pool


def _paged_scatter_scale(spool, scale, pos, page_tbl):
    """Same routing for the f32 scale pool [P, H, page_size]; scale arrives
    head-major [B, H, S]."""
    H, ps = spool.shape[1], spool.shape[2]
    S = scale.shape[2]
    page, row = _token_pages_rows(pos, page_tbl, S, ps, page_tbl.shape[1])
    hi = torch.arange(H, device=spool.device)[None, None, :]
    spool.index_put_((page[..., None], hi, row[..., None]), scale.permute(0, 2, 1))
    return spool


def update_paged_cache(cache, k, v, offset):
    """Scatter new k/v [B, S, H, D] into the paged 4-tuple layout.  Returns
    (new_cache, k_pages, v_pages)."""
    S = k.shape[1]
    k_pool, v_pool, _, tbl = cache
    _paged_scatter(k_pool, _to_head_major(k.to(k_pool.dtype)), offset, tbl)
    _paged_scatter(v_pool, _to_head_major(v.to(v_pool.dtype)), offset, tbl)
    return (k_pool, v_pool, offset + S, tbl), k_pool, v_pool


def update_paged_quant_cache(cache, k, v, offset):
    """Quantize + scatter new k/v [B, S, H, D] into the paged int8 6-tuple.
    Returns (new_cache, k_pages, v_pages, k_scale_pages, v_scale_pages)."""
    S = k.shape[1]
    k_pool, v_pool, _, tbl, k_sc, v_sc = cache
    for pool, spool, kv in ((k_pool, k_sc, k), (v_pool, v_sc, v)):
        kv_q, scale = _quantize_kv(_to_head_major(kv))
        _paged_scatter(pool, kv_q, offset, tbl)
        _paged_scatter_scale(spool, scale, offset, tbl)
    return ((k_pool, v_pool, offset + S, tbl, k_sc, v_sc),
            k_pool, v_pool, k_sc, v_sc)


def paged_attention_update(cache, q, k, v, offset):
    """Scatter new k/v [B, S, H, D] into the paged cache, then attend q
    through the page table (the ragged paged kernel on CUDA for any S >= 1,
    the plain version on the CPU).  Returns (new_cache, out [B, S, Hq, D])."""
    from ..ops.decode_attention import paged_decode_attention

    if len(cache) == 6:
        new_cache, k_q, v_q, k_sc, v_sc = update_paged_quant_cache(
            cache, k, v, offset)
        out = paged_decode_attention(q, k_q, v_q, offset, cache[3], k_sc, v_sc)
    else:
        new_cache, k_p, v_p = update_paged_cache(cache, k, v, offset)
        out = paged_decode_attention(q, k_p, v_p, offset, cache[3])
    return new_cache, out
