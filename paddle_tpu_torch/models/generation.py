"""Autoregressive generation (counterpart of paddle_tpu/models/generation.py,
the non-speculative path).

The reference compiles the prefill and a ``lax.scan`` over the decode steps
into one program over a STATIC kv cache.  Here the prefill and a Python
loop of decode steps run eagerly over the same static layouts: head-major
[B, H, L, D] buffers (int8 + per-(head, token) scales with
``cache_dtype="int8"``), or the paged pool behind identity page tables with
``kv_layout="paged"``, updated in place.  On CUDA the prefill's attention
runs the encoder or flash kernel where the reference would run its Pallas
kernel (nn/functional/attention.py), and every decode step runs the static
decode kernel (or the paged one).  The position of the next write stays on
the device, so the loop never waits on the host.

Not ported yet, and raising NotImplementedError (ROADMAP.md Queue 1 item 2):
speculative decoding (``spec_k``), LoRA adapters (``adapter_id`` /
``adapters``) and constrained decoding (``token_mask_fn``).
"""
from __future__ import annotations

import math

import torch

from ..framework.random import get_generator
from ..ops.sampling import sample_rows
from .kv_cache import _quantize_kv

__all__ = ["generate"]


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md Queue 1 "
        "item 2: prefix cache, spec decode, LoRA, constraints)")


def _select(logits, generator, do_sample, temperature, top_k, top_p):
    """logits [B, V] -> token ids [B] (int64): the bare argmax when greedy,
    else one draw per row from the masked distribution (the fused per-row
    sampler the engine uses, with the same knobs on every row)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    B, dev = logits.shape[0], logits.device
    return sample_rows(
        logits, generator, torch.ones(B, dtype=torch.bool, device=dev),
        torch.full((B,), float(temperature), device=dev),
        torch.full((B,), int(top_k), dtype=torch.int32, device=dev),
        torch.full((B,), float(top_p), device=dev)).long()


def _to_static_caches(caches, ids, total, cache_dtype, kv_layout, page_size,
                      share_prefix):
    """Turn the prefill's per-layer (k, v) [B, S0, H, D] into head-major
    static buffers [B, H, L, D], L = ``total`` padded up to a multiple of
    128 (the padded tail is never valid: attention masks by position).
    kv_layout="paged" pads to whole pages as well and lays each row's
    buffer out as pool pages behind an identity page table (page 0 stays
    the trash page); share_prefix additionally points every row's
    page-aligned common prompt prefix at row 0's pages, which are never
    written (decode writes land at positions >= S0)."""
    B, S0 = ids.shape
    dev = ids.device
    unit = 128
    if kv_layout == "paged":
        unit = page_size * 128 // math.gcd(page_size, 128)
    L = -(-total // unit) * unit
    page_tbl = None
    if kv_layout == "paged":
        n_pages = L // page_size
        page_tbl = (1 + torch.arange(B * n_pages, dtype=torch.int32, device=dev)
                    ).reshape(B, n_pages)
        if share_prefix and B > 1:
            same = (ids == ids[:1]).all(dim=0)
            cpl = S0 if bool(same.all()) else int(torch.argmin(same.int()))
            k_shared = cpl // page_size
            page_tbl[:, :k_shared] = page_tbl[:1, :k_shared]

    def buffer(x, fill=0.0):
        # [B, S0, H(, D)] rows -> [B, H, L(, D)] with the tail at `fill`
        hm = x.transpose(1, 2)
        buf = torch.full((B, hm.shape[1], L) + tuple(hm.shape[3:]), fill,
                         dtype=hm.dtype, device=dev)
        buf[:, :, :S0] = hm
        return buf

    def pool(buf, fill=0.0):
        # [B, H, L(, D)] -> [1 + B * n_pages, H, page_size(, D)]
        Bb, H = buf.shape[:2]
        rest = tuple(buf.shape[3:])
        pg = buf.reshape((Bb, H, L // page_size, page_size) + rest)
        pg = pg.transpose(1, 2).reshape((-1, H, page_size) + rest)
        trash = torch.full((1,) + tuple(pg.shape[1:]), fill, dtype=pg.dtype, device=dev)
        return torch.cat([trash, pg], dim=0)

    pos = torch.tensor(S0, dtype=torch.int64, device=dev)
    out = []
    for k, v in caches:
        if cache_dtype == "int8":
            bufs = []
            for x in (k, v):  # quantize the prompt rows; the tail is 0 at scale 1e-8
                xq, xs = _quantize_kv(x.transpose(1, 2))
                bufs.append((buffer(xq.transpose(1, 2)), buffer(xs.transpose(1, 2), 1e-8)))
            (kq, ks), (vq, vs) = bufs
            if kv_layout == "paged":
                out.append((pool(kq), pool(vq), pos, page_tbl, pool(ks, 1e-8),
                            pool(vs, 1e-8)))
            else:
                out.append((kq, vq, pos, ks, vs))
        elif kv_layout == "paged":
            out.append((pool(buffer(k)), pool(buffer(v)), pos, page_tbl))
        else:
            out.append((buffer(k), buffer(v), pos))
    return out


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
             pad_token_id=0, cache_dtype=None, kv_layout=None,
             page_size=128, share_prefix=False, spec_k=0, spec_drafter=None,
             adapter_id=None, adapters=None, token_mask_fn=None,
             generator=None):
    """Generate ``max_new_tokens`` continuations of ``input_ids`` [B, S0].

    Returns int32 ids [B, max_new_tokens] on the model's device; once a row
    emits ``eos_token_id`` the rest of that row is ``pad_token_id``.
    cache_dtype="int8" keeps the kv cache quantized per (head, token);
    kv_layout="paged" decodes through the paged pool (``page_size`` tokens
    per page) behind identity page tables, and share_prefix=True aliases
    the batch's page-aligned common prompt prefix onto row 0's pages.
    Sampled rows draw from ``generator`` (default: the seeded generator of
    the model's device)."""
    if cache_dtype not in (None, "int8"):
        raise ValueError(f"cache_dtype must be None or 'int8', got {cache_dtype!r}")
    if cache_dtype == "int8" and not getattr(model, "_supports_quant_cache", False):
        raise ValueError(f"{type(model).__name__} does not support the int8 "
                         "kv-cache layout; use the default cache_dtype")
    if kv_layout not in (None, "paged"):
        raise ValueError(f"kv_layout must be None or 'paged', got {kv_layout!r}")
    if kv_layout == "paged" and not getattr(model, "_supports_paged_cache", False):
        raise ValueError(f"{type(model).__name__} does not support the paged "
                         "kv-cache layout; use the default kv_layout")
    if share_prefix and kv_layout != "paged":
        raise ValueError("share_prefix requires kv_layout='paged' (sharing "
                         "rides on the page tables)")
    if int(spec_k) < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    if spec_k or spec_drafter is not None:
        raise _not_ported("speculative decoding (spec_k)")
    if adapter_id is not None or adapters is not None:
        raise _not_ported("LoRA adapters (adapter_id / adapters)")
    if token_mask_fn is not None:
        raise _not_ported("constrained decoding (token_mask_fn)")
    dev = model.device
    ids = torch.as_tensor(input_ids).to(device=dev, dtype=torch.int64)
    B, S0 = ids.shape
    n_new = int(max_new_tokens)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    gen = generator if generator is not None else get_generator(dev)
    knobs = (gen, bool(do_sample), temperature, top_k, top_p)

    logits, caches = model.generate_step(ids)
    caches = _to_static_caches(caches, ids, S0 + n_new, cache_dtype, kv_layout,
                               int(page_size), share_prefix)
    tok = _select(logits[:, -1], *knobs)
    done = tok == eos
    out = [tok]
    for _ in range(n_new - 1):
        logits, caches = model.generate_step(tok[:, None], caches=caches)
        nxt = torch.where(done, int(pad_token_id), _select(logits[:, -1], *knobs))
        done = done | (nxt == eos)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1).to(torch.int32)
