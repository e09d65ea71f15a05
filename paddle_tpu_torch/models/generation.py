"""Autoregressive generation (counterpart of paddle_tpu/models/generation.py).

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

``spec_k`` > 0 decodes speculatively (``_generate_spec``): a host drafter
proposes K tokens a row, one verify step scores the K + 1 positions through
the same cache layouts (the decode or paged kernel at S = K + 1), and
``ops.sampling.spec_accept`` keeps the longest valid prefix plus one
correction token.  Greedy tokens equal those of ``spec_k=0``; sampled rows
are drawn by rejection sampling.

``adapter_id=`` runs every hooked projection through a LoRA adapter's
paged epilogue (ops/lora.py), from the engine's ``AdapterRegistry`` or a
throwaway 2-page pool; ``token_mask_fn=`` masks every step's logits with a
``TokenConstraint``'s automaton, whose state each row carries on the
device through the constraint's tables.
"""
from __future__ import annotations

import math
from contextlib import nullcontext

import numpy as np
import torch

from ..framework.random import get_generator
from ..ops import lora as _lora
from ..ops.sampling import sample_rows, spec_accept
from .kv_cache import _quantize_kv

__all__ = ["generate"]


def _resolve_lora(model, adapter_id, adapters):
    """-> (pool, page, release callback or None).  ``adapters`` is the
    engine's ``AdapterRegistry`` (the adapter is pinned for the call) or an
    ``{id: LoraAdapter}`` mapping (a throwaway 2-page pool)."""
    if adapter_id is None:
        return None, 0, None
    from .lora import AdapterRegistry, build_solo_pool

    if adapters is None:
        raise ValueError("adapter_id= needs adapters= (an AdapterRegistry or an "
                         "{id: LoraAdapter} mapping)")
    if isinstance(adapters, AdapterRegistry):
        page = adapters.acquire(adapter_id)
        if page is None:
            raise RuntimeError("adapter pool exhausted: every page is pinned by live "
                               "requests")
        return adapters.pool, page, (lambda: adapters.release(adapter_id))
    return build_solo_pool(model, adapters[adapter_id]), 1, None


def _resolve_constraint(token_mask_fn):
    """``token_mask_fn`` is a compiled ``inference.constrain.TokenConstraint``
    or a zero-arg callable returning one."""
    if token_mask_fn is None:
        return None
    c = token_mask_fn() if callable(token_mask_fn) else token_mask_fn
    if not hasattr(c, "device_tables"):
        raise TypeError("token_mask_fn must be an inference.constrain.TokenConstraint "
                        f"(or a zero-arg callable returning one), got {type(c).__name__}")
    return c


def _lora_ctx(pool, page, B, dev):
    """The LoRA epilogues' context for every row at ``page`` (none without a
    pool)."""
    if pool is None:
        return nullcontext()
    return _lora.activate(pool.site_pools(), torch.full((B,), page, dtype=torch.int64,
                                                        device=dev))


def _select(logits, generator, do_sample, temperature, top_k, top_p, token_mask=None):
    """logits [B, V] -> token ids [B] (int64): the argmax (of the logits
    masked by ``token_mask``, bool [B, V]) when greedy, else one draw per
    row from the masked distribution (the fused per-row sampler the engine
    uses, with the same knobs on every row)."""
    if not do_sample:
        if token_mask is not None:
            logits = torch.where(token_mask, logits, torch.tensor(
                float("-inf"), dtype=logits.dtype, device=logits.device))
        return torch.argmax(logits, dim=-1)
    B, dev = logits.shape[0], logits.device
    return sample_rows(
        logits, generator, torch.ones(B, dtype=torch.bool, device=dev),
        torch.full((B,), float(temperature), device=dev),
        torch.full((B,), int(top_k), dtype=torch.int32, device=dev),
        torch.full((B,), float(top_p), device=dev), token_mask).long()


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
    ``spec_k`` > 0 decodes speculatively with ``spec_drafter`` ("ngram" by
    default, an object with ``propose``, or a draft model).
    ``adapter_id`` / ``adapters`` decode through a LoRA adapter (an
    ``AdapterRegistry``, whose page the call pins, or an ``{id:
    LoraAdapter}`` mapping); ``token_mask_fn`` (a ``TokenConstraint`` or a
    zero-arg callable returning one; not with ``spec_k``) masks every
    step's logits with the automaton's state, and its eos is the default
    ``eos_token_id``.  Sampled rows draw from ``generator`` (default: the
    seeded generator of the model's device)."""
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
    eos = -1 if eos_token_id is None else int(eos_token_id)
    constraint = _resolve_constraint(token_mask_fn)
    if constraint is not None:
        if spec_k:
            raise ValueError("token_mask_fn does not compose with spec_k (constraint "
                             "masks are per-position; drafts cannot be pre-masked)")
        vocab = getattr(getattr(model, "config", None), "vocab_size", None)
        if vocab is not None and int(vocab) != constraint.V:
            raise ValueError(f"constraint vocab size {constraint.V} != model vocab "
                             f"size {int(vocab)}")
        if eos_token_id is None:
            eos = int(constraint.eos_token_id)
        elif eos != int(constraint.eos_token_id):
            raise ValueError(f"eos_token_id {eos} != the constraint's eos "
                             f"{int(constraint.eos_token_id)}")
    dev = model.device
    ids = torch.as_tensor(input_ids).to(device=dev, dtype=torch.int64)
    B, S0 = ids.shape
    n_new = int(max_new_tokens)
    gen = generator if generator is not None else get_generator(dev)
    knobs = (gen, bool(do_sample), temperature, top_k, top_p)
    pool, page, release = _resolve_lora(model, adapter_id, adapters)
    try:
        with _lora_ctx(pool, page, B, dev):
            if spec_k:
                return _generate_spec(model, ids, n_new, knobs, eos, int(pad_token_id),
                                      cache_dtype, kv_layout, int(page_size), share_prefix,
                                      int(spec_k), spec_drafter)
            return _generate_plain(model, ids, n_new, knobs, eos, int(pad_token_id),
                                   cache_dtype, kv_layout, int(page_size), share_prefix,
                                   constraint)
    finally:
        if release is not None:
            release()


def _generate_plain(model, ids, n_new, knobs, eos, pad_token_id, cache_dtype, kv_layout,
                    page_size, share_prefix, constraint):
    """The prefill, then one decode step a token; with ``constraint`` each
    row's automaton state rides on the device, its mask row applied before
    each selection (finished rows park in state 0)."""
    B, S0 = ids.shape
    logits, caches = model.generate_step(ids)
    caches = _to_static_caches(caches, ids, S0 + n_new, cache_dtype, kv_layout,
                               page_size, share_prefix)
    if constraint is not None:
        masks, trans = constraint.device_tables(ids.device)
        state = torch.zeros(B, dtype=torch.int64, device=ids.device)
    tok = _select(logits[:, -1], *knobs, masks[state] if constraint is not None else None)
    if constraint is not None:
        state = trans[state, tok]
    done = tok == eos
    out = [tok]
    for _ in range(n_new - 1):
        logits, caches = model.generate_step(tok[:, None], caches=caches)
        mask = masks[state] if constraint is not None else None
        nxt = torch.where(done, pad_token_id, _select(logits[:, -1], *knobs, mask))
        done = done | (nxt == eos)
        if constraint is not None:
            state = torch.where(done, 0, trans[state, nxt])
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1).to(torch.int32)


def _generate_spec(model, ids, n_new, knobs, eos, pad_token_id, cache_dtype, kv_layout,
                   page_size, share_prefix, K, spec_drafter):
    """Speculative decoding: a host loop of draft -> one verify step (S =
    K + 1 through the static or paged cache) -> accept.  Rollback costs
    nothing: a row's position stops at its accept point, and the rejected
    rows past it are overwritten by the next verify before any read
    reaches them (the kernels mask by length).  The cache is K rows longer
    than plain decoding needs, so a verify near the end stays inside it."""
    from .spec_decode import get_drafter

    drafter = get_drafter(spec_drafter)
    gen, do_sample, temperature, top_k, top_p = knobs
    B, S0 = ids.shape
    dev = ids.device
    logits, caches = model.generate_step(ids)
    caches = _to_static_caches(caches, ids, S0 + n_new + K, cache_dtype, kv_layout,
                               page_size, share_prefix)
    row_knobs = (torch.full((B,), bool(do_sample), device=dev),
                 torch.full((B,), float(temperature), device=dev),
                 torch.full((B,), int(top_k), dtype=torch.int32, device=dev),
                 torch.full((B,), float(top_p), device=dev))
    last = _select(logits[:, -1], *knobs).cpu().numpy().astype(np.int32)
    out = np.full((B, n_new), pad_token_id, np.int32)
    out[:, 0] = last
    counts = np.ones(B, np.int64)
    done = (last == eos) | (n_new <= 1)
    # pos[b]: rows already written, S0 + emitted - 1 (the newest token's kv
    # is written by the verify that consumes it)
    pos = np.full(B, S0, np.int64)
    ctx = [ids[b].tolist() + [int(last[b])] for b in range(B)]
    while not done.all():
        drafts = np.stack([drafter.propose(np.asarray(ctx[b], np.int32), K)
                           for b in range(B)]).astype(np.int32)
        p = torch.from_numpy(pos).to(dev)
        step = [c[:2] + (p,) + c[3:] for c in caches]
        inp = torch.from_numpy(np.concatenate([last[:, None], drafts], 1).astype(np.int64))
        lg, _ = model.verify_step(inp.to(dev), step)
        o, n = spec_accept(lg, torch.from_numpy(drafts).to(dev), gen, *row_knobs)
        both = torch.cat([o, n[:, None]], dim=1).cpu().numpy()
        for b in range(B):
            if done[b]:
                continue
            for j in range(int(both[b, -1]) + 1):
                tok = int(both[b, j])
                out[b, counts[b]] = tok
                counts[b] += 1
                ctx[b].append(tok)
                pos[b] += 1
                last[b] = tok
                if tok == eos or counts[b] >= n_new:
                    done[b] = True
                    break
    return torch.from_numpy(out).to(dev)
