"""Autoregressive generation (counterpart of paddle_tpu/models/generation.py).

The reference compiles the prefill and a ``lax.scan`` over the decode steps
into one program over a STATIC kv cache, one per call signature
(``cache_key``).  Here the prefill runs eagerly (one flash or encoder call
a layer: not host-bound), and the decode steps run as a program
(jit/graphs.py) keyed like the reference's ``cache_key``: ONE decode step
over static inputs (the kv buffers, the last token, the done flags, the
automaton states, the position, the output and its column), which writes
its token into the output and carries its state in place, so that on CUDA
one captured graph is replayed ``max_new_tokens - 1`` times back to back,
with no host sync between steps.  The static layouts: head-major
[B, H, L, D] buffers (int8 + per-(head, token) scales with
``cache_dtype="int8"``), or the paged pool behind identity page tables with
``kv_layout="paged"``.  On CUDA the prefill's attention runs the encoder or
flash kernel where the reference would run its Pallas kernel
(nn/functional/attention.py), and every decode step runs the static decode
kernel (or the paged one).

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
from ..jit.graphs import Program, Programs
from ..ops import lora as _lora
from ..ops.sampling import sample_rows, spec_accept
from .kv_cache import _quantize_kv

__all__ = ["free_programs", "generate"]


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
            logits = logits.masked_fill(~token_mask, float("-inf"))
        return torch.argmax(logits, dim=-1)
    B, dev = logits.shape[0], logits.device
    return sample_rows(
        logits, generator, torch.ones(B, dtype=torch.bool, device=dev),
        torch.full((B,), float(temperature), device=dev),
        torch.full((B,), int(top_k), dtype=torch.int32, device=dev),
        torch.full((B,), float(top_p), device=dev), token_mask).long()


def _to_static_caches(caches, ids, total, cache_dtype, kv_layout, page_size,
                      share_prefix, into=None):
    """Turn the prefill's per-layer (k, v) [B, S0, H, D] into head-major
    static buffers [B, H, L, D], L = ``total`` padded up to a multiple of
    128 (the padded tail is never valid: attention masks by position).
    kv_layout="paged" pads to whole pages as well and lays each row's
    buffer out as pool pages behind an identity page table (page 0 stays
    the trash page); share_prefix additionally points every row's
    page-aligned common prompt prefix at row 0's pages, which are never
    written (decode writes land at positions >= S0).  The buffers, the
    position and the table are written in place into ``into`` (static
    caches of the same layout, as this returns them) where given, else
    allocated."""
    B, S0 = ids.shape
    dev = ids.device
    paged = kv_layout == "paged"
    unit = 128
    if paged:
        unit = page_size * 128 // math.gcd(page_size, 128)
    L = -(-total // unit) * unit
    n_pages = L // page_size
    n_prompt = -(-S0 // page_size)  # pages the prompt's rows touch

    def dst(li, j, shape, dtype):
        if into is not None:
            return into[li][j]
        return torch.empty(shape, dtype=dtype, device=dev)

    pos = dst(0, 2, (), torch.int64)
    pos.fill_(S0)
    page_tbl = None
    if paged:
        page_tbl = dst(0, 3, (B, n_pages), torch.int32)
        torch.arange(1, 1 + B * n_pages, dtype=torch.int32, device=dev,
                     out=page_tbl.view(-1))
        if share_prefix and B > 1:
            same = (ids == ids[:1]).all(dim=0)
            cpl = S0 if bool(same.all()) else int(torch.argmin(same.int()))
            k_shared = cpl // page_size
            page_tbl[:, :k_shared] = page_tbl[:1, :k_shared]

    def buffer(x, li, j, fill=0.0):
        # [B, S0, H(, D)] rows -> [B, H, L(, D)] with the tail at `fill`
        hm = x.transpose(1, 2)
        buf = dst(li, j, (B, hm.shape[1], L) + tuple(hm.shape[3:]), hm.dtype)
        buf[:, :, :S0] = hm
        buf[:, :, S0:] = fill
        return buf

    def pool(x, li, j, fill=0.0):
        # [B, S0, H(, D)] rows -> [1 + B * n_pages, H, page_size(, D)]: the
        # pages of the buffer [B, H, L(, D)] behind the identity table,
        # page 0 and the tail at `fill`
        hm = x.transpose(1, 2)
        H, rest = hm.shape[1], tuple(hm.shape[3:])
        pg = dst(li, j, (1 + B * n_pages, H, page_size) + rest, hm.dtype)
        pg[0] = fill
        pages = pg[1:].view((B, n_pages, H, page_size) + rest)
        head = torch.full((B, H, n_prompt * page_size) + rest, fill, dtype=hm.dtype, device=dev)
        head[:, :, :S0] = hm
        pages[:, :n_prompt] = head.view((B, H, n_prompt, page_size) + rest).transpose(1, 2)
        pages[:, n_prompt:] = fill
        return pg

    write = pool if paged else buffer
    out = []
    for li, (k, v) in enumerate(caches):
        if cache_dtype == "int8":
            q8 = []
            for x in (k, v):  # quantize the prompt rows; the tail is 0 at scale 1e-8
                xq, xs = _quantize_kv(x.transpose(1, 2))
                q8.append((xq.transpose(1, 2), xs.transpose(1, 2)))
            (kq, ks), (vq, vs) = q8
            o = 4 if paged else 3  # where the scales start
            out.append((write(kq, li, 0), write(vq, li, 1), pos)
                       + ((page_tbl,) if paged else ())
                       + (write(ks, li, o, 1e-8), write(vs, li, o + 1, 1e-8)))
        else:
            out.append((write(k, li, 0), write(v, li, 1), pos) + ((page_tbl,) if paged else ()))
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
        if spec_k:
            with _lora_ctx(pool, page, B, dev):
                return _generate_spec(model, ids, n_new, knobs, eos, int(pad_token_id),
                                      cache_dtype, kv_layout, int(page_size), share_prefix,
                                      int(spec_k), spec_drafter)
        return _generate_plain(model, ids, n_new, knobs, eos, int(pad_token_id),
                               cache_dtype, kv_layout, int(page_size), share_prefix,
                               constraint, (pool, page))
    finally:
        if release is not None:
            release()


def free_programs(model):
    """Drop ``generate()``'s decode program of ``model`` and the static kv
    cache it holds; the next call builds both anew."""
    progs = model.__dict__.get("_generate_programs")
    if progs is not None:
        with progs.lock:
            progs.clear()


def _programs(model):
    progs = model.__dict__.get("_generate_programs")
    if progs is None:
        progs = model.__dict__["_generate_programs"] = Programs(model.device)
    return progs


def _layer_caches(s, n_layers, width, paged):
    """The per-layer static cache tuples from a step program's statics
    ``s``: ``c<layer>_<index>`` but the position and the page table, which
    every layer shares."""
    shared = {2: "pos", 3: "table"} if paged else {2: "pos"}
    return [tuple(s[shared[j]] if j in shared else s[f"c{li}_{j}"] for j in range(width))
            for li in range(n_layers)]


def _step_program(model, key, caches, paged, knobs, eos, pad_token_id, lora, tables, n_new):
    """The decode step of a call signature: one token for every row into
    column ``j`` of ``out``, its state carried in place.  It owns every
    input (its statics): the first call's static caches, the carried
    tokens, flags, automaton states, position and column, and its own
    copies of what a call brings (the adapter's page, the automaton's
    tables, the generator's state), so that its key is the signature's and
    nothing of the caller's."""
    from .lora import LoraPool

    _, do_sample, temperature, top_k, top_p = knobs
    dev = model.device
    B = caches[0][3].shape[0] if paged else caches[0][0].shape[0]
    n_layers, width = len(caches), len(caches[0])
    pool = lora[0]
    own_pool = (None if pool is None else
                LoraPool(pool.sites, 2, pool.rank, pool.dtype, dev))
    gen = torch.Generator(device=dev) if do_sample else None
    statics = {f"c{li}_{j}": x for li, c in enumerate(caches) for j, x in enumerate(c)
               if j not in ((2, 3) if paged else (2,))}
    statics.update(pos=caches[0][2], j=torch.zeros((), dtype=torch.int64, device=dev),
                   tok=torch.zeros(B, dtype=torch.int64, device=dev),
                   done=torch.zeros(B, dtype=torch.bool, device=dev),
                   out=torch.zeros((B, n_new), dtype=torch.int64, device=dev))
    if paged:
        statics["table"] = caches[0][3]
    if own_pool is not None:
        statics["rows"] = torch.ones(B, dtype=torch.int64, device=dev)  # its page 1
    if tables is not None:
        statics.update(masks=torch.empty_like(tables[0]), trans=torch.empty_like(tables[1]),
                       state=torch.zeros(B, dtype=torch.int64, device=dev))

    def body(**s):
        step_caches = _layer_caches(s, n_layers, width, paged)
        with torch.no_grad(), (nullcontext() if own_pool is None
                               else _lora.activate(own_pool.site_pools(), s["rows"])):
            logits, _ = model.generate_step(s["tok"][:, None], caches=step_caches)
            state = s.get("state")
            mask = s["masks"][state] if state is not None else None
            nxt = torch.where(s["done"], pad_token_id,
                              _select(logits[:, -1], gen, do_sample, temperature, top_k, top_p,
                                      mask))
            done = s["done"] | (nxt == eos)
            if state is not None:
                # finished rows park in state 0 (their masks are unused)
                state.copy_(torch.where(done, 0, s["trans"][state, nxt]))
            s["out"].index_copy_(1, s["j"].reshape(1), nxt[:, None])
            s["tok"].copy_(nxt)
            s["done"].copy_(done)
            s["pos"].add_(1)
            s["j"].add_(1)
        return s["out"]

    prog = Program(_programs(model), key, body, {}, generators=(gen,) if gen else (),
                   statics=statics)
    prog.own_pool, prog.gen = own_pool, gen
    return prog


def _generate_plain(model, ids, n_new, knobs, eos, pad_token_id, cache_dtype, kv_layout,
                    page_size, share_prefix, constraint, lora):
    """The prefill (eager), then the decode step program of the call's
    signature, run ``n_new - 1`` times; with ``constraint`` each row's
    automaton state rides on the device, its mask row applied before each
    selection (finished rows park in state 0).  The model keeps one step
    program, with its static cache: a call of another signature drops it
    before its prefill, a call of the same signature writes its prefill
    into the program's cache."""
    B, S0 = ids.shape
    dev = ids.device
    pool, page = lora
    paged = kv_layout == "paged"
    tables = constraint.device_tables(dev) if constraint is not None else None
    # the reference's cache_key: the call signature's shape-relevant facts
    # and knobs
    lora_sig = None if pool is None else ("lora", pool.rank, str(pool.dtype))
    c_sig = None if constraint is None else ("constraint", constraint.n_states, constraint.V)
    gen, do_sample, temperature, top_k, top_p = knobs
    key = (B, S0, n_new, bool(do_sample), float(temperature), int(top_k), float(top_p), eos,
           pad_token_id, bool(model.training), cache_dtype, kv_layout, page_size,
           bool(share_prefix), lora_sig, c_sig)
    progs = _programs(model)
    with progs.lock:
        if n_new > 1 and key not in progs:
            progs.clear()  # its cache goes before this call's is made
        prog = progs.get(key)
        with _lora_ctx(pool, page, B, dev):
            logits, caches = model.generate_step(ids)
        into = None if prog is None else _layer_caches(prog.inputs, len(caches),
                                                       3 + paged + 2 * (cache_dtype == "int8"),
                                                       paged)
        caches = _to_static_caches(caches, ids, S0 + n_new, cache_dtype, kv_layout,
                                   page_size, share_prefix, into)
        state = None
        if tables is not None:
            masks, trans = tables
            state = torch.zeros(B, dtype=torch.int64, device=dev)
        tok = _select(logits[:, -1], *knobs, masks[state] if tables is not None else None)
        if tables is not None:
            state = trans[state, tok]
        if n_new <= 1:
            return tok[:, None].to(torch.int32)
        if prog is None:
            prog = progs.get(key, lambda: _step_program(
                model, key, caches, paged, knobs, eos, pad_token_id, lora, tables, n_new))
        s = prog.inputs
        s["tok"].copy_(tok)
        s["done"].copy_(tok == eos)
        s["j"].fill_(1)
        s["out"][:, 0] = tok
        if tables is not None:
            s["state"].copy_(state)
            s["masks"].copy_(masks)
            s["trans"].copy_(trans)
        if prog.own_pool is not None:
            for (a, b), (pa, pb) in zip(prog.own_pool.tree(), pool.tree()):
                a[1].copy_(pa[page])
                b[1].copy_(pb[page])
        if prog.gen is not None:
            prog.gen.set_state(gen.get_state())
        for _ in range(n_new - 1):
            out = prog()
        if prog.gen is not None:
            gen.set_state(prog.gen.get_state())
        return out.to(torch.int32)


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
