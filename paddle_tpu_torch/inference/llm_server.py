"""Continuous-batching LLM serving engine (counterpart of the dense and
paged engine of paddle_tpu/inference/llm_server.py, with its prefix cache
and speculative decoding).

A fixed pool of batch slots; each tick admits work, then decodes
``decode_chunk`` tokens for every active slot, each slot at its own
position.  Two kv layouts:

- DENSE (``kv_layout=None`` or ``"dense"``): per-layer static buffers
  [B, Hkv, L, D] (bf16/f32, or int8 + f32 scales [B, Hkv, L]).  A queued
  request is admitted into a free slot with ONE bucket-padded prefill
  (``prompt_buckets``, then L) whose k/v rows are written into the slot;
  the decode step runs the static decode kernel.
- PAGED (``kv_layout="paged"``): a global page pool [P, Hkv, ps, D] plus
  per-slot page tables; page 0 is the trash page (models/kv_cache.py).
  Admission by FREE PAGES (the queue head waits until reclamation frees
  enough pages for its prompt + first decode token); CHUNKED PREFILL, one
  ``prefill_chunk``-token chunk per tick interleaved with decode ticks;
  RECOMPUTE PREEMPTION when a slot's next token finds no free page (it is
  requeued with its generated tokens appended to its prompt).  Every
  attention call is the ragged paged kernel.  Pages are REFCOUNTED: with
  the PREFIX CACHE (on by default, inference/prefix_cache.py) an admission
  maps the cached pages of its prompt's longest cached prefix into its
  table and prefills from the first uncached token; a shared page is
  forked copy-on-write before a slot writes into it, and cached pages no
  slot holds are evicted least recently used when the pool runs dry.
  ``cache_aware_admission`` admits, among the first queued requests, the
  one with the longest cached prefix (aged by ``admission_age_cap``).

SPECULATIVE DECODING (``spec_k`` > 0, either layout): each tick a host
drafter (``spec_draft``, models/spec_decode.py) proposes K tokens a slot,
one verify pass scores the K + 1 positions of every slot (the decode or
paged kernel at S = K + 1), ``ops.sampling.spec_accept`` keeps the longest
valid prefix plus one correction token, and the slot rolls back to it (the
paged layout hands back the pages that hold only rejected rows).  Greedy
tokens equal those of ``spec_k=0``.  With fewer than K rows of headroom a
tick decodes one token.

MULTI-TENANT serving (paged): ``adapters=`` attaches a
``models.lora.AdapterRegistry`` and ``submit(adapter_id=)`` decodes a
request through that adapter's pages of the LoRA pool, per row
(ops/lora.py), so one batch mixes adapters; admission charges the adapter
pool like the kv pool (a request whose adapter finds every page pinned
waits at the head of the queue), and finish, expiry, preemption and a
failed admission release it.  ``submit(constraint=)`` (a regex, a JSON
schema with ``constraint_vocab=``, or a compiled ``TokenConstraint``; not
with ``spec_k``) masks each of the request's tokens to its automaton
(inference/constrain.py): a tick with a constrained row decodes one token,
with one [V] mask row a constrained slot.

The KV TIERS (paged with the prefix cache, ``host_cache_pages`` > 0):
``demote_step`` stages the least recently used cached pages device -> host
into an ``inference.kv_host_cache.HostKVPool`` (overflowing to checksummed
files under ``disk_cache_dir``) when the pool runs short of free pages or
the device of memory, off the decode tick (the worker ``start()``
starts); an admission first promotes the staged blocks of its prompt back
into free pages under their keys, so prefill starts at the first token no
tier holds.

Completion by eos / max tokens / capacity frees the slot (and its pages).
PROGRAMS (jit/graphs.py): the reference compiles its programs with jax.jit
and donates the caches; here each is a ``Program`` over static inputs,
keyed as the reference's jit caches are, and on CUDA one captured graph
replayed per call (the caches update in place): the decode tick per
effective chunk ``("decode", eff, lora)`` (``_decode_jit[eff]``), the
verify ``("verify", K, lora)`` (``_verify_jit``), the paged chunk prefill
``("chunk", lora)``, ONE program for every offset and prompt length
(``_prefill_jit["chunk"]``), and the dense prefill and slot write of each
prompt bucket ``("bucket", Lb)`` (``_prefill_jit[Lb]`` and ``[("w",
Lb)]``); ``lora`` is the variant with the LoRA epilogue.  A tick stages
its host inputs (tokens, positions, knobs, the page table, the adapter
rows, the token mask, whose rows are all True but the constrained ones)
with one copy, replays, and reads its tokens back with one copy.
``warmup()`` captures what the reference's compiles; later effective
chunks (and the dense full-length bucket) are captured when first met.
The COW copy, the tier gather and upload and ``demote_step`` stay eager
single copies.  ``step()`` pumps one tick; ``run_until_complete()``
drains; ``start()`` spawns the background pump.  Greedy tokens equal the
reference engine's on the same weights (tests/test_torch_engine.py).

Not ported yet, and raising NotImplementedError (ROADMAP.md Queue 1 item
5): the metrics exporter.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from ..framework.random import get_generator
from ..jit.graphs import Program, Programs
from ..models.kv_cache import (
    _quantize_kv, cow_copy_pages, gather_pages_to_host, pages_for, upload_host_pages)
from ..ops import lora as _oplora
from ..ops.sampling import sample_rows, spec_accept

__all__ = ["LLMEngine", "ServerOverloadedError", "DeadlineExceededError"]


class ServerOverloadedError(RuntimeError):
    """Admission queue full, or a request larger than the page pool: the
    request was rejected rather than queued without bound."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline elapsed (in the queue or mid-decode); its slot
    was freed for other traffic."""


def _fail_future(fut, exc):
    try:
        if not fut.done():
            fut.set_exception(exc)
    except Exception:
        pass  # cancelled/completed by the caller concurrently


def _complete_future(fut, result):
    try:
        if not fut.done():
            fut.set_result(result)
    except Exception:
        pass


def _to_host(x):
    """``x`` copied to the host: into pinned (page-locked) memory when it
    lives on CUDA, so the copy runs at the link's rate and a later upload
    can run asynchronously."""
    if x.device.type != "cuda":
        return x.cpu()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x)


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md Queue 1: "
        f"{item})")


@dataclass
class _Request:
    prompt: np.ndarray
    max_new_tokens: int
    future: Future
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    deadline: float | None = None
    tokens: list = field(default_factory=list)
    submit_ts: float | None = None
    skip_cache: bool = False  # set on preemption: re-admission goes private,
                              # so a COW-starved request cannot re-match the
                              # same contended pages forever
    match_epoch: int = -1     # memoized prefix match, valid while the
    match_result: tuple | None = None  # cache's epoch is unchanged
    hit_tokens: int = 0       # hit credited at first admission (reversed if
                              # a COW-starved requeue abandons the prefill)
    admitted: bool = False    # first admission done (counts prompt tokens once)
    folded: int = 0           # generated tokens already appended to the prompt
                              # by earlier preemptions
    adm_skips: int = 0        # times cache-aware admission passed it over
    adapter_id: object = None  # LoRA adapter (None: the base model)
    adapter_page: int = 0     # its pinned pool page while admitted (0: none)
    constraint: object = None  # compiled TokenConstraint, or None
    cursor: object = None     # the request's automaton state
    tier_hit_tokens: int = 0  # prompt tokens promoted from the host/disk tiers


class LLMEngine:
    def __init__(self, model, max_batch_slots=4, max_seq_len=512,
                 cache_dtype=None, eos_token_id=None, pad_token_id=0,
                 prompt_buckets=(32, 64, 128, 256),
                 decode_chunk=1, max_queue_len=None, clock=None,
                 kv_layout=None, page_size=128, num_pages=None,
                 prefill_chunk=None, prefix_cache=None, metrics_port=None,
                 spec_k=0, spec_draft=None, cache_aware_admission=False,
                 admission_age_cap=4, adapters=None, constraint_vocab=None,
                 host_cache_pages=0, disk_cache_dir=None, disk_cache_pages=0,
                 demote_watermark=0.25, demote_batch=8, generator=None):
        """Arguments as in the reference engine.  The paged layout serves
        with the prefix cache unless ``prefix_cache=False``; the dense one
        ignores ``page_size``, ``num_pages`` and ``prefill_chunk``.
        ``num_pages`` defaults to full capacity (slots * max_seq_len /
        page_size + the trash page); size it smaller to oversubscribe
        (eviction of cached prefixes, then preemption, which recomputes).
        ``decode_chunk`` decode steps run per tick (fewer near capacity).
        ``spec_k`` > 0 verifies K drafts a tick from ``spec_draft`` ("ngram"
        by default, an object with ``propose``, or a model with
        ``generate``); it excludes ``decode_chunk`` > 1.
        ``cache_aware_admission`` (paged with the prefix cache) admits the
        queued request with the longest cached prefix among the first 8,
        the queue head after ``admission_age_cap`` bypasses.  ``adapters``
        (paged) is a ``models.lora.AdapterRegistry`` for
        ``submit(adapter_id=)``; ``constraint_vocab`` (token id -> string)
        compiles wire-form constraints.  ``host_cache_pages`` > 0 (paged,
        prefix cache on) stages cached pages on the host, spilling to
        ``disk_cache_pages`` files under ``disk_cache_dir``; ``demote_step``
        stages up to ``demote_batch`` pages a pass once the pool's used
        share (or the device memory's) passes 1 - ``demote_watermark``.
        ``generator`` is the torch.Generator sampled rows draw from
        (default: the seeded generator of the model's device)."""
        if kv_layout not in (None, "dense", "paged"):
            raise ValueError(
                f"kv_layout must be None, 'dense' or 'paged', got {kv_layout!r}")
        self.paged = kv_layout == "paged"
        if not self.paged and prefix_cache:
            raise ValueError("prefix_cache requires kv_layout='paged' (sharing "
                             "rides on the page tables)")
        if host_cache_pages and not self.paged:
            raise ValueError("host_cache_pages requires kv_layout='paged' (the kv "
                             "tiers stage and re-map page-pool pages)")
        if adapters is not None:
            from ..models.lora import AdapterRegistry

            if not self.paged:
                raise ValueError("adapters= requires kv_layout='paged' (the adapter "
                                 "pool rides the paged serving path)")
            if not isinstance(adapters, AdapterRegistry):
                raise TypeError("adapters= must be a models.lora.AdapterRegistry, "
                                f"got {type(adapters).__name__}")
        if metrics_port is not None:
            raise _not_ported("the metrics exporter", "item 5, serving plane")
        if cache_dtype not in (None, "int8"):
            raise ValueError(f"cache_dtype must be None or 'int8', got {cache_dtype!r}")
        if self.paged and not getattr(model, "_supports_paged_cache", False):
            raise ValueError(f"{type(model).__name__} does not support the "
                             "paged kv-cache layout; use kv_layout=None")
        if self.paged and int(page_size) < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        cfg = model.config
        self.model = model
        self.device = next(model.parameters()).device
        self.n_slots = int(max_batch_slots)
        self.ps = int(page_size)
        self.kv_layout = "paged" if self.paged else "dense"
        self.decode_chunk = max(1, int(decode_chunk))
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k and self.decode_chunk > 1:
            raise ValueError("spec_k and decode_chunk > 1 are mutually exclusive: the "
                             "verify already emits up to K + 1 tokens a call")
        self._drafter = None
        if self.spec_k:
            from ..models.spec_decode import get_drafter

            self._drafter = get_drafter(spec_draft)
        # pad L to the 128-token tile (and, paged, a whole number of pages)
        self.L = ((int(max_seq_len) + 127) // 128) * 128
        if self.paged:
            unit = self.ps * 128 // np.gcd(self.ps, 128)
            self.L = ((self.L + unit - 1) // unit) * unit
        self.buckets = tuple(b for b in sorted(prompt_buckets) if b <= self.L) or (self.L,)
        self.cache_dtype = cache_dtype
        self.eos = -1 if eos_token_id is None else int(eos_token_id)
        self.pad = int(pad_token_id)
        H = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        D = cfg.hidden_size // cfg.num_attention_heads
        pdt = next(model.parameters()).dtype
        kv_dtype = torch.bfloat16 if pdt == torch.bfloat16 else torch.float32
        dev, B = self.device, self.n_slots
        if self.paged:
            self.M = self.L // self.ps  # page-table width (max pages per slot)
            P = int(num_pages) if num_pages is not None else B * self.M + 1
            self.num_pages = P = max(P, 2)  # trash page + one allocatable page
            self.prefill_chunk = max(1, min(
                int(prefill_chunk) if prefill_chunk is not None else 128, self.L))
            rows = (P, H, self.ps)  # page pools [P, H, ps(, D)]
        else:
            rows = (B, H, self.L)   # static buffers [B, H, L(, D)]
        if cache_dtype == "int8":
            self.caches = [
                (torch.zeros(rows + (D,), dtype=torch.int8, device=dev),
                 torch.zeros(rows + (D,), dtype=torch.int8, device=dev),
                 torch.full(rows, 1e-8, dtype=torch.float32, device=dev),
                 torch.full(rows, 1e-8, dtype=torch.float32, device=dev))
                for _ in range(cfg.num_hidden_layers)]
        else:
            self.caches = [tuple(torch.zeros(rows + (D,), dtype=kv_dtype, device=dev)
                                 for _ in range(2))
                           for _ in range(cfg.num_hidden_layers)]
        self._prefix = None
        if self.paged:
            # host-side allocator: page 0 is the trash page, never handed
            # out; pop() order is deterministic (highest id first), as the
            # reference.  Pages are refcounted: a page may be held by
            # several slots (a shared prefix) and by one prefix-cache node,
            # and returns to the free list when its last holder lets go.
            self._free_pages = list(range(1, P))
            self._page_ref = np.zeros(P, np.int32)
            self._page_cached = np.zeros(P, bool)  # held by a cache node
            self._slot_pages: list[list[int]] = [[] for _ in range(B)]
            self._pt_host = np.zeros((B, self.M), np.int32)
            if prefix_cache is None or prefix_cache:  # the reference's default: on
                from .prefix_cache import PrefixCache

                self._prefix = PrefixCache(self.ps)
        self._host_kv = None
        if host_cache_pages:
            if self._prefix is None:
                raise ValueError("host_cache_pages requires the prefix cache (the "
                                 "tiers are keyed by its chained block hashes)")
            from .kv_host_cache import HostKVPool

            self._host_kv = HostKVPool(host_pages=host_cache_pages,
                                       disk_dir=disk_cache_dir, disk_pages=disk_cache_pages)
        self.demote_watermark = float(demote_watermark)
        self.demote_batch = max(1, int(demote_batch))
        self._demote_thread = None
        self._demote_error: BaseException | None = None
        self._demote_mutex = threading.Lock()
        self._tier_hit_tokens = {"hbm": 0, "host": 0, "disk": 0}
        self._kv_demotions = self._kv_promotions = 0
        self.adapters = adapters
        self._constraint_vocab = (list(constraint_vocab)
                                  if constraint_vocab is not None else None)
        self._constraint_cache = {}  # wire spec -> compiled TokenConstraint
        # prefix-cache accounting; the epoch is bumped by every insert and
        # eviction, and invalidates the requests' memoized matches
        self._prefix_hit_tokens = self._prefix_prompt_tokens = 0
        self._cow_copies = self._prefix_evictions = self._prefix_epoch = 0
        self.cache_aware = bool(cache_aware_admission)
        self.admission_age_cap = max(1, int(admission_age_cap))
        if self.cache_aware and self._prefix is None:
            raise ValueError("cache_aware_admission requires kv_layout='paged' with the "
                             "prefix cache on (its key is the cached-prefix length)")
        self._adm_reorders = 0
        self._spec = dict(drafted=0, accepted=0, rolled_back=0, rolled_back_pages=0,
                          verify_calls=0)
        self._prefilling = None  # paged: (request, slot, prompt tokens consumed)
        self.slot_pos = np.zeros(B, np.int32)
        self.slot_req: list[_Request | None] = [None] * B
        self.last_token = np.full(B, self.pad, np.int32)
        self.max_queue_len = None if max_queue_len is None else int(max_queue_len)
        self._clock = clock if clock is not None else time.monotonic
        self._pending: "queue.Queue[_Request]" = queue.Queue(
            maxsize=self.max_queue_len
            if self.max_queue_len and self.max_queue_len > 0 else 0)
        self._rng = np.random.default_rng(1234)  # admission-token sampling
        self._gen = generator if generator is not None else get_generator(dev)
        self._vocab = int(cfg.vocab_size)
        self._thread = None
        self._stop = False
        self._stop_epoch = 0
        self._pump_error: BaseException | None = None
        # re-entrant: a future's done-callback may submit() from inside a tick
        self._lock = threading.RLock()
        # prefill_chunks counts prefill calls: chunks (paged) or bucketed
        # admissions (dense, also counted per bucket in prefill_buckets)
        # decode_ticks/decode_steps count one-token decode calls; a
        # speculative tick counts in spec verify_calls, and its emitted
        # tokens and seconds in decode_tokens and decode seconds
        self._counts = dict(submitted=0, admitted=0, completed=0, shed=0,
                            expired=0, preemptions=0, prefill_chunks=0,
                            decode_ticks=0, decode_steps=0, decode_tokens=0,
                            recompute_tokens=0, constrained_tokens=0,
                            constraint_rejects=0)
        self._recompute_by = dict(page_pool_dry=0, mid_verify=0, prefill_cow=0)
        self._bucket_counts: dict[int, int] = {}
        self._seconds = dict(prefill=0.0, decode=0.0)
        self._ttfts: list[float] = []
        # the engine's programs (jit/graphs.py), and per decode program the
        # mask rows its host twin holds not all True
        self.programs = Programs(dev)
        self._masked_rows: dict = {}

    # ------------------------------------------------------------- public

    def submit(self, prompt_ids, max_new_tokens=32, do_sample=False,
               temperature=1.0, top_k=0, top_p=1.0, timeout=None,
               adapter_id=None, constraint=None):
        """Queue one prompt; returns a Future of the generated id list.
        Sampling knobs are per request.  ``timeout`` (seconds) sets a
        deadline; a full queue raises ServerOverloadedError.  ``adapter_id``
        decodes through an adapter of the engine's registry; ``constraint``
        (a regex str, a JSON-schema dict, or a compiled TokenConstraint)
        masks decoding to its automaton.  Both are checked here, never in
        the pump."""
        if self._pump_error is not None:
            raise RuntimeError("LLMEngine pump thread died; restart the engine"
                               ) from self._pump_error
        if self._thread is not None and not self._thread.is_alive() and not self._stop:
            raise RuntimeError("LLMEngine pump thread died without a report; "
                               "restart the engine")
        if self._stop:
            raise RuntimeError("LLMEngine is stopping; resubmit once stop() completes")
        epoch = self._stop_epoch
        if isinstance(prompt_ids, torch.Tensor):
            prompt_ids = prompt_ids.detach().cpu().numpy()
        arr = np.asarray(prompt_ids, np.int32).reshape(-1)
        if arr.size == 0 or arr.size > self.L - 1:
            raise ValueError(f"prompt length {arr.size} not in [1, {self.L - 1}]")
        if adapter_id is not None:
            if self.adapters is None:
                raise ValueError("adapter_id= requires an engine constructed with "
                                 "adapters= (a models.lora.AdapterRegistry)")
            if adapter_id not in self.adapters.ids():
                raise KeyError(f"unknown adapter {adapter_id!r}; register it on the "
                               "engine's AdapterRegistry first")
        try:
            cst = self._compile_constraint(constraint)
        except (TypeError, ValueError):
            with self._lock:
                self._counts["constraint_rejects"] += 1
            raise
        now = self._clock()
        req = _Request(arr, int(max_new_tokens), Future(),
                       do_sample=bool(do_sample), temperature=float(temperature),
                       top_k=int(top_k), top_p=float(top_p),
                       deadline=(now + float(timeout)) if timeout is not None else None,
                       submit_ts=now, adapter_id=adapter_id, constraint=cst,
                       cursor=cst.cursor() if cst is not None else None)
        try:
            if self.max_queue_len is not None and self.max_queue_len <= 0:
                raise queue.Full
            self._pending.put_nowait(req)
        except queue.Full:
            with self._lock:  # the pump sheds under it too
                self._counts["shed"] += 1
            raise ServerOverloadedError(
                f"admission queue full ({self.max_queue_len} pending requests); "
                "request rejected — retry with backoff") from None
        with self._lock:
            self._counts["submitted"] += 1
        if self._pump_error is not None or self._stop or self._stop_epoch != epoch:
            exc = RuntimeError("LLMEngine stopped while the request was being "
                               "submitted; resubmit")
            _fail_future(req.future, exc)
            raise exc
        return req.future

    def _compile_constraint(self, constraint):
        """``submit``'s ``constraint`` as a compiled TokenConstraint: wire
        forms (regex str, JSON-schema dict) compile once per distinct spec
        and are cached, so repeat traffic pays no rebuild."""
        if constraint is None:
            return None
        if not self.paged:
            raise ValueError("constraint= requires kv_layout='paged' (the token-mask "
                             "path rides the paged decode tick)")
        if self.spec_k:
            raise ValueError("constraint= does not compose with spec_k (constraint "
                             "masks are per-position; drafted tokens cannot be "
                             "pre-masked)")
        c = constraint
        if isinstance(c, (str, dict)):
            if self._constraint_vocab is None:
                raise ValueError("wire-form constraints (regex str / schema dict) need "
                                 "the engine constructed with constraint_vocab= (token "
                                 "id -> string), or pass a compiled TokenConstraint")
            if self.eos < 0:
                raise ValueError("constrained decoding needs eos_token_id on the engine "
                                 "(the automaton ends by emitting eos)")
            # no sort_keys: a schema's property order is part of its regex
            key = c if isinstance(c, str) else json.dumps(c)
            with self._lock:
                cached = self._constraint_cache.get(key)
            if cached is None:
                from .constrain import compile_constraint

                cached = compile_constraint(c, self._constraint_vocab, self.eos)
                with self._lock:
                    cached = self._constraint_cache.setdefault(key, cached)
            c = cached
        if not hasattr(c, "cursor"):
            raise TypeError("constraint= must be a regex str, a JSON-schema dict, or a "
                            f"compiled TokenConstraint, got {type(c).__name__}")
        if int(c.V) != self._vocab:
            raise ValueError(f"constraint vocab size {c.V} != model vocab size "
                             f"{self._vocab}")
        if int(c.eos_token_id) != self.eos:
            raise ValueError(f"constraint eos {int(c.eos_token_id)} != engine eos "
                             f"{self.eos}")
        return c

    def generate(self, prompt_ids, max_new_tokens=32, **sampling):
        """Blocking single-prompt convenience."""
        fut = self.submit(prompt_ids, max_new_tokens, **sampling)
        self.run_until_complete()
        return fut.result()

    def run_until_complete(self):
        """Pump ticks until the queue and all slots drain."""
        while self._has_work():
            self.step()

    def _has_work(self):
        """Anything queued, mid-prefill or decoding.  Read between ticks
        without the lock (here and by the pump's idle check): a stale
        answer costs one idle tick or one 2 ms sleep."""
        slots = self.slot_req  # tpulint: disable=lock-guard-inference (between ticks)
        prefilling = self._prefilling  # tpulint: disable=lock-guard-inference (same)
        return (not self._pending.empty() or prefilling is not None
                or any(r is not None for r in slots))

    def stats(self):
        """Engine-local counters and timings (host clock around work that
        ends in a device sync).  It takes no lock, as the reference's
        stats() takes none: a scrape never waits behind a tick, and a value
        may lag one tick."""
        counts = dict(self._counts)  # tpulint: disable=lock-guard-inference (scrape)
        seconds = dict(self._seconds)  # tpulint: disable=lock-guard-inference (scrape)
        slots = list(self.slot_req)  # tpulint: disable=lock-guard-inference (scrape)
        ttft = np.asarray(self._ttfts, np.float64)
        layout = {"prefill_buckets": dict(sorted(self._bucket_counts.items()))}
        prefix = None
        if self.paged:
            ref = self._page_ref.copy()  # tpulint: disable=lock-guard-inference (scrape)
            cached = self._page_cached.copy()  # tpulint: disable=lock-guard-inference (scrape)
            # "in use" counts pages a SLOT maps; pages only the prefix cache
            # holds are reclaimable and reported under prefix_cache
            layout = {"kv_pages_in_use": int((ref > cached).sum()),
                      "kv_pages_total": self.num_pages - 1}
        index = self._prefix  # tpulint: disable=lock-guard-inference (scrape)
        if index is not None:
            n = self._prefix_prompt_tokens
            prefix = {"hit_ratio": self._prefix_hit_tokens / n if n else 0.0,
                      "hit_tokens": self._prefix_hit_tokens, "prompt_tokens": n,
                      "cached_pages": int(cached.sum()),
                      "shared_pages": int((ref > 1).sum()),
                      "nodes": len(index), "cow_copies": self._cow_copies,
                      "evictions": self._prefix_evictions}
            if self._host_kv is not None:  # absent, not zero, without the tiers
                prefix["tiers"] = self._tier_snapshot()
        spec = None
        if self.spec_k:
            sp = self._spec
            spec = {"k": self.spec_k,
                    "drafter": getattr(self._drafter, "name", type(self._drafter).__name__),
                    "drafted_tokens": sp["drafted"], "accepted_tokens": sp["accepted"],
                    "rolled_back_tokens": sp["rolled_back"],
                    "rolled_back_pages": sp["rolled_back_pages"],
                    "verify_calls": sp["verify_calls"],
                    "acceptance_ratio": sp["accepted"] / sp["drafted"] if sp["drafted"] else 0.0}
        return {
            **counts,
            **layout,
            "recompute_tokens_by_reason": dict(self._recompute_by),
            "prefix_cache": prefix,
            "spec": spec,
            "adapters": self.adapters.stats() if self.adapters is not None else None,
            "admission_reorders": self._adm_reorders,
            "queue_depth": self._pending.qsize(),
            "active_slots": sum(r is not None for r in slots),
            "n_slots": self.n_slots,
            "kv_layout": self.kv_layout,
            "prefill_seconds": seconds["prefill"],
            "decode_seconds": seconds["decode"],
            "ttft_seconds": {"count": int(ttft.size),
                             "mean": float(ttft.mean()) if ttft.size else 0.0,
                             "p50": float(np.median(ttft)) if ttft.size else 0.0,
                             "max": float(ttft.max()) if ttft.size else 0.0},
        }

    def start(self):
        """Background pump (server mode)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._pump_error = None
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        if self._host_kv is not None and (self._demote_thread is None
                                          or not self._demote_thread.is_alive()):
            # the demotion worker keeps device -> host staging off the tick
            self._demote_thread = threading.Thread(target=self._demote_loop, daemon=True)
            self._demote_thread.start()
        return self

    def stop(self):
        """Halt the pump and FAIL any queued/in-flight requests, so no
        caller blocks forever; the engine is reusable afterwards."""
        self._stop = True
        self._stop_epoch += 1
        wedged = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            wedged = self._thread.is_alive()
            if not wedged:
                self._thread = None
        if wedged:
            # the pump holds the lock inside step(): fail the queue now, its
            # _loop fails in-flight slots once the step returns
            self._drain_queue(RuntimeError("LLMEngine stopped"))
        else:
            self._fail_pending(RuntimeError("LLMEngine stopped"))
            if self._demote_thread is not None:
                # the pump is gone, so the worker sees _stop at its next pass:
                # join it before the reset below would resurrect its loop
                self._demote_thread.join(timeout=30)
                if not self._demote_thread.is_alive():
                    self._demote_thread = None
            self._stop = False

    def warmup(self):
        """Make (and on CUDA capture) every program the reference's warmup()
        compiles, run once against the idle caches, so the first request
        pays no kernel build, first launch or capture: the prefill chunk
        (paged; garbage rows land in the trash page) or each prompt
        bucket's prefill and slot write (dense; admission rewrites the
        rows), then the decode tick at the configured ``decode_chunk`` (and
        the verify with ``spec_k``); with adapters, each program's LoRA
        variant too.  Returns the wall seconds."""
        t0 = time.perf_counter()
        with self._lock:
            if self._prefilling is not None or any(r is not None for r in self.slot_req):
                raise RuntimeError("warmup() requires an idle engine")
            B = self.n_slots
            variants = [None] + ([np.zeros(B, np.int64)] if self.adapters is not None else [])
            if self.paged:
                C = self.prefill_chunk
                for rows in variants:
                    self._prefill_call(np.full((1, C), self.pad, np.int64), 0,
                                       np.zeros((1, self.M), np.int32), 0,
                                       None if rows is None else rows[:1], read=False)
            else:
                for Lb in self.buckets:
                    self._bucket_call(np.full((1, Lb), self.pad, np.int64), Lb - 1, 0)
            tok = np.full((B, 1), self.pad, np.int64)
            pt = np.zeros((B, self.M), np.int32) if self.paged else None
            for rows in variants:
                self._decode(tok, np.zeros(B, np.int64), [None] * B,
                             max(1, min(self.decode_chunk, self.L - 1)), pt, rows)
                if self.spec_k:
                    self._verify(np.full(B, self.pad, np.int32), np.zeros(B, np.int32),
                                 np.zeros((B, self.spec_k), np.int32), [None] * B, pt, rows)
        return time.perf_counter() - t0

    # ------------------------------------------------------------ pumping

    def step(self):
        """One engine tick: admit/prefill, then decode one token for every
        active slot.  Serialized by the engine lock.  Returns tokens emitted
        by the decode step."""
        with self._lock:
            return self._step_locked()

    def _loop(self):
        try:
            while not self._stop:
                if not self._has_work():
                    time.sleep(0.002)
                    continue
                self.step()
            self._fail_pending(RuntimeError("LLMEngine stopped"))
        except BaseException as e:  # watchdog: never strand blocked callers
            self._pump_error = e
            self._fail_pending(RuntimeError(f"LLMEngine pump thread died: {e!r}"))

    def _drain_queue(self, exc):
        while not self._pending.empty():
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            _fail_future(req.future, exc)

    def _fail_pending(self, exc):
        with self._lock:
            self._drain_queue(exc)
            if self._prefilling is not None:
                req, slot, _ = self._prefilling
                self._prefilling = None
                self._release_pages(slot)
                self._release_adapter(req)
                _fail_future(req.future, exc)
            for i, req in enumerate(self.slot_req):
                if req is not None:
                    self.slot_req[i] = None
                    self.last_token[i] = self.pad
                    self._release_pages(i)
                    self._release_adapter(req)
                    _fail_future(req.future, exc)

    # ---------------------------------------------------- paged internals

    def _paged_caches(self, pos, page_tbl):
        """Per-layer paged tuples (k, v, pos, tbl[, ks, vs]) over the pools."""
        return [(c[0], c[1], pos, page_tbl) + tuple(c[2:]) for c in self.caches]

    def _incref(self, page):
        self._page_ref[page] += 1

    def _decref(self, page):
        """Drop one hold on a page; the last holder frees it.  A negative
        count is a double free: fail loudly."""
        r = int(self._page_ref[page]) - 1
        if r < 0:
            raise AssertionError(f"kv page {page} decref below zero")
        self._page_ref[page] = r
        if r == 0:
            self._free_pages.append(page)

    def _release_pages(self, slot):
        """Reset a slot's length, so that while it is idle a decode tick's
        kernel reads one key of it and writes rows 0.. of its own buffer
        (dense) or of the trash page (paged); decref every page it holds
        (shared ones live on in other slots or the cache) and point its
        table row at the trash page (finish / expiry / preemption / stop)."""
        self.slot_pos[slot] = 0
        if not self.paged or not self._slot_pages[slot]:
            return
        for page in self._slot_pages[slot]:
            self._decref(page)
        self._slot_pages[slot] = []
        self._pt_host[slot, :] = 0

    def _release_adapter(self, req):
        """Drop a request's adapter-pool pin (a no-op for requests that hold
        none: queued, base-model); called on every path that frees or
        requeues a request, beside ``_release_pages``.  A preempted request
        pins again at re-admission."""
        if req is not None and req.adapter_page:
            self.adapters.release(req.adapter_id)
            req.adapter_page = 0

    def _lora_rows(self, reqs):
        """The rows' adapter pages (idle rows and base requests on the zero
        page) for a program's LoRA variant; None, the variant without the
        epilogue, without an adapter pool or when every row is on the zero
        page, whose delta is an exact +0."""
        pages = [r.adapter_page if r is not None else 0 for r in reqs]
        if self.adapters is None or not any(pages):
            return None
        return np.asarray(pages, np.int64)

    def _lora_scope(self, rows):
        """Inside a program's body: the LoRA epilogues over its static rows
        input (none for the variant without it)."""
        if rows is None:
            return nullcontext()
        return _oplora.activate(self.adapters.pool.site_pools(), rows)

    def _stage_mask(self, prog, reqs):
        """Write each constrained row's automaton mask into the decode
        program's mask input (all True elsewhere: an exact no-op in
        ``sample_rows``), resetting the rows an earlier tick masked."""
        rows = [i for i, r in enumerate(reqs) if r is not None and r.cursor is not None]
        stale = self._masked_rows.get(prog.key, ())
        if not rows and not stale:
            return
        mask = prog.host_view("mask")
        for i in stale:
            mask[i] = True
        for i in rows:
            mask[i] = reqs[i].cursor.mask()
        self._masked_rows[prog.key] = rows

    def _advance_cursor(self, req, tok):
        """Move a constrained request's automaton past an emitted token."""
        if req.cursor is not None:
            self._counts["constrained_tokens"] += 1
            if not req.cursor.advance(tok):
                self._counts["constraint_rejects"] += 1

    def _alloc_pages(self, slot, n):
        """Move n free pages into a slot's table (refcount 1); False
        (allocating nothing) when the pool cannot cover them even after
        evicting cached prefixes no slot holds."""
        if n <= 0:
            return True
        if len(self._free_pages) < n and not self._evict_prefix(n - len(self._free_pages)):
            return False
        for _ in range(n):
            page = self._free_pages.pop()
            self._page_ref[page] = 1
            self._pt_host[slot, len(self._slot_pages[slot])] = page
            self._slot_pages[slot].append(page)
        return True

    def _evict_prefix(self, need):
        """Evict least recently used cached prefixes that only the cache
        holds until ``need`` more pages are free; False, evicting nothing,
        when eviction could never cover ``need`` (keep the warm entries
        rather than destroy them for a doomed allocation)."""
        if self._prefix is None:
            return False
        if self._prefix.freeable_count(lambda p: int(self._page_ref[p]) > 1) < need:
            return False
        freed = 0
        while freed < need:
            evicted = self._prefix.evict_one(
                lambda p: int(self._page_ref[p]) == 1 and bool(self._page_cached[p]))
            if evicted is None:
                return False
            self._drop_cached(evicted[2])
            freed += 1
        return True

    def _drop_cached(self, page):
        """The cache let go of ``page`` (its node was evicted; a page the tiers
        staged lives on there under the same key)."""
        self._page_cached[page] = False
        self._decref(page)
        self._prefix_evictions += 1
        self._prefix_epoch += 1

    def _cow_page(self, slot, idx):
        """Copy-on-write guard before a slot WRITES rows of its table entry
        ``idx``: a page other slots or the cache also hold is forked (rows
        copied into a fresh page on the device, the slot's entry repointed,
        the original decref'd), so its readers keep the frozen rows.  When
        no page can be had and the cache is the only other holder, the
        slot takes the page back (evicts its cache node) and writes in
        place.  False only when a needed copy found no page.  A failing
        copy raises."""
        pages = self._slot_pages[slot]
        if idx >= len(pages):
            return True  # not allocated yet: the grower hands out a fresh page
        old = pages[idx]
        if int(self._page_ref[old]) <= 1:
            return True  # exclusive: write in place
        if self._free_pages or self._evict_prefix(1):
            new = self._free_pages.pop()
            self._page_ref[new] = 1
            try:
                cow_copy_pages(self.caches, old, new)
            except Exception:
                self._page_ref[new] = 0
                self._free_pages.append(new)
                raise
            pages[idx] = new
            self._pt_host[slot, idx] = new
            self._decref(old)
            self._cow_copies += 1
            return True
        if int(self._page_ref[old]) == 2 and self._page_cached[old] \
                and self._prefix.evict_page(old) is not None:
            # steal-back: the diverging tail is the cache's least valuable
            # entry anyway; reclaim it rather than preempt the slot
            self._drop_cached(old)
            return True
        return False

    def _cache_insert(self, slot, prompt, adapter_id=None):
        """Index a freshly prefilled prompt's pages in the prefix cache; the
        cache's new holds are incref'd so they outlive the slot.  The
        adapter id seeds the chain: kv computed under one adapter matches
        only requests for the same adapter."""
        if self._prefix is None:
            return
        new_holds = self._prefix.insert(prompt, self._slot_pages[slot],
                                        adapter_id=adapter_id)
        if new_holds:
            self._prefix_epoch += 1
        for page in new_holds:
            self._incref(page)
            self._page_cached[page] = True

    def _preempt_slot(self, slot, origin="decode"):
        """Recompute-style preemption: reclaim the slot's pages and REQUEUE
        its request at the head with the generated tokens appended to the
        prompt; its re-admission skips the prefix cache.  Without the cache,
        a request already holding the whole pool can never fit and fails
        with ServerOverloadedError (with it, held pages may be shared: the
        admission's total-need check sheds instead).  ``origin`` is
        "verify" when the pool ran dry growing a verify's K + 1 rows."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.last_token[slot] = self.pad
        held = len(self._slot_pages[slot])
        self._release_pages(slot)
        self._release_adapter(req)
        self._counts["preemptions"] += 1
        if req is None:
            return
        if held >= self.num_pages - 1 and self._prefix is None:
            _fail_future(req.future, ServerOverloadedError(
                f"request needs more kv pages than the whole pool "
                f"({self.num_pages - 1} pages x {self.ps} tokens); rejected"))
            return
        req.skip_cache = True
        # only the tokens generated since the last preemption: the earlier
        # ones are in the prompt already (the reference appends them all
        # again, so a request preempted twice re-prefills a context with
        # its first tokens doubled; ROADMAP.md Queue 3)
        req.prompt = np.concatenate([req.prompt, np.asarray(req.tokens[req.folded:], np.int32)])
        req.folded = len(req.tokens)
        self._count_recompute("mid_verify" if origin == "verify" else "page_pool_dry",
                              int(req.prompt.size))
        with self._pending.mutex:
            self._pending.queue.appendleft(req)

    def _count_recompute(self, reason, n):
        self._counts["recompute_tokens"] += n
        self._recompute_by[reason] += n

    def _ensure_decode_pages(self, active, eff, origin="decode"):
        """Grow each active slot's table to cover this tick's writes (pos ..
        pos + eff - 1), forking the shared pages among them copy-on-write;
        preempt the slots the pool cannot cover.  Returns the survivors."""
        out = []
        for i in active:
            first = int(self.slot_pos[i]) // self.ps
            last = (int(self.slot_pos[i]) + eff - 1) // self.ps
            ok = self._alloc_pages(i, last + 1 - len(self._slot_pages[i]))
            if ok and self._prefix is not None:
                ok = all(self._cow_page(i, idx) for idx in range(first, last + 1))
            if ok:
                out.append(i)
            else:
                self._preempt_slot(i, origin)
        return out

    def _trim_rollback_pages(self, slot):
        """After a verify, free the pages that hold only rejected rows: the
        valid rows are 0 .. slot_pos - 1, so every page past the one holding
        row slot_pos - 1 was grown for drafts that rolled back (exclusively
        owned: fresh or forked).  Returns the count."""
        keep = (int(self.slot_pos[slot]) - 1) // self.ps + 1
        pages = self._slot_pages[slot]
        trimmed = 0
        while len(pages) > keep:
            page = pages.pop()
            self._pt_host[slot, len(pages)] = 0
            self._decref(page)
            trimmed += 1
        return trimmed

    # --------------------------------------------- hierarchical kv tiers

    def demote_step(self, force=False):
        """One demotion pass: stage up to ``demote_batch`` of the least
        recently used cached pages device -> host, so that their later
        eviction from HBM is a demotion, not a loss.  Runs on the worker
        ``start()`` starts, or when called (tests, operators), never on the
        decode tick.  Unless ``force``, it runs only when the larger of the
        pool's used share and the device memory's (``mem_get_info``; 0 on
        the CPU) passes 1 - ``demote_watermark``.  The scan and the gather
        run under the engine lock (on CUDA the gather is queued on the
        stream ahead of any later write to the pools); the blocking copy
        to the host runs outside it; the commit under it again.  Returns
        the pages staged."""
        if self._host_kv is None:
            return 0
        hbm = 0.0
        if not force and self.device.type == "cuda":
            free, total = torch.cuda.mem_get_info(self.device)
            hbm = 1.0 - free / total
        with self._demote_mutex:
            with self._lock:
                pages_total = self.num_pages - 1
                if not force and pages_total:
                    used = 1.0 - len(self._free_pages) / pages_total
                    if max(used, hbm) <= 1.0 - self.demote_watermark:
                        return 0
                cands = []
                for key, parent, page, ntok, tokens in self._prefix.lru_entries():
                    if self._page_cached[page] and key not in self._host_kv:
                        cands.append((key, parent, ntok, tokens, page))
                        if len(cands) >= self.demote_batch:
                            break
                if not cands:
                    return 0
                idx = torch.tensor([c[4] for c in cands], dtype=torch.int64,
                                   device=self.device)
                gathered = gather_pages_to_host(self.caches, idx)
            # the blocking device -> host copy, outside the engine lock
            host = [tuple(_to_host(x) for x in layer) for layer in gathered]
            with self._lock:
                staged = 0
                for i, (key, parent, ntok, tokens, _) in enumerate(cands):
                    blocks = [tuple(x[i] for x in layer) for layer in host]
                    staged += self._host_kv.put(key, parent, ntok, tokens, blocks)
                self._kv_demotions += staged
        return staged

    def _demote_loop(self):
        """The demotion worker: polls the watermark off the tick.  A failing
        pass stops the worker (serving goes on without demotion) and is
        reported in the tier stats."""
        while not self._stop:
            try:
                self.demote_step()
            except Exception as e:  # noqa: BLE001 - reported in stats()
                self._demote_error = e
                return
            time.sleep(0.01)

    def _promote_from_tiers(self, req):
        """Re-admit the staged blocks of ``req``'s prompt: walk its chain
        keys; blocks the radix index lacks but a tier holds are uploaded
        into free pages (one batched scatter a pool) and re-enter the index
        under their keys, so the match that follows sees them as if never
        evicted and prefill starts at the first token no tier holds.  Free
        pages only: promotion never evicts.  A lost entry (quarantined on
        disk) ends the chain there.  Returns the pages promoted."""
        from .prefix_cache import _root_key, chained_block_key

        prompt = np.asarray(req.prompt, np.int32)
        usable = int(prompt.size) - 1
        ps = self.ps
        key, pos, plan = _root_key(req.adapter_id), 0, []
        # a full block's key exists whenever the prompt holds all ps tokens,
        # even where the n - 1 logits cap credits only part of it
        while pos + ps <= int(prompt.size):
            k = chained_block_key(key, prompt[pos:pos + ps].tobytes())
            if self._prefix.node_info(k) is None:
                if k not in self._host_kv:
                    break
                plan.append((k, key, min(ps, usable - pos)))
            key = k
            pos += ps
        if pos < usable:
            # a partial tail under the chain point: the longest common
            # prefix wins, as in PrefixCache.match
            best, best_t = None, 0
            for pk, ntok, toks in self._host_kv.partial_candidates(key):
                if self._prefix.node_info(pk) is not None:
                    continue  # resident: the match uses it directly
                t_max = min(int(ntok), usable - pos)
                if t_max <= 0:
                    continue
                eq = np.asarray(toks, np.int32)[:t_max] == prompt[pos:pos + t_max]
                t = t_max if eq.all() else int(np.argmin(eq))
                if t > best_t:
                    best, best_t = pk, t
            if best is not None:
                plan.append((best, key, best_t))
        entries = []
        for k, parent, credit in plan[:len(self._free_pages)]:
            e = self._host_kv.get(k)
            if e is None:
                break  # lost mid-chain: its children are unreachable
            entries.append((k, parent, credit, e))
        if not entries:
            return 0
        popped = [self._free_pages.pop() for _ in entries]
        first, dev = entries[0][3].blocks, self.device
        # each block crosses to the device on its own (asynchronously from
        # pinned host memory), the batch is stacked there
        blocks = [tuple(torch.stack([e.blocks[li][j].to(dev, non_blocking=True)
                                     for *_, e in entries])
                        for j in range(len(first[li])))
                  for li in range(len(first))]
        try:
            upload_host_pages(self.caches, torch.tensor(popped, dtype=torch.int64,
                                                        device=self.device), blocks)
        except Exception:
            self._free_pages.extend(reversed(popped))
            raise
        for (k, parent, credit, e), page in zip(entries, popped):
            self._page_ref[page] = 1
            self._page_cached[page] = True
            self._prefix.readmit(k, parent, page, e.ntok, e.tokens)
            self._tier_hit_tokens[e.tier] += int(credit)
            req.tier_hit_tokens += int(credit)
        self._prefix_epoch += 1
        self._kv_promotions += len(entries)
        return len(entries)

    def _tier_snapshot(self):
        """stats()'s "tiers" block (single reads, like stats())."""
        hk = self._host_kv.stats()
        pt = self._prefix_prompt_tokens
        hits = dict(self._tier_hit_tokens)
        return {"host": {"entries": hk["host_entries"], "capacity": hk["host_pages"],
                         "bytes": hk["host_bytes"], "hit_tokens": hits["host"],
                         "hit_ratio": hits["host"] / pt if pt else 0.0},
                "disk": {"entries": hk["disk_entries"], "capacity": hk["disk_pages"],
                         "loads": hk["disk_loads"], "quarantined": hk["quarantined"],
                         "hit_tokens": hits["disk"],
                         "hit_ratio": hits["disk"] / pt if pt else 0.0},
                "hbm_hit_tokens": hits["hbm"], "demotions": self._kv_demotions,
                "promotions": self._kv_promotions,
                "spilled_to_disk": hk["demotions_to_disk"], "dropped": hk["dropped"],
                "worker_error": (repr(self._demote_error)
                                 if self._demote_error is not None else None)}

    # ---------------------------------------------------- dense internals

    def _bucket(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return self.L

    def _dense_caches(self, pos):
        """Per-layer static tuples (k, v, pos[, ks, vs]) over the buffers."""
        return [(c[0], c[1], pos) + tuple(c[2:]) for c in self.caches]

    def _write_slot(self, slot, kvs):
        """Write a prefill's per-layer (k, v) [1, Lb, H, D] into rows
        [0, Lb) of the static buffers of slot ``slot``, a [1] index tensor
        on the device (quantized for int8)."""
        for c, (k, v) in zip(self.caches, kvs, strict=True):
            Lb = k.shape[1]
            for buf, sbuf, kv in ((c[0], c[2] if len(c) == 4 else None, k),
                                  (c[1], c[3] if len(c) == 4 else None, v)):
                hm = kv.transpose(1, 2)  # [1, H, Lb, D]
                if sbuf is None:
                    buf[:, :, :Lb].index_copy_(0, slot, hm.to(buf.dtype))
                else:
                    q, scale = _quantize_kv(hm)
                    buf[:, :, :Lb].index_copy_(0, slot, q)
                    sbuf[:, :, :Lb].index_copy_(0, slot, scale)

    def _bucket_program(self, Lb):
        """The dense admission of prompt bucket ``Lb``: the padded prefill,
        the next-token logits at ``last`` (n - 1) and the slot write into
        ``slot``, both device indices (the reference's ``_prefill_jit[Lb]``
        and ``[("w", Lb)]``)."""
        def build():
            def body(ids, last, slot):
                with torch.no_grad():
                    # causal attention: positions >= n never influence
                    # position n - 1, so the padded prefill's first n k/v
                    # rows are exact
                    logits, kvs = self.model.prefill_step(ids, last)
                    self._write_slot(slot, kvs)
                    return logits[0, 0].float()

            return Program(self.programs, key, body, dict(
                ids=torch.full((1, Lb), self.pad, dtype=torch.int64),
                last=torch.zeros(1, dtype=torch.int64), slot=torch.zeros(1, dtype=torch.int64)))

        key = ("bucket", int(Lb))
        return self.programs.get(key, build)

    def _bucket_call(self, padded, last, slot):
        """Run a bucket's admission program; returns its logits row on the
        host."""
        prog = self._bucket_program(padded.shape[1])
        prog.stage(ids=padded, last=last, slot=slot)
        return prog.fetch(prog())

    def _admit(self):
        """Dense admission: each free slot takes the next live queued
        request with one bucket-padded prefill."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        while free and not self._pending.empty():
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                return
            if req.future.done():
                continue  # cancelled by the caller
            if req.deadline is not None and self._clock() > req.deadline:
                self._counts["expired"] += 1
                _fail_future(req.future, DeadlineExceededError(
                    "request deadline expired while queued for admission"))
                continue
            slot = free.pop(0)
            try:
                self._admit_one(req, slot)
            except Exception as e:
                self.slot_req[slot] = None
                self._release_pages(slot)
                free.insert(0, slot)
                _fail_future(req.future, e)

    def _admit_one(self, req, slot):
        n = req.prompt.size
        Lb = self._bucket(n)
        padded = np.full((1, Lb), self.pad, np.int64)
        padded[0, :n] = req.prompt
        t0 = time.perf_counter()
        row = self._bucket_call(padded, n - 1, slot)
        self._seconds["prefill"] += time.perf_counter() - t0
        self._counts["prefill_chunks"] += 1
        self._bucket_counts[Lb] = self._bucket_counts.get(Lb, 0) + 1
        self._activate(slot, req, self._host_select(row, req))

    def _activate(self, slot, req, tok):
        """A prefill's last position gave the request's next token: the
        slot starts decoding (or finishes at once)."""
        first = not req.tokens  # a re-admission after preemption continues
        req.tokens.append(tok)
        self.slot_req[slot] = req
        self.slot_pos[slot] = req.prompt.size
        self.last_token[slot] = tok
        self._counts["admitted"] += 1
        if first and req.submit_ts is not None:
            self._ttfts.append(max(0.0, self._clock() - req.submit_ts))
        if tok == self.eos or len(req.tokens) >= req.max_new_tokens:
            self._finish(slot)

    # ---------------------------------------------------- paged admission

    def _pop_admission_request(self):
        """The next request to admit: FIFO, or with cache-aware admission
        the one of the first 8 queued with the longest cached prefix (FIFO
        on ties; matches memoized per request and prefix epoch).  Each
        request passed over ages by one; a queue head aged
        ``admission_age_cap`` admits next whatever its affinity."""
        if not self.cache_aware:
            try:
                return self._pending.get_nowait()
            except queue.Empty:
                return None
        with self._pending.mutex:
            q = self._pending.queue
            if not q:
                return None
            best, best_hit = 0, -1
            if q[0].adm_skips < self.admission_age_cap:
                for idx in range(min(len(q), 8)):
                    r = q[idx]
                    hit = 0
                    if not r.skip_cache:
                        hit = self._match(r)[0]
                    if hit > best_hit:
                        best, best_hit = idx, hit
            req = q[best]
            del q[best]
            if best:
                for idx in range(best):
                    q[idx].adm_skips += 1
                self._adm_reorders += 1
            self._pending.not_full.notify()
            return req

    def _match(self, req):
        """The prefix cache's (matched tokens, pages) for a request's prompt,
        memoized until the cache's epoch moves (a head-of-line request
        waiting on a full pool does not rehash its prompt every tick)."""
        if req.match_epoch != self._prefix_epoch or req.match_result is None:
            req.match_result = self._prefix.match(req.prompt, adapter_id=req.adapter_id)
            req.match_epoch = self._prefix_epoch
        return req.match_result

    def _start_prefill(self):
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        while free and not self._pending.empty():
            req = self._pop_admission_request()
            if req is None:
                return
            if req.future.done():
                continue  # cancelled by the caller
            if req.deadline is not None and self._clock() > req.deadline:
                self._counts["expired"] += 1
                _fail_future(req.future, DeadlineExceededError(
                    "request deadline expired while queued for admission"))
                continue
            need = pages_for(req.prompt.size + 1, self.ps)
            if self._host_kv is not None and not req.skip_cache and len(self._host_kv):
                # re-upload the prompt's demoted blocks first; the promotion
                # moves the prefix epoch, so the match below sees them
                self._promote_from_tiers(req)
            matched, shared = 0, []
            if self._prefix is not None and not req.skip_cache:
                matched, shared = self._match(req)
            if need > self.num_pages - 1:
                # the TOTAL need: cached pages occupy the same pool, so a
                # table longer than the pool can never complete
                self._counts["shed"] += 1
                _fail_future(req.future, ServerOverloadedError(
                    f"prompt needs {need} kv pages but the pool only has "
                    f"{self.num_pages - 1}; rejected"))
                continue
            slot = free[0]
            if shared:
                # map the cached prefix into the slot's table; admission is
                # charged only for the pages past it
                for p in shared:
                    # the holds pass to the slot's table: _release_pages drops them
                    self._incref(p)  # tpulint: disable=refcount-balance (handed to the slot)
                self._slot_pages[slot] = list(shared)
                self._pt_host[slot, :len(shared)] = shared
            if not self._alloc_pages(slot, need - len(shared)):
                # admission by free pages: the head waits for reclamation,
                # its shared holds rolled back so the cache stays evictable
                self._release_pages(slot)
                with self._pending.mutex:
                    self._pending.queue.appendleft(req)
                return
            if req.adapter_id is not None and not req.adapter_page:
                page = self.adapters.acquire(req.adapter_id)
                if page is None:
                    # every adapter page is pinned by live requests: wait at
                    # the head for a release, as for kv pages, the kv holds
                    # rolled back so the pool stays reclaimable
                    self._release_pages(slot)
                    with self._pending.mutex:
                        self._pending.queue.appendleft(req)
                    return
                req.adapter_page = page
            if not req.admitted:
                req.admitted = True
                self._prefix_prompt_tokens += int(req.prompt.size)
                self._prefix_hit_tokens += int(matched)
                req.hit_tokens = int(matched)
                if self._host_kv is not None:
                    # what the promotion above did not supply was in HBM
                    self._tier_hit_tokens["hbm"] += max(0, int(matched) - req.tier_hit_tokens)
            # the chunked prefill starts at the first uncached token
            self._prefilling = (req, slot, matched)
            return

    def _prefill_tick(self):
        """Run ONE prefill chunk of the admitting request; on the final chunk
        emit the first token and activate the slot."""
        req, slot, done = self._prefilling
        if req.future.done() or (req.deadline is not None
                                 and self._clock() > req.deadline):
            self._prefilling = None
            self._release_pages(slot)
            self._release_adapter(req)
            if not req.future.done():
                self._counts["expired"] += 1
                _fail_future(req.future, DeadlineExceededError(
                    f"request deadline exceeded after {done} prefilled prompt tokens"))
            return
        n = req.prompt.size
        C = self.prefill_chunk
        m = min(C, n - done)
        if self._prefix is not None and not self._cow_page(slot, done // self.ps):
            # the chunk would write into a page others still read and no
            # page can be had for the fork: requeue, to prefill privately
            self._release_pages(slot)
            self._release_adapter(req)
            req.skip_cache = True
            self._prefix_hit_tokens -= req.hit_tokens  # the hit never happened
            req.hit_tokens = 0
            self._counts["preemptions"] += 1
            self._count_recompute("prefill_cow", int(n))
            with self._pending.mutex:
                self._pending.queue.appendleft(req)
            self._prefilling = None
            return
        chunk = np.full((1, C), self.pad, np.int64)
        chunk[0, :m] = req.prompt[done:done + m]
        rows = self._lora_rows([req])
        t0 = time.perf_counter()
        try:
            # the logits row is read on the final chunk only
            row = self._prefill_call(chunk, done, self._pt_host[slot:slot + 1], m - 1, rows,
                                     read=done + m >= n)
        except Exception as e:
            self._prefilling = None
            self._release_pages(slot)
            self._release_adapter(req)
            _fail_future(req.future, e)
            return
        self._seconds["prefill"] += time.perf_counter() - t0
        self._counts["prefill_chunks"] += 1
        done += m
        if done < n:
            self._prefilling = (req, slot, done)
            return
        # the slot's pages hold the whole prompt: index them, before the
        # first decode write (whose COW check then sees the tail shared)
        self._cache_insert(slot, req.prompt, req.adapter_id)
        self._prefilling = None
        self._activate(slot, req, self._host_select(row, req))

    def _prefill_program(self, lora):
        """The paged chunk prefill, ONE program for every offset and prompt
        length (the reference's ``_prefill_jit["chunk"]``): ``C`` tokens
        written at ``pos`` through the slot's table row, the logits at the
        device index ``last``."""
        def build():
            def body(ids, pos, table, last, rows=None):
                with torch.no_grad(), self._lora_scope(rows):
                    logits, _ = self.model.prefill_chunk_step(
                        ids, self._paged_caches(pos, table), last)
                    return logits[0, 0].float()

            ins = dict(ids=torch.full((1, self.prefill_chunk), self.pad, dtype=torch.int64),
                       pos=torch.zeros(1, dtype=torch.int64),
                       table=torch.zeros((1, self.M), dtype=torch.int32),
                       last=torch.zeros(1, dtype=torch.int64))
            if lora:
                ins["rows"] = torch.zeros(1, dtype=torch.int64)
            return Program(self.programs, key, body, ins)

        key = ("chunk", bool(lora))
        return self.programs.get(key, build)

    def _prefill_call(self, chunk, done, table_row, last, rows, read):
        """Run one chunk; its logits row on the host when ``read`` (else
        None, once the chunk is done)."""
        prog = self._prefill_program(rows is not None)
        prog.stage(ids=chunk, pos=done, table=table_row, last=last,
                   **({} if rows is None else {"rows": rows}))
        out = prog()
        if read:
            return prog.fetch(out)
        prog.wait()
        return None

    def _host_select(self, row, req):
        """First (admission) token on the host: the reference's order
        (constraint mask -> temperature -> top-k by VALUE -> top-p over the
        survivors); a constrained request's automaton advances past it."""
        if req.cursor is not None:
            row = np.where(req.cursor.mask(), row, -np.inf)
        tok = self._host_draw(row, req)
        self._advance_cursor(req, tok)
        return tok

    def _host_draw(self, row, req):
        if not req.do_sample:
            return int(row.argmax())
        lt = row.astype(np.float64) / max(req.temperature, 1e-6)
        if 0 < req.top_k < row.size:
            kth = np.sort(lt)[::-1][req.top_k - 1]
            lt = np.where(lt < kth, -np.inf, lt)
        s = np.sort(lt)[::-1]
        e = np.exp(s - s.max())
        cum = np.cumsum(e / e.sum())
        cutoff = s[min(int((cum < req.top_p).sum()), s.size - 1)]
        lt = np.where(lt < cutoff, -np.inf, lt)
        p = np.exp(lt - lt.max())
        return int(self._rng.choice(row.size, p=p / p.sum()))

    def _step_locked(self):
        self._expire_queued()
        self._expire_slots()
        if not self.paged:
            self._admit()
        else:
            if self._prefilling is None:
                self._start_prefill()
            if self._prefilling is not None:
                self._prefill_tick()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        # decode_chunk steps per tick, staying inside the cache: slots AT
        # capacity were finished by the previous tick, so headroom >= 1
        headroom = self.L - 1 - int(self.slot_pos[active].max())
        if self.spec_k and headroom >= self.spec_k:
            # a verify writes rows pos .. pos + K; the last strides before
            # capacity decode one token at a time below
            return self._spec_tick(active)
        eff = max(1, min(self.decode_chunk, headroom))
        if any(r is not None and r.cursor is not None for r in self.slot_req):
            # an automaton moves a token at a time, and a tick's mask holds
            # for all its steps
            eff = 1
        pt = None
        if self.paged:
            # grow page tables to cover this tick's writes; slots the pool
            # cannot cover are preempted
            active = self._ensure_decode_pages(active, eff)
            if not active:
                return 0
            pt = self._active_table()
        t0 = time.perf_counter()
        nxt = self._decode(self.last_token.astype(np.int64)[:, None],
                           self.slot_pos.astype(np.int64), self.slot_req, eff, pt,
                           self._lora_rows(self.slot_req))
        self._seconds["decode"] += time.perf_counter() - t0
        self._counts["decode_ticks"] += 1
        self._counts["decode_steps"] += eff
        emitted = 0
        for j in range(eff):
            for i in active:
                req = self.slot_req[i]
                if req is None:
                    continue  # finished earlier in this chunk: surplus
                tok = int(nxt[i, j])
                req.tokens.append(tok)
                self._advance_cursor(req, tok)
                self.last_token[i] = tok
                self.slot_pos[i] += 1
                emitted += 1
                if (tok == self.eos or len(req.tokens) >= req.max_new_tokens
                        or self.slot_pos[i] >= self.L - 1):
                    self._finish(i)
        self._counts["decode_tokens"] += emitted
        return emitted

    def _active_table(self):
        """The page table a decode or verify call sees (host), with INACTIVE
        slots masked to the trash page: a mid-prefill slot already owns real
        pages, and the call's garbage scatter for it must not clobber its
        prompt rows."""
        pt = self._pt_host.copy()
        for i, r in enumerate(self.slot_req):
            if r is None:
                pt[i, :] = 0
        return pt

    def _knobs(self, reqs):
        """Per-slot sampling knobs as host arrays (do_sample, temperature,
        top_k, top_p); idle slots are greedy."""
        return dict(do_sample=np.array([r is not None and r.do_sample for r in reqs]),
                    temperature=np.array([r.temperature if r is not None else 1.0
                                          for r in reqs], np.float32),
                    top_k=np.array([r.top_k if r is not None else 0 for r in reqs], np.int32),
                    top_p=np.array([r.top_p if r is not None else 1.0 for r in reqs],
                                   np.float32))

    def _slot_inputs(self, lora):
        """Initial values of the per-slot inputs of a decode or verify
        program: positions, knobs, the page table (paged), the adapter
        rows (the LoRA variant)."""
        B = self.n_slots
        ins = dict(pos=torch.zeros(B, dtype=torch.int64),
                   do_sample=torch.zeros(B, dtype=torch.bool), temperature=torch.ones(B),
                   top_k=torch.zeros(B, dtype=torch.int32), top_p=torch.ones(B))
        if self.paged:
            ins["table"] = torch.zeros((B, self.M), dtype=torch.int32)
        if lora:
            ins["rows"] = torch.zeros(B, dtype=torch.int64)
        return ins

    def _slot_values(self, pos, reqs, page_tbl, rows):
        """This call's values of ``_slot_inputs``."""
        vals = dict(pos=pos, **self._knobs(reqs))
        if self.paged:
            vals["table"] = page_tbl
        if rows is not None:
            vals["rows"] = rows
        return vals

    def _caches_at(self, pos, table):
        return self._paged_caches(pos, table) if self.paged else self._dense_caches(pos)

    def _decode_program(self, steps, lora):
        """``steps`` decode steps for every slot (the reference's
        ``_decode_jit[steps]``), the token mask always an input."""
        def build():
            def body(tok, pos, do_sample, temperature, top_k, top_p, mask, table=None,
                     rows=None):
                knobs = (do_sample, temperature, top_k, top_p)
                out = []
                with torch.no_grad(), self._lora_scope(rows):
                    for _ in range(steps):
                        logits, _ = self.model.generate_step(tok, caches=self._caches_at(pos, table))
                        nxt = sample_rows(logits[:, -1], self._gen, *knobs, mask)
                        out.append(nxt)
                        tok, pos = nxt[:, None].long(), pos + 1
                return torch.stack(out, dim=1)

            B = self.n_slots
            ins = dict(tok=torch.full((B, 1), self.pad, dtype=torch.int64),
                       **self._slot_inputs(lora),
                       mask=torch.ones((B, self._vocab), dtype=torch.bool))
            return Program(self.programs, key, body, ins, generators=(self._gen,))

        key = ("decode", int(steps), bool(lora))
        return self.programs.get(key, build)

    def _decode(self, tokens, pos, reqs, steps, page_tbl, rows=None):
        """``steps`` decode steps for every slot (idle ones included, on
        garbage that no live row reads), each step's tokens selected on
        the device per the slot's knobs and fed to the next step; ``rows``
        the adapter pages (the LoRA variant) or None.  Returns the selected
        ids [B, steps] on the host: the call's one sync."""
        prog = self._decode_program(steps, rows is not None)
        self._stage_mask(prog, reqs)
        prog.stage(tok=tokens, **self._slot_values(pos, reqs, page_tbl, rows))
        return prog.fetch(prog()).astype(np.int32)

    def _verify_program(self, lora):
        """The speculative verify (the reference's ``_verify_jit``): every
        slot scores [last token, K drafts] and ``spec_accept`` decides."""
        K = self.spec_k

        def build():
            def body(ids, drafts, pos, do_sample, temperature, top_k, top_p, table=None,
                     rows=None):
                with torch.no_grad(), self._lora_scope(rows):
                    logits, _ = self.model.verify_step(ids, self._caches_at(pos, table))
                    out, n_acc = spec_accept(logits, drafts, self._gen, do_sample,
                                             temperature, top_k, top_p)
                    return torch.cat([out, n_acc[:, None]], dim=1)

            B = self.n_slots
            ins = dict(ids=torch.zeros((B, K + 1), dtype=torch.int64),
                       drafts=torch.zeros((B, K), dtype=torch.int32), **self._slot_inputs(lora))
            return Program(self.programs, key, body, ins, generators=(self._gen,))

        key = ("verify", K, bool(lora))
        return self.programs.get(key, build)

    def _verify(self, last, pos, drafts, reqs, page_tbl, rows=None):
        """One verify call for the whole pool: every slot scores [last token,
        K drafts] at rows pos .. pos + K (idle slots on garbage no live row
        reads) and ``spec_accept`` decides on the device.  Returns (out
        [B, K+1], n_accept [B]) on the host: the call's one sync."""
        prog = self._verify_program(rows is not None)
        prog.stage(ids=np.concatenate([last[:, None], drafts], axis=1), drafts=drafts,
                   **self._slot_values(pos, reqs, page_tbl, rows))
        both = prog.fetch(prog()).astype(np.int32)
        return both[:, :-1], both[:, -1]

    def _spec_tick(self, active):
        """One speculative tick: draft K tokens a slot on the host, one
        verify call, emit each slot's accepted drafts and its correction
        token, then roll back: the slot's position stops at the accept
        point and (paged) the pages holding only rejected rows go back to
        the pool."""
        K = self.spec_k
        pt = None
        if self.paged:
            # grow (and fork) the tables for all K + 1 rows; a slot the pool
            # cannot cover is preempted, as in decode
            active = self._ensure_decode_pages(active, K + 1, origin="verify")
            if not active:
                return 0
            pt = self._active_table()
        t0 = time.perf_counter()
        drafts = np.zeros((self.n_slots, K), np.int32)
        for i in active:
            req = self.slot_req[i]
            drafts[i] = self._drafter.propose(
                np.concatenate([req.prompt, np.asarray(req.tokens[req.folded:], np.int32)]), K)
        out, n_acc = self._verify(self.last_token, self.slot_pos, drafts, self.slot_req, pt,
                                  self._lora_rows(self.slot_req))
        self._seconds["decode"] += time.perf_counter() - t0
        emitted = accepted = rb_pages = 0
        for i in active:
            req = self.slot_req[i]
            if req is None:
                continue
            accepted += int(n_acc[i])
            # the accepted drafts, then the correction or bonus token
            for j in range(int(n_acc[i]) + 1):
                tok = int(out[i, j])
                req.tokens.append(tok)
                self.last_token[i] = tok
                self.slot_pos[i] += 1
                emitted += 1
                if (tok == self.eos or len(req.tokens) >= req.max_new_tokens
                        or self.slot_pos[i] >= self.L - 1):
                    self._finish(i)
                    break
            if self.paged and self.slot_req[i] is not None:
                rb_pages += self._trim_rollback_pages(i)
        drafted = K * len(active)
        sp = self._spec
        sp["drafted"] += drafted
        sp["accepted"] += accepted
        sp["rolled_back"] += drafted - accepted
        sp["rolled_back_pages"] += rb_pages
        sp["verify_calls"] += 1
        self._counts["decode_tokens"] += emitted
        return emitted

    def _expire_queued(self):
        """Fail expired (or drop caller-cancelled) requests anywhere in the
        queue, in place under the queue's own mutex."""
        now = self._clock()
        expired = []
        with self._pending.mutex:
            keep = []
            for req in self._pending.queue:
                if req.future.done():
                    continue
                if req.deadline is not None and now > req.deadline:
                    expired.append(req)
                else:
                    keep.append(req)
            if len(keep) != len(self._pending.queue):
                self._pending.queue.clear()
                self._pending.queue.extend(keep)
                self._pending.not_full.notify_all()
        for req in expired:
            self._counts["expired"] += 1
            _fail_future(req.future, DeadlineExceededError(
                "request deadline expired while queued for admission"))

    def _expire_slots(self):
        for i, req in enumerate(self.slot_req):
            if req is not None and req.deadline is not None \
                    and self._clock() > req.deadline:
                self.slot_req[i] = None
                self.last_token[i] = self.pad
                self._release_pages(i)
                self._release_adapter(req)
                self._counts["expired"] += 1
                _fail_future(req.future, DeadlineExceededError(
                    f"request deadline exceeded after {len(req.tokens)} "
                    "generated tokens"))

    def _finish(self, slot):
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.last_token[slot] = self.pad
        self._release_pages(slot)
        self._release_adapter(req)
        if req is not None:
            self._counts["completed"] += 1
            _complete_future(req.future, list(req.tokens))
