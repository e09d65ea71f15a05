"""Continuous-batching LLM serving engine (counterpart of the dense and
paged subsets of paddle_tpu/inference/llm_server.py).

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
  attention call is the ragged paged kernel.

Completion by eos / max tokens / capacity frees the slot (and its pages).
The reference compiles its prefill and decode programs with jax.jit and
donates the caches; here both are eager PyTorch and the caches update in
place.  ``step()`` pumps one tick; ``run_until_complete()`` drains;
``start()`` spawns the background pump.  Greedy tokens equal the reference
engine's on the same weights (tests/test_torch_engine.py).

Not ported yet, and raising NotImplementedError (ROADMAP.md Queue 1 items
2 and 5): the prefix cache (pass ``prefix_cache=False`` on the paged
layout), speculative decoding, LoRA adapters, constraints, kv tiers and
the metrics exporter.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from ..framework.random import get_generator
from ..models.kv_cache import _quantize_kv, pages_for
from ..ops.sampling import sample_rows

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


class LLMEngine:
    def __init__(self, model, max_batch_slots=4, max_seq_len=512,
                 cache_dtype=None, eos_token_id=None, pad_token_id=0,
                 prompt_buckets=(32, 64, 128, 256),
                 decode_chunk=1, max_queue_len=None, clock=None,
                 kv_layout=None, page_size=128, num_pages=None,
                 prefill_chunk=None, prefix_cache=None, metrics_port=None,
                 spec_k=0, adapters=None, host_cache_pages=0,
                 generator=None):
        """Arguments as in the reference engine.  The paged layout needs
        ``prefix_cache=False``; the dense one ignores ``page_size``,
        ``num_pages`` and ``prefill_chunk``.  ``num_pages`` defaults to full
        capacity (slots * max_seq_len / page_size + the trash page); size
        it smaller to oversubscribe (preemption then recomputes).
        ``decode_chunk`` decode steps run per tick (fewer near capacity).
        ``generator`` is the torch.Generator sampled rows draw from
        (default: the seeded generator of the model's device)."""
        if kv_layout not in (None, "dense", "paged"):
            raise ValueError(
                f"kv_layout must be None, 'dense' or 'paged', got {kv_layout!r}")
        self.paged = kv_layout == "paged"
        if not self.paged and prefix_cache:
            raise ValueError("prefix_cache requires kv_layout='paged' (sharing "
                             "rides on the page tables)")
        if self.paged and prefix_cache is not False:
            raise _not_ported("the prefix cache (pass prefix_cache=False)",
                              "prefix cache, spec decode, LoRA, constraints")
        if spec_k:
            raise _not_ported("speculative decoding (spec_k)",
                              "prefix cache, spec decode, LoRA, constraints")
        if adapters is not None:
            raise _not_ported("LoRA adapters",
                              "prefix cache, spec decode, LoRA, constraints")
        if host_cache_pages:
            raise _not_ported("the host/disk kv tiers",
                              "prefix cache, spec decode, LoRA, constraints")
        if metrics_port is not None:
            raise _not_ported("the metrics exporter", "serving plane")
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
        if self.paged:
            # host-side allocator: page 0 is the trash page, never handed
            # out; pop() order is deterministic (highest id first), as the
            # reference
            self._free_pages = list(range(1, P))
            self._page_ref = np.zeros(P, np.int32)
            self._slot_pages: list[list[int]] = [[] for _ in range(B)]
            self._pt_host = np.zeros((B, self.M), np.int32)
            self._pt_dev = torch.from_numpy(self._pt_host).to(dev)
            self._pt_dirty = False
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
        self._counts = dict(submitted=0, admitted=0, completed=0, shed=0,
                            expired=0, preemptions=0, prefill_chunks=0,
                            decode_ticks=0, decode_steps=0, decode_tokens=0,
                            recompute_tokens=0)
        self._bucket_counts: dict[int, int] = {}
        self._seconds = dict(prefill=0.0, decode=0.0)
        self._ttfts: list[float] = []

    # ------------------------------------------------------------- public

    def submit(self, prompt_ids, max_new_tokens=32, do_sample=False,
               temperature=1.0, top_k=0, top_p=1.0, timeout=None,
               adapter_id=None, constraint=None):
        """Queue one prompt; returns a Future of the generated id list.
        Sampling knobs are per request.  ``timeout`` (seconds) sets a
        deadline; a full queue raises ServerOverloadedError."""
        if adapter_id is not None:
            raise _not_ported("adapter_id", "prefix cache, spec decode, LoRA, constraints")
        if constraint is not None:
            raise _not_ported("constraint", "prefix cache, spec decode, LoRA, constraints")
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
        now = self._clock()
        req = _Request(arr, int(max_new_tokens), Future(),
                       do_sample=bool(do_sample), temperature=float(temperature),
                       top_k=int(top_k), top_p=float(top_p),
                       deadline=(now + float(timeout)) if timeout is not None else None,
                       submit_ts=now)
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

    def generate(self, prompt_ids, max_new_tokens=32, **sampling):
        """Blocking single-prompt convenience."""
        fut = self.submit(prompt_ids, max_new_tokens, **sampling)
        self.run_until_complete()
        return fut.result()

    def run_until_complete(self):
        """Pump ticks until the queue and all slots drain."""
        while not self._pending.empty() \
                or any(r is not None for r in self.slot_req) \
                or self._prefilling is not None:
            self.step()

    def stats(self):
        """Engine-local counters and timings (host clock around work that
        ends in a device sync)."""
        ttft = np.asarray(self._ttfts, np.float64)
        layout = ({"kv_pages_in_use": int((self._page_ref > 0).sum()),
                   "kv_pages_total": self.num_pages - 1} if self.paged else
                  {"prefill_buckets": dict(sorted(self._bucket_counts.items()))})
        return {
            **self._counts,
            **layout,
            "queue_depth": self._pending.qsize(),
            "active_slots": sum(r is not None for r in self.slot_req),
            "n_slots": self.n_slots,
            "kv_layout": self.kv_layout,
            "prefill_seconds": self._seconds["prefill"],
            "decode_seconds": self._seconds["decode"],
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
            self._stop = False

    def warmup(self):
        """Run every prefill shape once, then one decode call at the
        configured ``decode_chunk``, against the idle caches, so the first
        request pays no kernel build or first-launch cost: one prefill
        chunk (paged; garbage rows land in the trash page), or each prompt
        bucket's prefill and slot write (dense; admission rewrites the
        rows).  Returns the wall seconds."""
        t0 = time.perf_counter()
        with self._lock:
            if self._prefilling is not None or any(r is not None for r in self.slot_req):
                raise RuntimeError("warmup() requires an idle engine")
            dev, B = self.device, self.n_slots
            with torch.no_grad():
                if self.paged:
                    ids = torch.full((1, self.prefill_chunk), self.pad,
                                     dtype=torch.int64, device=dev)
                    zero_row = torch.zeros((1, self.M), dtype=torch.int32, device=dev)
                    self.model.prefill_chunk_step(
                        ids, self._paged_caches(torch.zeros(1, dtype=torch.int64, device=dev),
                                                zero_row), 0)
                else:
                    for Lb in self.buckets:
                        ids = torch.full((1, Lb), self.pad, dtype=torch.int64, device=dev)
                        _, kvs = self.model.prefill_step(ids, Lb - 1)
                        self._write_slot(0, kvs)
                tok = np.full((B, 1), self.pad, np.int64)
                self._decode(tok, np.zeros(B, np.int64), [None] * B,
                             max(1, min(self.decode_chunk, self.L - 1)),
                             torch.zeros((B, self.M), dtype=torch.int32, device=dev)
                             if self.paged else None)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
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
                if self._pending.empty() and self._prefilling is None \
                        and all(r is None for r in self.slot_req):
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
                _fail_future(req.future, exc)
            for i, req in enumerate(self.slot_req):
                if req is not None:
                    self.slot_req[i] = None
                    self.last_token[i] = self.pad
                    self._release_pages(i)
                    _fail_future(req.future, exc)

    # ---------------------------------------------------- paged internals

    def _pt_device(self):
        """Device copy of the page table, uploaded at most once per consumer."""
        if self._pt_dirty:
            self._pt_dev = torch.from_numpy(self._pt_host).to(self.device)
            self._pt_dirty = False
        return self._pt_dev

    def _paged_caches(self, pos, page_tbl):
        """Per-layer paged tuples (k, v, pos, tbl[, ks, vs]) over the pools."""
        return [(c[0], c[1], pos, page_tbl) + tuple(c[2:]) for c in self.caches]

    def _decref(self, page):
        r = int(self._page_ref[page]) - 1
        if r < 0:
            raise AssertionError(f"kv page {page} decref below zero")
        self._page_ref[page] = r
        if r == 0:
            self._free_pages.append(page)

    def _release_pages(self, slot):
        """Reset a slot's length, so that while it is idle a decode tick's
        kernel reads one key of it and writes rows 0.. of its own buffer
        (dense) or of the trash page (paged); free every page it holds and
        point its table row at the trash page (finish / expiry / preemption
        / stop)."""
        self.slot_pos[slot] = 0
        if not self.paged or not self._slot_pages[slot]:
            return
        for page in self._slot_pages[slot]:
            self._decref(page)
        self._slot_pages[slot] = []
        self._pt_host[slot, :] = 0
        self._pt_dirty = True

    def _alloc_pages(self, slot, n):
        """Move n free pages into a slot's table; False (allocating nothing)
        when the pool cannot cover them."""
        if n <= 0:
            return True
        if len(self._free_pages) < n:
            return False
        for _ in range(n):
            page = self._free_pages.pop()
            self._page_ref[page] = 1
            self._pt_host[slot, len(self._slot_pages[slot])] = page
            self._slot_pages[slot].append(page)
        self._pt_dirty = True
        return True

    def _preempt_slot(self, slot):
        """Recompute-style preemption: reclaim the slot's pages and REQUEUE
        its request at the head with the generated tokens appended to the
        prompt.  A request already holding the whole pool can never fit and
        fails with ServerOverloadedError."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.last_token[slot] = self.pad
        held = len(self._slot_pages[slot])
        self._release_pages(slot)
        self._counts["preemptions"] += 1
        if req is None:
            return
        if held >= self.num_pages - 1:
            _fail_future(req.future, ServerOverloadedError(
                f"request needs more kv pages than the whole pool "
                f"({self.num_pages - 1} pages x {self.ps} tokens); rejected"))
            return
        req.prompt = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])
        self._counts["recompute_tokens"] += int(req.prompt.size)
        with self._pending.mutex:
            self._pending.queue.appendleft(req)

    def _ensure_decode_pages(self, active, eff):
        """Grow each active slot's table to cover this tick's writes;
        preempt the slots the pool cannot cover.  Returns the survivors."""
        out = []
        for i in active:
            last = (int(self.slot_pos[i]) + eff - 1) // self.ps
            if self._alloc_pages(i, last + 1 - len(self._slot_pages[i])):
                out.append(i)
            else:
                self._preempt_slot(i)
        return out

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
        [0, Lb) of a slot's static buffers (quantized for int8)."""
        for c, (k, v) in zip(self.caches, kvs, strict=True):
            Lb = k.shape[1]
            for buf, sbuf, kv in ((c[0], c[2] if len(c) == 4 else None, k),
                                  (c[1], c[3] if len(c) == 4 else None, v)):
                hm = kv.transpose(1, 2)  # [1, H, Lb, D]
                if sbuf is None:
                    buf[slot:slot + 1, :, :Lb] = hm
                else:
                    q, scale = _quantize_kv(hm)
                    buf[slot:slot + 1, :, :Lb] = q
                    sbuf[slot:slot + 1, :, :Lb] = scale

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
        dev = self.device
        t0 = time.perf_counter()
        with torch.no_grad():
            # causal attention: positions >= n never influence position
            # n - 1, so the padded prefill's first n k/v rows are exact
            logits, kvs = self.model.prefill_step(torch.from_numpy(padded).to(dev), n - 1)
            row = logits[0, 0].float().cpu().numpy()
            self._write_slot(slot, kvs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
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

    def _start_prefill(self):
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
            need = pages_for(req.prompt.size + 1, self.ps)
            if need > self.num_pages - 1:
                self._counts["shed"] += 1
                _fail_future(req.future, ServerOverloadedError(
                    f"prompt needs {need} kv pages but the pool only has "
                    f"{self.num_pages - 1}; rejected"))
                continue
            slot = free[0]
            if not self._alloc_pages(slot, need):
                # admission by free pages: the head waits for reclamation
                with self._pending.mutex:
                    self._pending.queue.appendleft(req)
                return
            self._prefilling = (req, slot, 0)
            return

    def _prefill_tick(self):
        """Run ONE prefill chunk of the admitting request; on the final chunk
        emit the first token and activate the slot."""
        req, slot, done = self._prefilling
        if req.future.done() or (req.deadline is not None
                                 and self._clock() > req.deadline):
            self._prefilling = None
            self._release_pages(slot)
            if not req.future.done():
                self._counts["expired"] += 1
                _fail_future(req.future, DeadlineExceededError(
                    f"request deadline exceeded after {done} prefilled prompt tokens"))
            return
        n = req.prompt.size
        C = self.prefill_chunk
        m = min(C, n - done)
        chunk = np.full((1, C), self.pad, np.int64)
        chunk[0, :m] = req.prompt[done:done + m]
        dev = self.device
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                logits, _ = self.model.prefill_chunk_step(
                    torch.from_numpy(chunk).to(dev),
                    self._paged_caches(torch.tensor([done], dtype=torch.int64, device=dev),
                                       self._pt_device()[slot:slot + 1]),
                    m - 1)
                row = logits[0, 0].float().cpu().numpy() if done + m >= n else None
        except Exception as e:
            self._prefilling = None
            self._release_pages(slot)
            _fail_future(req.future, e)
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._seconds["prefill"] += time.perf_counter() - t0
        self._counts["prefill_chunks"] += 1
        done += m
        if done < n:
            self._prefilling = (req, slot, done)
            return
        self._prefilling = None
        self._activate(slot, req, self._host_select(row, req))

    def _host_select(self, row, req):
        """First (admission) token on the host: the reference's order
        (temperature -> top-k by VALUE -> top-p over the survivors)."""
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
        eff = max(1, min(self.decode_chunk, headroom))
        pt = None
        if self.paged:
            # grow page tables to cover this tick's writes; slots the pool
            # cannot cover are preempted
            active = self._ensure_decode_pages(active, eff)
            if not active:
                return 0
            # decode sees a table with INACTIVE slots masked to the trash
            # page: a mid-prefill slot already owns real pages, and the
            # shared step's garbage scatter for it must not clobber its
            # prompt rows
            pt = self._pt_host.copy()
            for i, r in enumerate(self.slot_req):
                if r is None:
                    pt[i, :] = 0
            pt = torch.from_numpy(pt).to(self.device)
        t0 = time.perf_counter()
        nxt = self._decode(self.last_token.astype(np.int64)[:, None],
                           self.slot_pos.astype(np.int64), self.slot_req, eff, pt)
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
                self.last_token[i] = tok
                self.slot_pos[i] += 1
                emitted += 1
                if (tok == self.eos or len(req.tokens) >= req.max_new_tokens
                        or self.slot_pos[i] >= self.L - 1):
                    self._finish(i)
        self._counts["decode_tokens"] += emitted
        return emitted

    def _decode(self, tokens, pos, reqs, steps, page_tbl):
        """``steps`` decode steps for every slot (idle ones included, on
        garbage that no live row reads), each step's tokens selected on
        the device per the slot's knobs and fed to the next step.  Returns
        the selected ids [B, steps] on the host: the call's one sync."""
        dev = self.device
        do_s = torch.tensor([r is not None and r.do_sample for r in reqs], device=dev)
        temp = torch.tensor([r.temperature if r is not None else 1.0 for r in reqs],
                            dtype=torch.float32, device=dev)
        topk = torch.tensor([r.top_k if r is not None else 0 for r in reqs],
                            dtype=torch.int32, device=dev)
        topp = torch.tensor([r.top_p if r is not None else 1.0 for r in reqs],
                            dtype=torch.float32, device=dev)
        tok = torch.from_numpy(tokens).to(dev)
        p = torch.from_numpy(pos).to(dev)
        out = []
        with torch.no_grad():
            for _ in range(steps):
                caches = (self._paged_caches(p, page_tbl) if self.paged
                          else self._dense_caches(p))
                logits, _ = self.model.generate_step(tok, caches=caches)
                nxt = sample_rows(logits[:, -1], self._gen, do_s, temp, topk, topp)
                out.append(nxt)
                tok, p = nxt[:, None].long(), p + 1
        return torch.stack(out, dim=1).cpu().numpy().astype(np.int32)

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
                self._counts["expired"] += 1
                _fail_future(req.future, DeadlineExceededError(
                    f"request deadline exceeded after {len(req.tokens)} "
                    "generated tokens"))

    def _finish(self, slot):
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.last_token[slot] = self.pad
        self._release_pages(slot)
        if req is not None:
            self._counts["completed"] += 1
            _complete_future(req.future, list(req.tokens))
