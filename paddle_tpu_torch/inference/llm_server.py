"""Continuous-batching LLM serving engine on the PAGED kv cache
(counterpart of the paged subset of paddle_tpu/inference/llm_server.py).

- a fixed pool of batch slots over a global page pool [P, Hkv, ps, D]
  (bf16/f32, or int8 + f32 scale pools) plus per-slot page tables; page 0
  is the trash page (models/kv_cache.py);
- admission by FREE PAGES: the queue head waits until reclamation frees
  enough pages for its prompt + first decode token;
- CHUNKED PREFILL: one ``prefill_chunk``-token chunk per tick, interleaved
  with decode ticks, so a long prompt never stalls running slots for more
  than one chunk;
- one decode step per tick for the whole pool: each slot carries its own
  position, and the ragged paged-attention kernel masks per slot;
- RECOMPUTE PREEMPTION: a slot whose next token finds no free page is
  requeued with its generated tokens appended to its prompt, so
  re-admission re-prefills and greedy decoding continues where it stopped;
- completion by eos / max tokens frees the slot and its pages.

The reference compiles its prefill-chunk and decode programs with jax.jit
and donates the pools; here both are eager PyTorch and the pools update in
place.  ``step()`` pumps one tick; ``run_until_complete()`` drains;
``start()`` spawns the background pump.  Greedy tokens equal the reference
engine's on the same weights (tests/test_torch_engine.py).

Not ported yet, and raising NotImplementedError (ROADMAP.md Queue 1): the
dense ``kv_layout``, the prefix cache (pass ``prefix_cache=False``),
speculative decoding, LoRA adapters, constraints, kv tiers, the metrics
exporter, and ``decode_chunk > 1``.
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
from ..models.kv_cache import pages_for
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
                 decode_chunk=1, max_queue_len=None, clock=None,
                 kv_layout=None, page_size=128, num_pages=None,
                 prefill_chunk=None, prefix_cache=None, metrics_port=None,
                 spec_k=0, adapters=None, host_cache_pages=0,
                 generator=None):
        """Arguments as in the reference engine.  ``kv_layout`` must be
        ``"paged"`` and ``prefix_cache`` ``False``.  ``num_pages`` defaults
        to full capacity (slots * max_seq_len / page_size + the trash page);
        size it smaller to oversubscribe (preemption then recomputes).
        ``generator`` is the torch.Generator sampled rows draw from (default:
        the seeded generator of the model's device)."""
        if kv_layout != "paged":
            raise _not_ported(f"kv_layout={kv_layout!r} (the dense engine)",
                              "the static decode kernel with generate() and "
                              "the dense engine")
        if prefix_cache is not False:
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
        if int(decode_chunk) != 1:
            raise _not_ported("decode_chunk > 1", "serving plane")
        if cache_dtype not in (None, "int8"):
            raise ValueError(f"cache_dtype must be None or 'int8', got {cache_dtype!r}")
        if not getattr(model, "_supports_paged_cache", False):
            raise ValueError(f"{type(model).__name__} does not support the "
                             "paged kv-cache layout")
        if int(page_size) < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        cfg = model.config
        self.model = model
        self.device = next(model.parameters()).device
        self.n_slots = int(max_batch_slots)
        self.ps = int(page_size)
        self.kv_layout = "paged"
        # pad L to the 128-token tile AND a whole number of pages
        L = ((int(max_seq_len) + 127) // 128) * 128
        unit = self.ps * 128 // np.gcd(self.ps, 128)
        self.L = ((L + unit - 1) // unit) * unit
        self.M = self.L // self.ps  # page-table width (max pages per slot)
        P = int(num_pages) if num_pages is not None else self.n_slots * self.M + 1
        self.num_pages = P = max(P, 2)  # trash page + one allocatable page
        self.cache_dtype = cache_dtype
        self.eos = -1 if eos_token_id is None else int(eos_token_id)
        self.pad = int(pad_token_id)
        self.prefill_chunk = max(1, min(
            int(prefill_chunk) if prefill_chunk is not None else 128, self.L))
        H = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
        D = cfg.hidden_size // cfg.num_attention_heads
        pdt = next(model.parameters()).dtype
        kv_dtype = torch.bfloat16 if pdt == torch.bfloat16 else torch.float32
        dev, ps = self.device, self.ps

        def zeros(dt):
            return torch.zeros((P, H, ps, D), dtype=dt, device=dev)

        if cache_dtype == "int8":
            self.caches = [
                (zeros(torch.int8), zeros(torch.int8),
                 torch.full((P, H, ps), 1e-8, dtype=torch.float32, device=dev),
                 torch.full((P, H, ps), 1e-8, dtype=torch.float32, device=dev))
                for _ in range(cfg.num_hidden_layers)]
        else:
            self.caches = [(zeros(kv_dtype), zeros(kv_dtype))
                           for _ in range(cfg.num_hidden_layers)]
        B = self.n_slots
        # host-side allocator: page 0 is the trash page, never handed out;
        # pop() order is deterministic (highest id first), as the reference
        self._free_pages = list(range(1, P))
        self._page_ref = np.zeros(P, np.int32)
        self._slot_pages: list[list[int]] = [[] for _ in range(B)]
        self._pt_host = np.zeros((B, self.M), np.int32)
        self._pt_dev = torch.from_numpy(self._pt_host).to(dev)
        self._pt_dirty = False
        self._prefilling = None  # (request, slot, prompt tokens consumed)
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
        self._lock = threading.Lock()
        self._counts = dict(submitted=0, admitted=0, completed=0, shed=0,
                            expired=0, preemptions=0, prefill_chunks=0,
                            decode_ticks=0, decode_tokens=0, recompute_tokens=0)
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
            self._counts["shed"] += 1
            raise ServerOverloadedError(
                f"admission queue full ({self.max_queue_len} pending requests); "
                "request rejected — retry with backoff") from None
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
        return {
            **self._counts,
            "queue_depth": self._pending.qsize(),
            "active_slots": sum(r is not None for r in self.slot_req),
            "n_slots": self.n_slots,
            "kv_layout": self.kv_layout,
            "kv_pages_in_use": int((self._page_ref > 0).sum()),
            "kv_pages_total": self.num_pages - 1,
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
        """Run one prefill chunk and one decode step against the idle pool
        (garbage rows land in the trash page), so the first request pays no
        kernel build or first-launch cost.  Returns the wall seconds."""
        t0 = time.perf_counter()
        with self._lock:
            if self._prefilling is not None or any(r is not None for r in self.slot_req):
                raise RuntimeError("warmup() requires an idle engine")
            dev, B = self.device, self.n_slots
            with torch.no_grad():
                ids = torch.full((1, self.prefill_chunk), self.pad, dtype=torch.int64, device=dev)
                zero_row = torch.zeros((1, self.M), dtype=torch.int32, device=dev)
                self.model.prefill_chunk_step(
                    ids, self._paged_caches(torch.zeros(1, dtype=torch.int64, device=dev),
                                            zero_row), 0)
                tok = torch.full((B, 1), self.pad, dtype=torch.int64, device=dev)
                pos = torch.zeros(B, dtype=torch.int64, device=dev)
                zero_tbl = torch.zeros((B, self.M), dtype=torch.int32, device=dev)
                self.model.generate_step(tok, caches=self._paged_caches(pos, zero_tbl))
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
        """Free every page a slot holds, point its table row at the trash
        page and reset its length, so that while the slot is idle a decode
        tick's kernel reads one key of it (finish / expiry / preemption /
        stop)."""
        self.slot_pos[slot] = 0
        if not self._slot_pages[slot]:
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
        tok = self._host_select(row, req)
        first = not req.tokens  # a re-admission after preemption continues
        req.tokens.append(tok)
        self.slot_req[slot] = req
        self.slot_pos[slot] = n
        self.last_token[slot] = tok
        self._prefilling = None
        self._counts["admitted"] += 1
        if first and req.submit_ts is not None:
            self._ttfts.append(max(0.0, self._clock() - req.submit_ts))
        if tok == self.eos or len(req.tokens) >= req.max_new_tokens:
            self._finish(slot)

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
        if self._prefilling is None:
            self._start_prefill()
        if self._prefilling is not None:
            self._prefill_tick()
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return 0
        active = self._ensure_decode_pages(active, 1)
        if not active:
            return 0
        dev, reqs = self.device, self.slot_req
        t0 = time.perf_counter()
        # decode sees a table with INACTIVE slots masked to the trash page: a
        # mid-prefill slot already owns real pages, and the shared step's
        # garbage scatter for it must not clobber its prompt rows
        pt = self._pt_host.copy()
        for i, r in enumerate(reqs):
            if r is None:
                pt[i, :] = 0
        tokens = torch.from_numpy(self.last_token.astype(np.int64)[:, None]).to(dev)
        pos = torch.from_numpy(self.slot_pos.astype(np.int64)).to(dev)
        do_s = torch.tensor([r is not None and r.do_sample for r in reqs], device=dev)
        temp = torch.tensor([r.temperature if r is not None else 1.0 for r in reqs],
                            dtype=torch.float32, device=dev)
        topk = torch.tensor([r.top_k if r is not None else 0 for r in reqs],
                            dtype=torch.int32, device=dev)
        topp = torch.tensor([r.top_p if r is not None else 1.0 for r in reqs],
                            dtype=torch.float32, device=dev)
        with torch.no_grad():
            logits, _ = self.model.generate_step(
                tokens, caches=self._paged_caches(pos, torch.from_numpy(pt).to(dev)))
            nxt = sample_rows(logits[:, -1], self._gen, do_s, temp, topk, topp)
        nxt = nxt.cpu().numpy().astype(np.int32)  # the tick's one host sync
        self._seconds["decode"] += time.perf_counter() - t0
        self._counts["decode_ticks"] += 1
        emitted = 0
        for i in active:
            req = self.slot_req[i]
            tok = int(nxt[i])
            req.tokens.append(tok)
            self.last_token[i] = tok
            self.slot_pos[i] += 1
            emitted += 1
            if (tok == self.eos or len(req.tokens) >= req.max_new_tokens
                    or self.slot_pos[i] >= self.L - 1):
                self._finish(i)
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
