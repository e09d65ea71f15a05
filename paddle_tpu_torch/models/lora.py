"""Paged LoRA adapter pool: refcounted A/B weight pages and a registry
(counterpart of paddle_tpu/models/lora.py).

Adapter low-rank factors live in per-site pools on the engine's device,
``[num_adapter_pages, D_in, r]`` (A) and ``[num_adapter_pages, r, D_out]``
(B), bf16 by default, and every batch row addresses its adapter through a
page id (ops/lora.py), so one batch mixes adapters freely.

Page 0 is the reserved ZERO adapter (all-zero A/B, never written, never
evicted): rows without an adapter gather it and receive an exact ``+0``.

:class:`AdapterRegistry` keeps the host-side accounting the engine's kv
allocator keeps for pages: refcounts (a live request pins its adapter from
admission to finish, expiry or preemption), a free list, and LRU eviction
of loaded but unreferenced adapters when a cold adapter needs a page.
``acquire`` returning ``None`` means every page is pinned: the engine
requeues the request at the head of the line.  Pools are keyed by SITE,
not by layer, as in the reference: every layer adds its site's delta.

The reference's ``llm_adapter_*`` metric families are not ported yet
(ROADMAP.md Queue 1 item 5); ``stats()`` carries the same counts.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["lora_sites", "LoraAdapter", "LoraPool", "AdapterRegistry",
           "build_solo_pool"]


def lora_sites(model):
    """Projection-site name -> ``(d_in, d_out)`` for a supported model (or
    its config); the names match the ``ops.lora.apply_site`` hooks."""
    cfg = getattr(model, "config", None) or model
    kind = type(model).__name__
    h, inter = cfg.hidden_size, cfg.intermediate_size
    if "Llama" in kind:
        hd = h // cfg.num_attention_heads
        nq = cfg.num_attention_heads * hd
        nkv = cfg.num_key_value_heads * hd
        return {"q": (h, nq), "k": (h, nkv), "v": (h, nkv), "o": (nq, h),
                "gate": (h, inter), "up": (h, inter), "down": (inter, h)}
    if "GPT" in kind:
        return {"qkv": (h, 3 * h), "proj": (h, h),
                "fc_in": (h, inter), "fc_out": (inter, h)}
    raise ValueError(f"no LoRA site map for model type {kind!r}")


class LoraAdapter:
    """Host-side adapter weights: ``{site: (A [d_in, r], B [r, d_out])}`` as
    float32 numpy.  ``scale`` (alpha / r) is folded into B."""

    def __init__(self, weights, rank=None, scale=1.0):
        self.weights = {}
        self.rank = 0
        for site, (a, b) in weights.items():
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32) * float(scale)
            if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
                raise ValueError(f"adapter site {site!r}: A {a.shape} / B {b.shape} are "
                                 "not a rank-factorised pair")
            self.weights[site] = (a, b)
            self.rank = max(self.rank, a.shape[1])
        if rank is not None and int(rank) != self.rank:
            raise ValueError(f"declared rank {rank} != factor rank {self.rank}")

    @staticmethod
    def random(sites, rank, seed, scale=0.05):
        """A deterministic random adapter (numpy's generator from ``seed``,
        the reference's draws): both factors non-zero, so the adapter
        visibly changes the logits."""
        rng = np.random.default_rng(seed)
        w = {site: (rng.standard_normal((din, rank)).astype(np.float32),
                    rng.standard_normal((rank, dout)).astype(np.float32))
             for site, (din, dout) in sites.items()}
        return LoraAdapter(w, rank=rank, scale=scale)

    def validate_against(self, sites, rank):
        if set(self.weights) != set(sites):
            raise ValueError(f"adapter sites {sorted(self.weights)} != pool sites "
                             f"{sorted(sites)}")
        for site, (din, dout) in sites.items():
            a, b = self.weights[site]
            if a.shape[0] != din or b.shape[1] != dout:
                raise ValueError(f"adapter site {site!r}: ({a.shape[0]}, {b.shape[1]}) "
                                 f"does not match model ({din}, {dout})")
        if self.rank > rank:
            raise ValueError(f"adapter rank {self.rank} > pool rank {rank}")


class LoraPool:
    """Paged A/B pools on ``device``, one (A, B) pair per projection site,
    written in place page by page."""

    def __init__(self, sites, num_pages, rank, dtype=torch.bfloat16, device="cpu"):
        if num_pages < 2:
            raise ValueError("LoRA pool needs >= 2 pages (page 0 is the reserved "
                             "zero adapter)")
        self.sites = dict(sites)
        self.site_names = sorted(self.sites)
        self.num_pages = int(num_pages)
        self.rank = int(rank)
        self.dtype = dtype
        self.device = torch.device(device)
        self._tree = tuple(
            (torch.zeros(self.num_pages, self.sites[s][0], self.rank, dtype=dtype,
                         device=self.device),
             torch.zeros(self.num_pages, self.rank, self.sites[s][1], dtype=dtype,
                         device=self.device))
            for s in self.site_names)

    def tree(self):
        """The pools, site-name sorted: ((A, B), ...)."""
        return self._tree

    def site_pools(self):
        """``{site: (a_pool, b_pool)}`` for ``ops.lora.activate``."""
        return dict(zip(self.site_names, self._tree))

    def write(self, page, adapter):
        """Upload ``adapter`` into ``page``, its ranks past the adapter's own
        zero-padded (they contribute exact zeros)."""
        if not 0 < page < self.num_pages:
            raise IndexError(f"adapter page {page} outside usable pool")
        for s, (a_pool, b_pool) in zip(self.site_names, self._tree):
            a, b = adapter.weights[s]
            r = a.shape[1]
            a_pool[page].zero_()
            b_pool[page].zero_()
            a_pool[page, :, :r] = torch.from_numpy(a).to(self.dtype)
            b_pool[page, :r] = torch.from_numpy(b).to(self.dtype)


class AdapterRegistry:
    """Loads and pins adapters by id over a :class:`LoraPool`.

    ``acquire(id)`` at admission pins the adapter's page (loading it first
    if cold, evicting the least recently used unreferenced adapter if no
    page is free); ``release(id)`` at finish, expiry or preemption unpins
    it.  A released adapter stays loaded until a cold load needs its page.
    ``acquire`` returns ``None`` when every page is pinned, and raises on
    unknown ids; a release below zero raises.
    """

    def __init__(self, model, max_adapters=8, rank=8, dtype=torch.bfloat16, device=None):
        self.sites = lora_sites(model)
        if device is None:
            device = next(model.parameters()).device
        self.pool = LoraPool(self.sites, int(max_adapters) + 1, rank, dtype, device)
        self._adapters = {}   # id -> LoraAdapter (host weights)
        self._page_of = {}    # id -> loaded page
        self._ref = {}        # id -> live-request refcount (loaded ids only)
        self._free = list(range(1, self.pool.num_pages))
        self._stamp = 0       # LRU clock
        self._mru = {}        # id -> last acquire/release stamp
        self._lock = threading.RLock()
        self.loads = 0
        self.evictions = 0

    @staticmethod
    def from_adapters(model, adapters, rank=None, dtype=torch.bfloat16, device=None):
        """A registry sized to hold every adapter of ``adapters`` resident."""
        r = rank or max((a.rank for a in adapters.values()), default=8)
        reg = AdapterRegistry(model, max_adapters=max(1, len(adapters)), rank=r,
                              dtype=dtype, device=device)
        for aid, ad in adapters.items():
            reg.register(aid, ad)
        return reg

    def register(self, adapter_id, adapter):
        if adapter_id is None:
            raise ValueError("adapter_id None is the reserved zero adapter")
        adapter.validate_against(self.sites, self.pool.rank)
        with self._lock:
            self._adapters[adapter_id] = adapter

    def ids(self):
        with self._lock:
            return sorted(self._adapters)

    def acquire(self, adapter_id):
        """Pin ``adapter_id`` and return its page (0 for ``None``), or
        ``None`` when every page is pinned."""
        if adapter_id is None:
            return 0
        with self._lock:
            if adapter_id not in self._adapters:
                raise KeyError(f"unknown adapter id {adapter_id!r}")
            page = self._page_of.get(adapter_id)
            if page is None:
                page = self._take_page()
                if page is None:
                    return None
                self.pool.write(page, self._adapters[adapter_id])
                self._page_of[adapter_id] = page
                self._ref[adapter_id] = 0
                self.loads += 1
            self._ref[adapter_id] += 1
            self._stamp += 1
            self._mru[adapter_id] = self._stamp
            return page

    def release(self, adapter_id):
        if adapter_id is None:
            return
        with self._lock:
            ref = self._ref.get(adapter_id)
            if ref is None or ref <= 0:
                raise AssertionError(f"adapter {adapter_id!r} release below zero")
            self._ref[adapter_id] = ref - 1
            self._stamp += 1
            self._mru[adapter_id] = self._stamp

    def page_for(self, adapter_id):
        """The loaded page of ``adapter_id`` (no pin), ``None`` when cold."""
        if adapter_id is None:
            return 0
        with self._lock:
            return self._page_of.get(adapter_id)

    def _take_page(self):
        if self._free:
            return self._free.pop()
        unpinned = [aid for aid, ref in self._ref.items() if ref == 0]
        if not unpinned:
            return None  # every loaded adapter is pinned
        victim = min(unpinned, key=lambda aid: self._mru.get(aid, 0))
        page = self._page_of.pop(victim)
        del self._ref[victim]
        self._mru.pop(victim, None)
        self.evictions += 1
        return page

    def pinned_pages(self):
        with self._lock:
            return sum(1 for r in self._ref.values() if r > 0)

    def stats(self):
        with self._lock:
            return {"pages_total": self.pool.num_pages - 1,
                    "pages_loaded": len(self._page_of),
                    "pages_pinned": sum(1 for r in self._ref.values() if r > 0),
                    "registered": len(self._adapters),
                    "loads": self.loads, "evictions": self.evictions,
                    "rank": self.pool.rank}


def build_solo_pool(model, adapter, dtype=torch.bfloat16):
    """A 2-page pool (the zero page and ``adapter`` on page 1) on the
    model's device, for ``generate(adapter_id=, adapters={id: adapter})``."""
    sites = lora_sites(model)
    adapter.validate_against(sites, adapter.rank)
    pool = LoraPool(sites, 2, adapter.rank, dtype, next(model.parameters()).device)
    pool.write(1, adapter)
    return pool
