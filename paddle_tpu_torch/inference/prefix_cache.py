"""Radix/trie prefix index over paged kv-cache blocks, host side
(counterpart of paddle_tpu/inference/prefix_cache.py, kept byte for byte in
its keys).

Requests that share a system prompt or few-shot prefix can share its kv:
the paged cache (models/kv_cache.py) makes that a page-table problem, and
the paged kernel walks any per-slot table, so a shared page needs no kernel
change.  This module is the index that finds the shareable pages:

- **Chained block hashes.**  A prompt is split into page-aligned blocks of
  ``page_size`` tokens, hashed as ``np.int32`` bytes; block i's key is
  ``sha1(parent_key || tokens_i)``, so a key commits to the whole prefix up
  to and including its block.  The digests equal the reference's bit for
  bit (the router's affinity and the kv tiers are keyed by them).
- **Full nodes** hold one filled page.  Later requests only read them
  (writes land past the prompt), so any number of slots map them.
- **Partial tail nodes** hold the prompt's last, partly filled page
  (``ntok < page_size`` rows) and keep its raw tokens, so a later prompt
  matches the longest common prefix of the tail.  A slot that maps a tail
  writes into it later; the engine forks the page copy-on-write first.
- **LRU eviction** of leaves whose page only the cache holds; a matched
  chain pins its pages through the slots' refcounts.

The index owns no device memory and no refcounts: it returns and accepts
page ids, and the engine's allocator does the incref/decref.
"""
from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["PrefixCache", "chained_block_key", "prefix_key"]

_ROOT = b""  # parent key of a prompt's first block


def _root_key(adapter_id):
    """Chain seed for a prompt's first block.

    ``None`` (the base model) keeps the historical empty seed, so every
    pre-multi-tenant key — and the golden digests pinning them — is
    unchanged.  A LoRA adapter id seeds the chain with a domain-separated
    digest of the id: kv computed under adapter A never matches a request
    for adapter B (same tokens, different weights => different kv), and
    the router's affinity table inherits the same split because it hashes
    through :func:`prefix_key`.
    """
    if adapter_id is None:
        return _ROOT
    h = hashlib.sha1(b"\x00adapter\x00")
    h.update(str(adapter_id).encode("utf-8", "surrogatepass"))
    return h.digest()


def chained_block_key(parent, blk_bytes, partial=False):
    """Key of one page block given its ``parent`` chain key.

    ``sha1(parent || tokens)`` — the key commits to the entire prefix up to
    and including this block.  This is the ONE derivation shared by the
    radix index below and the router's affinity table
    (``inference.router``): factoring it here is what guarantees the two
    can never diverge on what counts as "the same prefix".
    """
    h = hashlib.sha1(parent)
    if partial:
        # domain-separate partial tails: a 7-token tail must never
        # collide with a full block whose first bytes match
        h.update(b"\x00partial\x00")
    h.update(blk_bytes)
    return h.digest()


def prefix_key(prompt, page_size, blocks=None, adapter_id=None):
    """Affinity key of ``prompt``: the chained key of its cacheable prefix.

    Chains the same page-aligned block keys ``PrefixCache`` indexes (over
    the ``len(prompt) - 1`` usable tokens — the last token is always
    recomputed), capped at ``blocks`` full blocks so a router can bucket on
    the shared head (system prompt + few-shot prefix) instead of the whole
    prompt.  Prompts shorter than one page fall back to the
    domain-separated partial-tail key, matching ``PrefixCache.insert``'s
    tail node — so two requests get the same key exactly when the cache
    would give them the same chain.  ``adapter_id`` seeds the chain
    (:func:`_root_key`): kv under different adapters never matches, and
    ``None`` keeps the historical keys bit for bit.
    """
    prompt = np.asarray(prompt, np.int32)
    ps = int(page_size)
    usable = max(0, prompt.size - 1)
    full = usable // ps
    if blocks is not None:
        full = min(full, int(blocks))
    key = _root_key(adapter_id)
    for i in range(full):
        key = chained_block_key(key, prompt[i * ps:(i + 1) * ps].tobytes())
    if full == 0 and usable > 0:
        key = chained_block_key(key, prompt[:usable].tobytes(), partial=True)
    return key


class _Node:
    __slots__ = ("key", "parent", "page", "ntok", "tokens", "nchildren",
                 "last_used")

    def __init__(self, key, parent, page, ntok, tokens):
        self.key = key
        self.parent = parent
        self.page = int(page)
        self.ntok = int(ntok)
        self.tokens = tokens  # None for full blocks; np.int32 for partials
        self.nchildren = 0
        self.last_used = 0


class PrefixCache:
    """Trie of cached prompt-prefix pages, keyed by chained block hashes."""

    def __init__(self, page_size):
        self.ps = int(page_size)
        self._nodes: dict[bytes, _Node] = {}
        self._partials: dict[bytes, set[bytes]] = {}  # parent -> partial keys
        self._tick = 0  # LRU clock: bumped on every touch, no wall time

    def __len__(self):
        return len(self._nodes)

    def pages(self):
        """Every page currently held by the index (diagnostics/invariants)."""
        return [n.page for n in self._nodes.values()]

    def _touch(self, node):
        self._tick += 1
        node.last_used = self._tick

    # kept as a method name so call sites read as "the cache's key scheme";
    # the derivation itself lives in chained_block_key (shared with the
    # router's affinity table)
    _child_key = staticmethod(chained_block_key)

    # ------------------------------------------------------------- lookup

    def match(self, prompt, adapter_id=None):
        """Longest cached prefix of ``prompt`` an admission can map.

        Capped at ``len(prompt) - 1`` tokens: the last prompt token's
        logits ARE the first output token, so at least one position must
        always be recomputed.  Returns ``(matched_tokens, pages)`` where
        ``pages`` covers page indices ``0 .. len(pages)-1`` of the slot's
        table (the last page is partially valid when ``matched_tokens`` is
        off the page grid).  Touches every matched node for LRU.
        """
        prompt = np.asarray(prompt, np.int32)
        usable = prompt.size - 1
        key, matched, pages = _root_key(adapter_id), 0, []
        while matched + self.ps <= usable:
            k = self._child_key(key, prompt[matched:matched + self.ps]
                                .tobytes())
            node = self._nodes.get(k)
            if node is None:
                break
            self._touch(node)
            pages.append(node.page)
            matched += self.ps
            key = k
        best, best_t = None, 0
        # sorted: set order varies with hash randomization, and an
        # equal-overlap tie must pick the same node in every process
        for pk in sorted(self._partials.get(key, ())):
            node = self._nodes[pk]
            t_max = min(node.ntok, usable - matched)
            if t_max <= 0:
                continue
            eq = node.tokens[:t_max] == prompt[matched:matched + t_max]
            t = t_max if eq.all() else int(np.argmin(eq))
            if t > best_t:
                best, best_t = node, t
        if best is not None:
            self._touch(best)
            pages.append(best.page)
            matched += best_t
        return matched, pages

    # ----------------------------------------------------------- mutation

    def insert(self, prompt, slot_pages, adapter_id=None):
        """Register a freshly prefilled prompt's pages.

        ``slot_pages[i]`` must hold tokens ``i*ps .. (i+1)*ps - 1`` — the
        engine's slot layout.  Blocks already cached are only touched (the
        slot keeps its private duplicate; it frees on finish).  Returns the
        pages NEWLY held by the index — the caller increfs each, which is
        what keeps them alive after the slot releases.
        """
        prompt = np.asarray(prompt, np.int32)
        n = prompt.size
        key, new_holds = _root_key(adapter_id), []
        full = n // self.ps
        for i in range(full):
            blk = prompt[i * self.ps:(i + 1) * self.ps]
            k = self._child_key(key, blk.tobytes())
            node = self._nodes.get(k)
            if node is None:
                node = _Node(k, key, slot_pages[i], self.ps, None)
                self._nodes[k] = node
                parent = self._nodes.get(key)
                if parent is not None:
                    parent.nchildren += 1
                new_holds.append(node.page)
            self._touch(node)
            key = k
        t = n - full * self.ps
        if t > 0:
            tail = prompt[full * self.ps:]
            k = self._child_key(key, tail.tobytes(), partial=True)
            node = self._nodes.get(k)
            if node is None:
                node = _Node(k, key, slot_pages[full], t, tail.copy())
                self._nodes[k] = node
                self._partials.setdefault(key, set()).add(k)
                parent = self._nodes.get(key)
                if parent is not None:
                    parent.nchildren += 1
                new_holds.append(node.page)
            self._touch(node)
        return new_holds

    def freeable_count(self, pinned_page):
        """How many pages leaf-first eviction could EVER free right now:
        every node except those on the path to a node whose page
        ``pinned_page(page)`` says is held beyond the cache (a pinned node
        can't be evicted, so neither can its ancestors — evicting an
        interior node would strand the pinned chain).  Lets the engine
        refuse an eviction run that would destroy warm entries without
        ultimately covering the allocation."""
        pinned = set()
        for node in self._nodes.values():
            if pinned_page(node.page):
                k = node.key
                while k != _ROOT and k not in pinned:
                    n = self._nodes.get(k)
                    if n is None:
                        break  # orphaned boundary (evicted interior parent)
                    pinned.add(k)
                    k = n.parent
        return len(self._nodes) - len(pinned)

    def evict_one(self, evictable):
        """Remove the least-recently-used LEAF whose page satisfies
        ``evictable(page)`` (the engine passes "held by nobody but the
        cache").  Returns ``(key, tokens, page, ntok)`` of the evicted
        node (caller decrefs the page) or None.  Returning the node's
        identity — not just its page — is what lets the hierarchical-kv
        demotion path look up / commit a host-tier copy WITHOUT
        re-deriving the hash chain.  The LRU scan is O(nodes) — the index
        is host-side and small next to a page pool worth of HBM."""
        best = None
        for node in self._nodes.values():
            if node.nchildren == 0 and evictable(node.page):
                if best is None or node.last_used < best.last_used:
                    best = node
        if best is None:
            return None
        self._remove(best)
        return best.key, best.tokens, best.page, best.ntok

    def evict_page(self, page):
        """Remove the leaf node holding ``page`` (the steal-back path: a
        slot about to write a tail page whose ONLY other holder is the
        cache reclaims it in place instead of paying a copy).  Returns the
        removed node's ``(key, tokens, page, ntok)`` — same shape as
        :meth:`evict_one`, so the demotion path treats both eviction
        flavors identically — or None when no leaf holds the page."""
        for node in self._nodes.values():
            if node.page == page and node.nchildren == 0:
                self._remove(node)
                return node.key, node.tokens, node.page, node.ntok
        return None

    # ------------------------------------------------- hierarchical tiers

    def node_info(self, key):
        """(page, ntok) of the node at ``key`` or None — the demotion
        worker's commit check: a staged host copy is only valid while the
        node still exists on the SAME page (cached pages are frozen by the
        COW rule, so same node + same page == same content)."""
        node = self._nodes.get(key)
        return (node.page, node.ntok) if node is not None else None

    def lru_entries(self):
        """Every node as ``(key, parent, page, ntok, tokens)``, least
        recently used first — the demotion worker's candidate scan (it
        stages cold entries host-side BEFORE eviction destroys them)."""
        return [(n.key, n.parent, n.page, n.ntok, n.tokens)
                for n in sorted(self._nodes.values(),
                                key=lambda n: n.last_used)]

    def readmit(self, key, parent, page, ntok, tokens=None):
        """Re-insert a PROMOTED node (host/disk tier -> a freshly uploaded
        device page) under its original chain key.  The caller walks the
        chain in order, so ``parent`` is already present (or is the chain
        seed); after readmission a re-run of :meth:`match` sees the page
        exactly as if it had never been evicted.  Returns False (no-op)
        when the key is already indexed — a concurrent prefill won the
        race and the caller must roll its page back."""
        if key in self._nodes:
            return False
        node = _Node(key, parent, page, ntok,
                     None if tokens is None
                     else np.asarray(tokens, np.int32))
        self._nodes[key] = node
        if node.tokens is not None:
            self._partials.setdefault(parent, set()).add(key)
        par = self._nodes.get(parent)
        if par is not None:
            par.nchildren += 1
        self._touch(node)
        return True

    def _remove(self, node):
        del self._nodes[node.key]
        if node.tokens is not None:
            siblings = self._partials.get(node.parent)
            if siblings is not None:
                siblings.discard(node.key)
                if not siblings:
                    del self._partials[node.parent]
        parent = self._nodes.get(node.parent)
        if parent is not None:
            parent.nchildren -= 1
