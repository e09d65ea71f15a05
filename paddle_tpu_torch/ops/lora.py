"""Batched-gather LoRA epilogue (counterpart of paddle_tpu/ops/lora.py):
``y += (x @ A[page]) @ B[page]`` per batch row.

Adapter weights live in paged pools, one ``[P, D_in, r]`` A pool and one
``[P, r, D_out]`` B pool per projection site (models/lora.py), and each batch
row carries the page id of its adapter.  The epilogue gathers each row's
pages and adds the low-rank delta to the base projection, so one batch
mixes adapters freely.  The reference computes it outside any Pallas kernel
(``jnp.take`` and two einsums), so here it is ``index_select`` and two
batched products.

Page 0 of every pool is all zeros and never written: a row without an
adapter gathers it and gets an exact ``+0``.

The model forwards call ``apply_site(site, x)``, which returns ``None``
unless a pool context is active (``with activate(...)``), so with no
context the base model computes exactly what it computed before.  The
context is thread-local: each engine ticks in one thread.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["lora_epilogue", "activate", "active_sites", "apply_site"]


def lora_epilogue(x, a_pool, b_pool, rows):
    """Low-rank delta of ``x`` [B, S, D_in] (any float dtype) against the
    pools ``a_pool`` [P, D_in, r] and ``b_pool`` [P, r, D_out] (page 0
    zeros) for the per-row page ids ``rows`` [B].  Returns [B, S, D_out]
    in ``x.dtype``.  The gathered pages are cast up to the activation dtype
    before the products, so an f32 model accumulates in f32 (bf16 -> f32 is
    exact)."""
    idx = rows.to(device=a_pool.device, dtype=torch.int64)
    a = a_pool.index_select(0, idx).to(x.dtype)  # [B, D_in, r]
    b = b_pool.index_select(0, idx).to(x.dtype)  # [B, r, D_out]
    return torch.bmm(torch.bmm(x, a), b)


_tls = threading.local()


def _current():
    return getattr(_tls, "ctx", None)


@contextmanager
def activate(site_pools, rows):
    """Make ``site_pools`` ({site: (a_pool, b_pool)}) and the per-row page
    ids ``rows`` [B] visible to ``apply_site`` in this thread for the
    duration of the block."""
    prev = _current()
    _tls.ctx = (dict(site_pools), rows)
    try:
        yield
    finally:
        _tls.ctx = prev


def active_sites():
    """Site names visible in the current context (empty when inactive)."""
    ctx = _current()
    return frozenset(ctx[0]) if ctx is not None else frozenset()


def apply_site(site, x):
    """The hook the model forwards call: the low-rank delta for ``site``
    computed from ``x``, or ``None`` when no pool context is active."""
    ctx = _current()
    if ctx is None:
        return None
    ab = ctx[0].get(site)
    if ab is None:
        return None
    return lora_epilogue(x, ab[0], ab[1], ctx[1])
