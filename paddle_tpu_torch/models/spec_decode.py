"""Draft-token sources for speculative decoding (counterpart of
paddle_tpu/models/spec_decode.py).

Two drafters behind one interface, ``propose(context, k) -> np.int32[k]``:

- :class:`NGramDrafter`: prompt lookup.  The longest suffix n-gram of the
  context that occurred earlier in it proposes the tokens that followed
  it.  Host-side, no weights, deterministic; it pays off on repetitive
  and extractive traffic, and costs little elsewhere, because a verify
  emits at least one true token however bad the drafts are.
- :class:`DraftModelDrafter`: a small causal LM on the target's tokenizer,
  rolled out greedily (the port model's own ``generate``) over a bucketed
  context window.  Truncating the window shifts positions, which is fine:
  drafts are proposals, and the verify against the full context decides.

Drafting stays on the host: the drafts are token ids fed to the verify
step, which never depends on the draft source.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["NGramDrafter", "DraftModelDrafter", "get_drafter"]


class NGramDrafter:
    """Prompt-lookup drafting (the "assisted generation" n-gram trick).

    For each n from ``max_ngram`` down to ``min_ngram``, the context's
    last n tokens are searched for their most RECENT earlier occurrence;
    on a hit, the k tokens that followed that occurrence become the
    drafts.  No match (or a short continuation) pads by repeating the
    final draft/context token — deterministic filler the verifier simply
    rejects when wrong.
    """

    name = "ngram"

    def __init__(self, max_ngram=3, min_ngram=1):
        if not (1 <= int(min_ngram) <= int(max_ngram)):
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, context, k):
        ctx = np.asarray(context, np.int32).reshape(-1)
        k = int(k)
        n_ctx = ctx.size
        drafts = None
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1, -1):
            suffix = ctx[n_ctx - n:]
            # most recent earlier occurrence of the suffix n-gram
            windows = np.lib.stride_tricks.sliding_window_view(
                ctx[:n_ctx - 1], n)
            hits = np.flatnonzero((windows == suffix).all(axis=1))
            if hits.size:
                start = int(hits[-1]) + n
                drafts = ctx[start:start + k]
                break
        if drafts is None:
            drafts = ctx[n_ctx - 1:]  # repeat-last-token filler
        out = np.empty(k, np.int32)
        m = min(k, drafts.size)
        out[:m] = drafts[:m]
        if m < k:
            out[m:] = out[m - 1] if m else int(ctx[-1])
        return out


class DraftModelDrafter:
    """Small-model drafting: greedy rollout of a draft LM sharing the
    target's tokenizer.  The context is truncated to the largest bucket
    length that fits (one compiled rollout per bucket — the same
    bounded-compile-zoo discipline as the serving prefill buckets)."""

    name = "draft_model"

    def __init__(self, model, buckets=(8, 16, 32, 64)):
        self.model = model
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets!r}")

    def propose(self, context, k):
        ctx = np.asarray(context, np.int32).reshape(-1)
        k = int(k)
        win = self.buckets[0]
        for b in self.buckets:
            if b <= ctx.size:
                win = b
        ctx = ctx[-win:]
        if ctx.size < win:  # prompt shorter than the smallest bucket:
            ctx = np.pad(ctx, (win - ctx.size, 0), mode="edge")  # left-fill
        out = self.model.generate(ctx[None, :], max_new_tokens=k,
                                  do_sample=False)
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        return np.asarray(out, np.int32).reshape(-1)[:k]


def get_drafter(spec):
    """Resolve a drafter spec: ``"ngram"`` (default config), a drafter
    instance (anything with ``propose``), or a model object (wrapped in
    :class:`DraftModelDrafter`)."""
    if spec is None or spec == "ngram":
        return NGramDrafter()
    if hasattr(spec, "propose"):
        return spec
    if hasattr(spec, "generate"):
        return DraftModelDrafter(spec)
    raise ValueError(
        f"spec_draft must be 'ngram', a drafter with .propose, or a model "
        f"with .generate; got {spec!r}")
