"""On-device token sampling (counterpart of paddle_tpu/ops/sampling.py).

Per-row knobs ride as device tensors (one entry per batch slot), so slots
with different sampling settings share one decode step and only token ids
cross to the host.  The masking order is the reference's: token mask ->
temperature -> top-k (by value, ties kept) -> top-p over the top-k
survivors.  Greedy rows are a bare argmax (first maximal index, as jnp).
Sampled rows draw from an explicit ``torch.Generator``; the draws differ
from JAX's for the same seed.  ``spec_accept`` comes with the speculative
decoding slice (ROADMAP.md).
"""
from __future__ import annotations

import torch

__all__ = ["mask_logits", "sample_rows"]


def mask_logits(logits, temperature, top_k, top_p, token_mask=None):
    """logits [B, V]; temperature/top_p f32 [B]; top_k int [B] (0, or >= V,
    disables).  Returns f32 logits with masked-out entries at -inf."""
    V = logits.shape[-1]
    lt = logits.float() / torch.clamp(temperature.float(), min=1e-6)[:, None]
    neg_inf = torch.tensor(float("-inf"), device=lt.device)
    if token_mask is not None:
        lt = torch.where(token_mask, lt, neg_inf)
    k = top_k.to(torch.int64)
    use_k = (k > 0) & (k < V)
    sorted_lt = torch.sort(lt, dim=-1, descending=True).values
    kth = torch.gather(sorted_lt, -1, torch.clamp(k - 1, 0, V - 1)[:, None])
    lt = torch.where(use_k[:, None] & (lt < kth), neg_inf, lt)
    use_p = top_p < 1.0
    sorted_lt = torch.sort(lt, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_lt, dim=-1), dim=-1)
    # keep the smallest set with cumulative prob >= top_p (always >= 1 token)
    cutoff_idx = torch.sum(cum < top_p[:, None].float(), dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_lt, -1, torch.clamp(cutoff_idx, max=V - 1))
    return torch.where(use_p[:, None] & (lt < cutoff), neg_inf, lt)


def sample_rows(logits, generator, do_sample, temperature, top_k, top_p):
    """Per-row token selection: logits [B, V] -> int32 ids [B].  Greedy rows
    take the raw argmax; sampled rows draw from the masked distribution
    with ``generator``.  (The reference's ``token_mask`` comes with the
    constraints slice.)"""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    masked = mask_logits(logits, temperature, top_k, top_p)
    # greedy rows draw from their own one-hot, so the one draw covers every
    # row without a host round trip to split the batch
    onehot = torch.nn.functional.one_hot(greedy.long(), logits.shape[-1])
    probs = torch.where(do_sample[:, None], torch.softmax(masked, dim=-1),
                        onehot.float())
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(do_sample, sampled.to(torch.int32), greedy)
