"""On-device token sampling (counterpart of paddle_tpu/ops/sampling.py).

Per-row knobs ride as device tensors (one entry per batch slot), so slots
with different sampling settings share one decode step and only token ids
cross to the host.  The masking order is the reference's: token mask ->
temperature -> top-k (by value, ties kept) -> top-p over the top-k
survivors.  Greedy rows are a bare argmax (first maximal index, as jnp).
Sampled rows draw from an explicit ``torch.Generator``; the draws differ
from JAX's for the same seed.  ``spec_accept`` is the speculative verify's
accept/rollback decision: greedy rows accept the longest draft prefix that
matches the argmax ladder (so speculative greedy decoding emits exactly the
tokens of plain greedy decoding), sampled rows run rejection sampling
against the drafter's one-hot proposal.
"""
from __future__ import annotations

import torch

__all__ = ["mask_logits", "sample_rows", "spec_accept"]


def mask_logits(logits, temperature, top_k, top_p, token_mask=None):
    """logits [B, V]; temperature/top_p f32 [B]; top_k int [B] (0, or >= V,
    disables).  Returns f32 logits with masked-out entries at -inf."""
    V = logits.shape[-1]
    lt = logits.float() / torch.clamp(temperature.float(), min=1e-6)[:, None]
    neg_inf = float("-inf")  # a scalar: no host-to-device copy (a captured
    # program may not make one)
    if token_mask is not None:
        lt = lt.masked_fill(~token_mask, neg_inf)
    k = top_k.to(torch.int64)
    use_k = (k > 0) & (k < V)
    sorted_lt = torch.sort(lt, dim=-1, descending=True).values
    kth = torch.gather(sorted_lt, -1, torch.clamp(k - 1, 0, V - 1)[:, None])
    lt = lt.masked_fill(use_k[:, None] & (lt < kth), neg_inf)
    use_p = top_p < 1.0
    sorted_lt = torch.sort(lt, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_lt, dim=-1), dim=-1)
    # keep the smallest set with cumulative prob >= top_p (always >= 1 token)
    cutoff_idx = torch.sum(cum < top_p[:, None].float(), dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_lt, -1, torch.clamp(cutoff_idx, max=V - 1))
    return lt.masked_fill(use_p[:, None] & (lt < cutoff), neg_inf)


def sample_rows(logits, generator, do_sample, temperature, top_k, top_p, token_mask=None):
    """Per-row token selection: logits [B, V] -> int32 ids [B].  Greedy rows
    take the argmax; sampled rows draw from the masked distribution with
    ``generator``.  ``token_mask`` (bool [B, V], constrained decoding)
    constrains both: greedy rows take the argmax of the masked logits,
    sampled rows mask before temperature, top-k and top-p.  A row whose
    mask is all True is untouched."""
    src = logits if token_mask is None else logits.masked_fill(~token_mask, float("-inf"))
    greedy = torch.argmax(src, dim=-1).to(torch.int32)
    masked = mask_logits(logits, temperature, top_k, top_p, token_mask)
    # greedy rows draw from their own one-hot, so the one draw covers every
    # row without a host round trip to split the batch
    onehot = torch.nn.functional.one_hot(greedy.long(), logits.shape[-1])
    probs = torch.where(do_sample[:, None], torch.softmax(masked, dim=-1),
                        onehot.float())
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return torch.where(do_sample, sampled.to(torch.int32), greedy)


def spec_accept(logits, drafts, generator, do_sample, temperature, top_k, top_p):
    """Speculative decoding's accept/rollback decision, on the device.

    ``logits`` [B, K+1, V] is the verify pass's ladder: column i is the
    next-token distribution given the context and the first i drafts (the
    verify input is [last token, draft_0 .. draft_{K-1}]).  ``drafts``
    [B, K].  Knobs are per-row tensors as in :func:`sample_rows`; sampled
    rows draw from ``generator``.

    Returns (out [B, K+1] int32, n_accept [B] int32): row b emits
    ``out[b, :n_accept[b] + 1]``, the accepted drafts and one correction or
    bonus token.  Greedy rows accept the longest prefix where the ladder's
    argmax equals the draft, and emit the ladder itself.  Sampled rows
    accept draft i with probability p_i(draft_i) under the masked target;
    the first rejection draws the correction from the target with the
    rejected token removed (the residual of a one-hot proposal), a full
    accept draws the bonus from the last column."""
    B, S, V = logits.shape
    K = S - 1
    dev = logits.device
    ladder = torch.argmax(logits, dim=-1).to(torch.int32)            # [B, K+1]
    drafts = drafts.to(device=dev, dtype=torch.int32)
    g_acc = torch.cumprod((ladder[:, :K] == drafts).to(torch.int32), dim=-1).sum(-1)
    masked = mask_logits(logits.reshape(B * S, V), temperature.repeat_interleave(S),
                         top_k.repeat_interleave(S), top_p.repeat_interleave(S)
                         ).reshape(B, S, V)
    p = torch.softmax(masked, dim=-1)
    p_draft = torch.gather(p[:, :K], -1, drafts.long()[..., None])[..., 0]  # [B, K]
    u = torch.rand((B, K), generator=generator, device=dev)
    s_acc = torch.cumprod((u < p_draft).to(torch.int32), dim=-1).sum(-1)
    n_acc = torch.where(do_sample, s_acc, g_acc).to(torch.int32)
    # the correction (after a rejection) or bonus token, at column n_acc
    col = torch.gather(masked, 1, n_acc.long()[:, None, None].expand(B, 1, V))[:, 0]
    rej = torch.gather(drafts.long(), 1, torch.clamp(n_acc.long(), 0, K - 1)[:, None])
    drop = (n_acc < K)[:, None] & (torch.arange(V, device=dev)[None, :] == rej)
    col = col.masked_fill(drop, float("-inf"))
    corr = torch.multinomial(torch.softmax(col, dim=-1), 1, generator=generator)[:, 0]
    s_out = torch.cat([drafts, torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=-1)
    at = torch.arange(K + 1, device=dev)[None, :] == n_acc[:, None]
    s_out = torch.where(at, corr.to(torch.int32)[:, None], s_out)
    return torch.where(do_sample[:, None], s_out, ladder), n_acc
