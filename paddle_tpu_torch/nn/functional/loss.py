"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

``cross_entropy`` keeps the reference's semantics: integer or soft labels,
``ignore_index``, ``weight``, ``reduction``, ``use_softmax`` and
``label_smoothing``.  The reference has no kernel here (XLA fuses it), so
the port is plain torch ops.

The hard-label path (softmax, integer labels, no weight, no smoothing) is
the one a language model's training step takes, and it keeps the
reference's numerics: f32 logsumexp and picked logit from logits of any
dtype, ``ignore_index`` rows contributing 0, ``mean`` over the valid rows
with a floor of 1, and the loss returned in the logits' dtype.  Its
gradient is written out, (softmax - onehot) * d_loss, in the logits'
dtype, as the reference's custom VJP does.  Memory: the reference relies on
XLA never materialising f32 logits.  Here the f32 copy is materialised, but
only for a block of rows at a time (at most 2^26 values, 256 MB), in the
forward and again in the backward, and neither keeps it: what is saved for
the backward is the logits themselves and one f32 logsumexp per row.  At a
LLaMA training shape ([16384, 32000] bf16) the whole f32 array would be
2.1 GB.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF

__all__ = ["cross_entropy"]

_BLOCK_VALUES = 1 << 26  # f32 values of logits a block of rows may hold


def _row_blocks(n, v):
    step = max(1, _BLOCK_VALUES // max(v, 1))
    return [(i, min(n, i + step)) for i in range(0, n, step)]


class _SoftmaxCE(torch.autograd.Function):
    """Per-row hard-label cross entropy lse(x) - x[label] in f32 over x
    [N, V]; rows whose label is ``ignore_index`` read class 0 and are
    masked by the caller (the reference's ``_fused_softmax_ce``)."""

    @staticmethod
    def forward(ctx, x, idx, ignore_index):
        safe = torch.where(idx == ignore_index, torch.zeros_like(idx), idx)
        lse = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
        for a, b in _row_blocks(*x.shape):
            lse[a:b] = torch.logsumexp(x[a:b].float(), dim=-1)
        picked = x.gather(1, safe[:, None])[:, 0].float()
        ctx.save_for_backward(x, lse, safe, idx != ignore_index)
        return lse - picked

    @staticmethod
    def backward(ctx, d_per):
        x, lse, safe, valid = ctx.saved_tensors
        d_per = d_per * valid.to(d_per.dtype)
        dx = torch.empty_like(x)
        for a, b in _row_blocks(*x.shape):
            probs = torch.exp(x[a:b].float() - lse[a:b, None])
            probs[torch.arange(b - a, device=x.device), safe[a:b]] -= 1.0
            dx[a:b] = (probs * d_per[a:b, None]).to(x.dtype)
        return dx, None, None


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def _hard_label_ce(logits, label, axis, ignore_index, reduction):
    x = logits.movedim(axis, -1)
    idx = label.long()
    if idx.dim() == logits.dim():
        idx = idx.squeeze(axis)
    rows = x.shape[:-1]
    per = _SoftmaxCE.apply(x.reshape(-1, x.shape[-1]), idx.reshape(-1), ignore_index)
    valid = (idx.reshape(-1) != ignore_index).to(per.dtype)
    per = per * valid
    if reduction == "mean":
        out = per.sum() / torch.clamp(valid.sum(), min=1.0)
    else:
        out = _reduce(per.reshape(rows), reduction)
    # the math is f32; the loss keeps the logits' dtype, as the reference's
    return out.to(logits.dtype)


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                  name=None):
    """Cross entropy of ``input`` logits (or probabilities when
    ``use_softmax`` is False) against integer class labels (shape of input
    without ``axis``, or with it as size 1) or, with ``soft_label``, a
    distribution over ``axis``.  ``reduction`` is "mean", "sum" or
    "none"."""
    if (use_softmax and not soft_label and weight is None and label_smoothing == 0
            and not torch.is_floating_point(label)):
        return _hard_label_ce(input, label, axis, ignore_index, reduction)
    if use_softmax:
        logp = tF.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, min=1e-15))
    nclass = input.shape[axis]
    if soft_label:
        soft = label
        if label_smoothing > 0:
            soft = soft * (1 - label_smoothing) + label_smoothing / nclass
        return _reduce(-(soft * logp).sum(axis), reduction)
    idx = label.long()
    if idx.dim() == logp.dim():  # the [N, ..., 1] form
        idx = idx.squeeze(axis)
    safe = torch.where(idx == ignore_index, torch.zeros_like(idx), idx)
    per = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    if label_smoothing > 0:
        per = (1 - label_smoothing) * per + label_smoothing * -logp.mean(axis)
    valid = (idx != ignore_index).to(per.dtype)
    per = per * valid
    if weight is not None:
        w = weight[safe]
        per = per * w
        if reduction == "mean":
            return (per * valid).sum() / torch.clamp((w * valid).sum(), min=1e-12)
    if reduction == "mean":
        return per.sum() / torch.clamp(valid.sum(), min=1.0)
    return _reduce(per, reduction)
