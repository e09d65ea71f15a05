"""Attention functionals (counterpart of paddle_tpu/nn/functional/attention.py).

Only the dense path (the reference's ``_dense_sdpa``) is ported.  Where the
reference dispatches to a Pallas kernel on its accelerator — the
short-sequence encoder kernel or flash attention — the port has no Hopper
kernel yet, so a CUDA tensor on those shapes raises instead of quietly
running the dense math (ROADMAP.md, Queue 2: flash attention and the encoder
kernel).  CPU tensors take the dense path, as the reference does off-TPU.
"""
from __future__ import annotations

import torch


def _dense_sdpa(q, k, v, mask, is_causal, scale):
    """q/k/v [B, S, H, D] (paddle layout) -> [B, S, H, D].  Bottom-right
    causal alignment (query i sees keys <= i + Sk - Sq); f32 softmax."""
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / (d ** 0.5)
    qT, kT, vT = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", qT, kT) * s
    neg = torch.finfo(logits.dtype).min
    if is_causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=logits.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~causal, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = logits.masked_fill(~mask, neg)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vT)
    return out.transpose(1, 2)


def _reference_kernel(q, k, attn_mask, is_causal, backend):
    """Name of the Pallas kernel the reference would pick for these shapes
    on its accelerator (its encoder and flash admission rules), or None."""
    if backend == "flash":
        return "flash_attention"
    if backend != "auto" or attn_mask is not None:
        return None
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    if S == Sk and S % 128 == 0 and S <= 512 and D in (64, 128):
        return "encoder_attention"

    def tileable(n):
        return n % 128 == 0 or (n <= 512 and n % 8 == 0)

    if (S >= 1024 and tileable(S) and tileable(Sk)
            and (not is_causal or S <= Sk) and D in (64, 128, 256)):
        return "flash_attention"
    return None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, backend="auto"):
    """query/key/value: [batch, seq, num_heads, head_dim] (paddle layout).
    ``backend="math"`` is the dense path on any device; ``"auto"`` and
    ``"flash"`` raise on CUDA where the reference would run a kernel that
    is not ported yet."""
    if dropout_p and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (ROADMAP.md Queue 2: the "
            "encoder slice, _prng Philox)")
    if query.is_cuda:
        kern = _reference_kernel(query, key, attn_mask, is_causal, backend)
        if kern is not None:
            raise NotImplementedError(
                f"the reference runs its {kern} Pallas kernel on these shapes; "
                "its Hopper port does not exist yet (ROADMAP.md Queue 2). "
                "Use backend='math' (use_flash_attention=False) for the dense "
                "path.")
    return _dense_sdpa(query, key, value, attn_mask, is_causal, scale)
