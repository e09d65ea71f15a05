"""GPT family (counterpart of paddle_tpu/models/gpt.py): a learned-position
causal decoder with a fused qkv projection, LayerNorm and GELU.

Every cache layout of the reference's ``GPTBlock.forward``: no cache (the
training forward and the prefill bootstrap, whose attention routes as the
reference's does: the encoder kernel at S % 128 == 0, S <= 512 and flash
at S >= 1024 on CUDA, dense math elsewhere; q, k and v are strided views of
the one qkv product, which the encoder kernel reads in place), the growing
(k, v) pair, the STATIC 3/5-tuples of generate() and the dense engine (the
static decode kernel) and the PAGED 4/6-tuples of the paged engine (the
paged kernel).  Learned positions follow each slot's own offset.
Positions past ``max_position_embeddings`` (only the pad rows of a chunk
that runs past the table can reach them) read the last row of ``wpe``:
their outputs are never used, and their cache rows lie past every valid
length.  The qkv, proj, fc_in and fc_out projections add the multi-tenant
LoRA epilogue when an adapter context is active (ops/lora.py).  Not ported
yet, and raising: tensor parallelism (ROADMAP.md Queue 1 item 4,
distributed).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..core.device import resolve_device
from ..nn import functional as F
from ..ops import lora as _lora
from .kv_cache import paged_attention_update, position_rows, static_attention_update

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForCausalLM"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-5
    tensor_parallel: bool = False

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=512, max_position_embeddings=128)
        base.update(kw)
        return GPTConfig(**base)


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.ln_1 = pnn.LayerNorm(h, epsilon=config.layer_norm_eps, **kw)
        self.num_heads = config.num_attention_heads
        self.head_dim = h // config.num_attention_heads
        self.qkv = pnn.Linear(h, 3 * h, **kw)
        self.proj = pnn.Linear(h, h, **kw)
        self.fc_in = pnn.Linear(h, config.intermediate_size, **kw)
        self.fc_out = pnn.Linear(config.intermediate_size, h, **kw)
        self.ln_2 = pnn.LayerNorm(h, epsilon=config.layer_norm_eps, **kw)
        self.drop = pnn.Dropout(config.hidden_dropout_prob)
        self.attn_drop = config.attention_probs_dropout_prob

    def _mlp(self, x):
        h = self.ln_2(x)
        u = self.fc_in(h)
        d_in = _lora.apply_site("fc_in", h)
        if d_in is not None:  # multi-tenant LoRA epilogues (ops/lora.py)
            u = u + d_in
        g = F.gelu(u)
        y = self.fc_out(g)
        d_out = _lora.apply_site("fc_out", g)
        return x + self.drop(y if d_out is None else y + d_out)

    def forward(self, x, cache=None, use_cache=False):
        """cache: None, a growing (k, v) pair [B, S, H, D], a static 3/5-tuple
        or a paged 4/6-tuple (models/kv_cache.py).  Returns x, or (x,
        new_cache) when a cache is given or ``use_cache`` is set."""
        B, S = x.shape[0], x.shape[1]
        h = self.ln_1(x)
        qkv = self.qkv(h)
        dqkv = _lora.apply_site("qkv", h)
        if dqkv is not None:  # multi-tenant LoRA epilogue (ops/lora.py)
            qkv = qkv + dqkv
        qkv = qkv.reshape(B, S, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is not None and len(cache) in (3, 4, 5, 6):
            update = (paged_attention_update if len(cache) in (4, 6)
                      else static_attention_update)
            new_cache, attn = update(cache, q, k, v, cache[2])
        else:
            mask = None
            if cache is not None:  # the growing cache: append this call's rows
                k = torch.cat([cache[0], k], dim=1)
                v = torch.cat([cache[1], v], dim=1)
                new_cache = (k, v)
                # the queries are the last S positions of the sequence
                L = k.shape[1]
                jpos = torch.arange(L, device=x.device)[None, :]
                qpos = torch.arange(S, device=x.device)[:, None] + (L - S)
                mask = torch.where(jpos <= qpos, 0.0, -1e9).to(q.dtype)[None, None]
            else:
                new_cache = (k, v) if use_cache else None
            attn = F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                dropout_p=self.attn_drop if self.training else 0.0, training=self.training)
        attn = attn.reshape(B, S, -1)
        y = self.proj(attn)
        d = _lora.apply_site("proj", attn)
        x = x + self.drop(y if d is None else y + d)
        x = self._mlp(x)
        if use_cache or cache is not None:
            return x, new_cache
        return x


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.wte = pnn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = pnn.Embedding(config.max_position_embeddings, config.hidden_size, **kw)
        self.drop = pnn.Dropout(config.hidden_dropout_prob)
        self.h = nn.ModuleList([GPTBlock(config, **kw)
                                for _ in range(config.num_hidden_layers)])
        self.ln_f = pnn.LayerNorm(config.hidden_size, epsilon=config.layer_norm_eps, **kw)

    def _positions(self, S, caches, device):
        """Learned-position ids [1 or B, S]: from each slot's offset ([2] of
        a static or paged tuple, a scalar or per-slot [B]), from a growing
        cache's length, or from 0."""
        steps = torch.arange(S, device=device)
        c0 = caches[0] if caches is not None else None
        if c0 is not None and len(c0) in (3, 4, 5, 6):
            off = torch.as_tensor(c0[2], device=device).to(torch.int64)
            pos = steps[None, :] + (off[:, None] if off.dim() >= 1 else off)
        elif c0 is not None:
            pos = steps[None, :] + c0[0].shape[1]
        else:
            pos = steps[None, :]
        return pos.clamp(max=self.config.max_position_embeddings - 1)

    def forward(self, input_ids, caches=None, use_cache=False):
        """caches=None and use_cache=False: the no-cache forward, returns
        hidden states.  Otherwise one cache per layer (None each for the
        prefill bootstrap); returns (hidden, new_caches)."""
        use_cache = use_cache or caches is not None
        if use_cache and caches is None:
            caches = [None] * len(self.h)
        pos = self._positions(input_ids.shape[1], caches, input_ids.device)
        x = self.drop(self.wte(input_ids.long()) + self.wpe(pos))
        if not use_cache:
            for block in self.h:
                x = block(x)
            return self.ln_f(x)
        new_caches = []
        for block, cache in zip(self.h, caches, strict=True):
            x, cache = block(x, cache=cache, use_cache=True)
            new_caches.append(cache)
        return self.ln_f(x), new_caches


class GPTForCausalLM(nn.Module):
    _supports_quant_cache = True  # GPTBlock understands the 5-tuple
    _supports_paged_cache = True  # ... and the paged 4/6-tuples

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        """``device`` defaults to cuda (raises without it; pass "cpu" for the
        CPU); ``dtype`` to torch's default.  Parameters start from the
        reference's initializers on the global torch RNG: call
        ``init_weights(generator)`` for a seeded init, or load converted
        weights (paddle_tpu_torch.convert)."""
        super().__init__()
        if config.tensor_parallel:
            raise NotImplementedError(
                "GPT tensor parallelism is not ported yet (ROADMAP.md Queue 1 item 4: "
                "distributed)")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.config = config
        self.gpt = GPTModel(config, **kw)
        self.lm_head = pnn.Linear(config.hidden_size, config.vocab_size, bias_attr=False, **kw)

    @property
    def device(self):
        return self.lm_head.weight.device

    @property
    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init_weights(self, generator=None):
        """Re-initialize every parameter with the reference's initializers
        (Xavier-normal Linear with zero bias, N(0, 1) Embedding, ones/zeros
        LayerNorm), drawing from ``generator``."""
        for m in self.modules():
            if isinstance(m, (pnn.Linear, pnn.Embedding, pnn.LayerNorm)):
                m.reset_parameters(generator=generator)
        return self

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V]; with ``labels`` [B, S], ``(loss, logits)`` (rows
        labelled -100 ignored), as the reference computes them."""
        logits = self.lm_head(self.gpt(input_ids))
        if labels is None:
            return logits
        V = self.config.vocab_size
        loss = F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1), ignore_index=-100)
        return loss, logits

    def generate_step(self, input_ids, caches=None):
        """Prefill (caches=None: returns per-layer (k, v) [B, S, H, D]) or a
        decode step over static, paged or growing caches: logits of the LAST
        position [B, 1, V] and the updated caches."""
        hidden, caches = self.gpt(input_ids, caches=caches, use_cache=True)
        return self.lm_head(hidden[:, -1:]), caches

    def verify_step(self, input_ids, caches):
        """Speculative verify: logits at every position [B, S, V] of the
        K + 1 tokens scored in one pass (see llama.py)."""
        hidden, caches = self.gpt(input_ids, caches=caches, use_cache=True)
        return self.lm_head(hidden), caches

    def prefill_step(self, input_ids, last_index):
        """Bucket-padded prefill (dense-engine admission): logits [B, 1, V]
        at ``last_index`` (an int or a one-element device index tensor) and
        per-layer (k, v)."""
        hidden, caches = self.gpt(input_ids, use_cache=True)
        return self.lm_head(position_rows(hidden, last_index)), caches

    def prefill_chunk_step(self, input_ids, caches, last_index):
        """One chunk of a paged prefill (see llama.py): logits [B, 1, V] at
        ``last_index`` (an int or a one-element device index tensor) and the
        caches."""
        hidden, caches = self.gpt(input_ids, caches=caches)
        return self.lm_head(position_rows(hidden, last_index)), caches

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 pad_token_id=0, cache_dtype=None, kv_layout=None,
                 page_size=128, share_prefix=False, spec_k=0,
                 spec_drafter=None, adapter_id=None, adapters=None,
                 token_mask_fn=None, generator=None):
        """Autoregressive decoding on a static (or paged) kv cache
        (models/generation.py)."""
        from .generation import generate as _gen

        return _gen(self, input_ids, max_new_tokens, do_sample, temperature,
                    top_k, top_p, eos_token_id, pad_token_id,
                    cache_dtype=cache_dtype, kv_layout=kv_layout,
                    page_size=page_size, share_prefix=share_prefix,
                    spec_k=spec_k, spec_drafter=spec_drafter,
                    adapter_id=adapter_id, adapters=adapters,
                    token_mask_fn=token_mask_fn, generator=generator)
