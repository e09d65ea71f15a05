"""LLaMA-2 family (counterpart of paddle_tpu/models/llama.py).

RMSNorm + RoPE + GQA + SwiGLU as in the reference.  Ported here: the
no-cache forward and the prefill bootstrap, whose attention routes as the
reference's does (nn/functional/attention.py: the encoder or flash kernel on
CUDA where the reference runs its Pallas kernel, dense math elsewhere);
the growing (k, v) cache; the STATIC 3/5-tuple caches of generate() and the
dense engine (the static decode kernel); and the PAGED 4/6-tuple caches of
the paged engine (the ragged paged kernel); and the training loss
(``LlamaForCausalLM(ids, labels=)``), differentiable through the same
routing.  Not ported yet, and raising: tensor and sequence parallelism
(the distributed slice), and an external attention mask together with a
static or paged cache.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import nn as pnn
from ..core.device import resolve_device
from ..nn import functional as F
from .kv_cache import paged_attention_update, static_attention_update

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    dtype: str = "float32"
    # The reference defaults tensor_parallel to True and expresses it as
    # sharding annotations; on one device the port runs dense, and asking
    # for either plan raises until the distributed slice (ROADMAP.md).
    tensor_parallel: bool = False
    sequence_parallel: bool = False

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=1024, hidden_size=256, intermediate_size=688,
                    num_hidden_layers=2, num_attention_heads=8,
                    num_key_value_heads=4, max_position_embeddings=512)
        base.update(kw)
        return LlamaConfig(**base)


def _rope_cache(head_dim, max_pos, theta):
    """numpy (cos, sin) tables [max_pos, head_dim / 2] in f32."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(max_pos, dtype=np.float32)
    freqs = np.outer(t, inv)
    return np.cos(freqs), np.sin(freqs)


def apply_rope(x, cos, sin, position_offset=0):
    """x [B, S, H, D]; rotate-half RoPE — pairs (x_i, x_{i+D/2}).
    ``position_offset`` is an int, a 0-d tensor, or a PER-SLOT [B] tensor
    (continuous-batching slots at different depths)."""
    S, D = x.shape[1], x.shape[-1]
    if isinstance(position_offset, (int, np.integer)):
        c = cos[position_offset:position_offset + S][None, :, None, :]
        s = sin[position_offset:position_offset + S][None, :, None, :]
    else:
        off = position_offset.to(device=x.device, dtype=torch.int64)
        steps = torch.arange(S, device=x.device)
        if off.dim() >= 1:
            pos = off[:, None] + steps[None, :]  # [B, S]
            c, s = cos[pos][:, :, None, :], sin[pos][:, :, None, :]
        else:
            pos = off + steps
            c, s = cos[pos][None, :, None, :], sin[pos][None, :, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        kw = dict(bias_attr=False, device=device, dtype=dtype)
        self.q_proj = pnn.Linear(self.hidden_size, self.num_heads * self.head_dim, **kw)
        self.k_proj = pnn.Linear(self.hidden_size, self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = pnn.Linear(self.hidden_size, self.num_kv_heads * self.head_dim, **kw)
        self.o_proj = pnn.Linear(self.num_heads * self.head_dim, self.hidden_size, **kw)

    def forward(self, hidden_states, rope, attn_mask=None, cache=None,
                use_cache=False):
        """cache: None, a growing (k, v) pair [B, S, Hkv, D], a static
        3/5-tuple or a paged 4/6-tuple (models/kv_cache.py).  Returns out,
        or (out, new_cache) when a cache is given or ``use_cache`` is set;
        cache=None with use_cache is the prefill bootstrap, whose new cache
        is the (k, v) pair of this call."""
        rope_cos, rope_sin = rope
        B, S = hidden_states.shape[0], hidden_states.shape[1]
        q = self.q_proj(hidden_states).reshape(B, S, self.num_heads, self.head_dim)
        k = self.k_proj(hidden_states).reshape(B, S, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden_states).reshape(B, S, self.num_kv_heads, self.head_dim)
        use_cache = use_cache or cache is not None
        indexed = cache is not None and len(cache) in (3, 4, 5, 6)
        if indexed:
            offset = cache[2]
        else:
            offset = cache[0].shape[1] if cache is not None else 0
        q = apply_rope(q, rope_cos, rope_sin, offset)
        k = apply_rope(k, rope_cos, rope_sin, offset)

        if indexed:
            if attn_mask is not None:
                raise NotImplementedError(
                    "an external attention mask with a static or paged cache is "
                    "not ported (ROADMAP.md Queue 1 item 6: the rest of the "
                    "surface)")
            update = (paged_attention_update if len(cache) in (4, 6)
                      else static_attention_update)
            new_cache, out = update(cache, q, k, v, offset)
            return self.o_proj(out.reshape(B, S, -1)), new_cache
        if cache is not None:  # the growing cache: append this call's rows
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        new_cache = (k, v)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        backend = "auto" if self.config.use_flash_attention else "math"
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
            backend=backend)
        out = self.o_proj(out.reshape(B, S, -1))
        return (out, new_cache) if use_cache else out


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        kw = dict(bias_attr=False, device=device, dtype=dtype)
        self.gate_proj = pnn.Linear(h, inter, **kw)
        self.up_proj = pnn.Linear(h, inter, **kw)
        self.down_proj = pnn.Linear(inter, h, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, **kw)
        self.mlp = LlamaMLP(config, **kw)
        self.input_layernorm = pnn.RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.post_attention_layernorm = pnn.RMSNorm(config.hidden_size,
                                                    config.rms_norm_eps, **kw)

    def forward(self, x, rope, attn_mask=None, cache=None, use_cache=False):
        h = self.input_layernorm(x)
        use_cache = use_cache or cache is not None
        if use_cache:
            attn_out, cache = self.self_attn(h, rope, attn_mask, cache, True)
        else:
            attn_out = self.self_attn(h, rope, attn_mask)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return (x, cache) if use_cache else x


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = pnn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.layers = nn.ModuleList([LlamaDecoderLayer(config, **kw)
                                     for _ in range(config.num_hidden_layers)])
        self.norm = pnn.RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        cos, sin = _rope_cache(config.hidden_size // config.num_attention_heads,
                               config.max_position_embeddings, config.rope_theta)
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(device=device, dtype=dtype),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(device=device, dtype=dtype),
                             persistent=False)

    def forward(self, input_ids, attn_mask=None, caches=None, use_cache=False):
        """caches=None and use_cache=False: the no-cache forward, returns
        hidden states.  caches=None with use_cache=True is the prefill
        bootstrap; otherwise one cache per layer.  Both return (hidden,
        new_caches)."""
        x = self.embed_tokens(input_ids.long())
        rope = (self.rope_cos, self.rope_sin)
        if caches is None and not use_cache:
            for layer in self.layers:
                x = layer(x, rope, attn_mask)
            return self.norm(x)
        if caches is None:
            caches = [None] * len(self.layers)
        new_caches = []
        for layer, cache in zip(self.layers, caches, strict=True):
            x, cache = layer(x, rope, attn_mask, cache, use_cache=True)
            new_caches.append(cache)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    _supports_quant_cache = True  # LlamaAttention understands the 5-tuple
    _supports_paged_cache = True  # ... and the paged 4/6-tuples

    def __init__(self, config: LlamaConfig, device=None, dtype=None):
        """``device`` defaults to cuda (raises without it; pass "cpu" for the
        CPU); ``dtype`` defaults to ``config.dtype``.  Parameters start from
        the reference's initializers on the global torch RNG — call
        ``init_weights(generator)`` for a seeded init, or load converted
        weights (paddle_tpu_torch.convert)."""
        super().__init__()
        if config.tensor_parallel or config.sequence_parallel:
            raise NotImplementedError(
                "tensor/sequence parallelism is not ported yet (ROADMAP.md "
                "Queue 1: distributed)")
        dev = resolve_device(device)
        dt = _DTYPES[config.dtype] if dtype is None else dtype
        self.config = config
        self.llama = LlamaModel(config, device=dev, dtype=dt)
        self.lm_head = pnn.Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False, device=dev, dtype=dt)

    @property
    def device(self):
        return self.lm_head.weight.device

    @property
    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init_weights(self, generator=None):
        """Re-initialize every parameter with the reference's initializers
        (Xavier-normal Linear, N(0, 1) Embedding, ones RMSNorm), drawing
        from ``generator``."""
        for m in self.modules():
            if isinstance(m, (pnn.Linear, pnn.Embedding, pnn.RMSNorm)):
                m.reset_parameters(generator=generator)
        return self

    def forward(self, input_ids, labels=None):
        """Logits [B, S, V]; with ``labels`` [B, S], ``(loss, logits)``: the
        mean cross entropy of every position's logits against its label
        (no shift, rows labelled -100 ignored), as the reference computes
        it."""
        logits = self.lm_head(self.llama(input_ids))
        if labels is None:
            return logits
        V = self.config.vocab_size
        loss = F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1), ignore_index=-100)
        return loss, logits

    def generate_step(self, input_ids, caches=None):
        """Prefill (caches=None: returns per-layer (k, v) [B, S, Hkv, D]) or
        a decode step over static, paged or growing caches: logits of the
        LAST position [B, 1, V] and the updated caches."""
        hidden, caches = self.llama(input_ids, caches=caches, use_cache=True)
        return self.lm_head(hidden[:, -1:]), caches

    def prefill_step(self, input_ids, last_index):
        """Bucket-padded prefill (dense-engine admission): the prompt is
        padded past ``last_index``, so the next-token logits are taken
        there (causal attention keeps positions <= last_index exact under
        the padding).  Returns (logits [B, 1, V], per-layer (k, v))."""
        hidden, caches = self.llama(input_ids, use_cache=True)
        i = int(last_index)
        return self.lm_head(hidden[:, i:i + 1]), caches

    def prefill_chunk_step(self, input_ids, caches, last_index):
        """One CHUNK of a paged prefill: input_ids [B, C] are the next C prompt
        tokens (pad-padded past ``last_index`` on the final chunk); the paged
        caches carry pos = tokens already prefilled.  Returns (logits
        [B, 1, V] at ``last_index``, caches)."""
        hidden, caches = self.llama(input_ids, caches=caches)
        i = int(last_index)
        return self.lm_head(hidden[:, i:i + 1]), caches

    def generate(self, input_ids, max_new_tokens=32, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, eos_token_id=None,
                 pad_token_id=0, cache_dtype=None, kv_layout=None,
                 page_size=128, share_prefix=False, spec_k=0,
                 spec_drafter=None, adapter_id=None, adapters=None,
                 token_mask_fn=None, generator=None):
        """Autoregressive decoding: a prefill, then one decode step per
        token over a static (or, with kv_layout="paged", paged) kv cache
        (models/generation.py).  ``generator`` is the torch.Generator that
        sampled tokens draw from (default: the model device's seeded one)."""
        from .generation import generate as _gen

        return _gen(self, input_ids, max_new_tokens, do_sample, temperature,
                    top_k, top_p, eos_token_id, pad_token_id,
                    cache_dtype=cache_dtype, kv_layout=kv_layout,
                    page_size=page_size, share_prefix=share_prefix,
                    spec_k=spec_k, spec_drafter=spec_drafter,
                    adapter_id=adapter_id, adapters=adapters,
                    token_mask_fn=token_mask_fn, generator=generator)
