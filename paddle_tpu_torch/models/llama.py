"""LLaMA-2 family (counterpart of paddle_tpu/models/llama.py).

RMSNorm + RoPE + GQA + SwiGLU as in the reference.  Ported here: the
no-cache forward (the reference's dense ``backend="math"`` attention) and
the PAGED 4/6-tuple caches that the serving engine drives through the
ragged paged-attention kernel.  Not ported yet, and raising: the static
3/5-tuple and growing (k, v) caches (the generate() slice), tensor and
sequence parallelism (the distributed slice), the training loss, and the
flash/encoder attention kernels the reference picks for some no-cache
shapes on its accelerator (see nn/functional/attention.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import nn as pnn
from ..core.device import resolve_device
from ..nn import functional as F
from .kv_cache import paged_attention_update

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

    def forward(self, hidden_states, rope, attn_mask=None, cache=None):
        """cache: None (the no-cache forward; returns out) or a paged 4/6-tuple
        (k_pages, v_pages, pos, page_tbl[, k_scale, v_scale]); returns
        (out, new_cache)."""
        rope_cos, rope_sin = rope
        B, S = hidden_states.shape[0], hidden_states.shape[1]
        q = self.q_proj(hidden_states).reshape(B, S, self.num_heads, self.head_dim)
        k = self.k_proj(hidden_states).reshape(B, S, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden_states).reshape(B, S, self.num_kv_heads, self.head_dim)

        if cache is not None and len(cache) not in (4, 6):
            raise NotImplementedError(
                "static kv caches (and growing (k, v) ones) are not ported "
                "yet (ROADMAP.md Queue 1: the static decode kernel with "
                "generate() and the dense engine)")
        if cache is not None:
            if attn_mask is not None:
                raise NotImplementedError(
                    "an external attention mask with a paged cache has no path "
                    "in the reference either")
            offset = cache[2]
            q = apply_rope(q, rope_cos, rope_sin, offset)
            k = apply_rope(k, rope_cos, rope_sin, offset)
            new_cache, out = paged_attention_update(cache, q, k, v, offset)
            return self.o_proj(out.reshape(B, S, -1)), new_cache
        q = apply_rope(q, rope_cos, rope_sin, 0)
        k = apply_rope(k, rope_cos, rope_sin, 0)
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        backend = "auto" if self.config.use_flash_attention else "math"
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=attn_mask is None,
            backend=backend)
        return self.o_proj(out.reshape(B, S, -1))


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

    def forward(self, x, rope, attn_mask=None, cache=None):
        h = self.input_layernorm(x)
        if cache is None:
            attn_out = self.self_attn(h, rope, attn_mask)
        else:
            attn_out, cache = self.self_attn(h, rope, attn_mask, cache)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x if cache is None else (x, cache)


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

    def forward(self, input_ids, attn_mask=None, caches=None):
        """caches=None: the no-cache forward, returns hidden states.  With one
        paged cache tuple per layer: returns (hidden, new_caches)."""
        x = self.embed_tokens(input_ids.long())
        rope = (self.rope_cos, self.rope_sin)
        if caches is None:
            for layer in self.layers:
                x = layer(x, rope, attn_mask)
            return self.norm(x)
        new_caches = []
        for layer, cache in zip(self.layers, caches, strict=True):
            x, cache = layer(x, rope, attn_mask, cache)
            new_caches.append(cache)
        return self.norm(x), new_caches


class LlamaForCausalLM(nn.Module):
    _supports_paged_cache = True  # LlamaAttention understands the paged tuples

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
        if labels is not None:
            raise NotImplementedError(
                "the training loss is not ported yet (ROADMAP.md Queue 1: "
                "flash attention forward/backward with training)")
        return self.lm_head(self.llama(input_ids))

    def generate_step(self, input_ids, caches):
        """Decode step over paged caches: logits of the LAST position
        [B, 1, V] and the updated caches.  (The reference's caches=None
        prefill bootstrap feeds the static caches of the generate() slice.)"""
        hidden, caches = self.llama(input_ids, caches=caches)
        return self.lm_head(hidden[:, -1:]), caches

    def prefill_chunk_step(self, input_ids, caches, last_index):
        """One CHUNK of a paged prefill: input_ids [B, C] are the next C prompt
        tokens (pad-padded past ``last_index`` on the final chunk); the paged
        caches carry pos = tokens already prefilled.  Returns (logits
        [B, 1, V] at ``last_index``, caches)."""
        hidden, caches = self.llama(input_ids, caches=caches)
        i = int(last_index)
        return self.lm_head(hidden[:, i:i + 1]), caches
