"""BERT / ERNIE encoder family (counterpart of paddle_tpu/models/bert.py).

The standard BERT encoder with Paddle-style MLM + NSP pretraining heads, as
in the reference: post-LN layers whose two dropout + residual + LayerNorm
steps go through ``F.fused_dropout_add_layer_norm`` (the fused kernel on
CUDA) when the layer's dropout upscales in training, attention through
``F.scaled_dot_product_attention`` (the encoder kernel, with its in-kernel
dropout, on CUDA without a mask), and the MLM decoder tied to the word
embedding.  ERNIE is the same encoder with task-type embeddings.  Parameter
names are the reference's, so ``paddle_tpu_torch.convert`` carries weights
both ways.  Not ported yet, and raising: ``tensor_parallel`` (the
distributed slice, ROADMAP.md Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
from torch import nn

from .. import nn as pnn
from ..core.device import resolve_device
from ..nn import functional as F


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    tensor_parallel: bool = False
    use_task_id: bool = False  # ERNIE task-type embedding

    @staticmethod
    def base(**kw):
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=1024, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=512,
                    max_position_embeddings=128)
        base.update(kw)
        return BertConfig(**base)


ErnieConfig = BertConfig


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = config.hidden_size
        self.word_embeddings = pnn.Embedding(config.vocab_size, h, **kw)
        self.position_embeddings = pnn.Embedding(config.max_position_embeddings, h, **kw)
        self.token_type_embeddings = pnn.Embedding(config.type_vocab_size, h, **kw)
        if config.use_task_id:
            self.task_type_embeddings = pnn.Embedding(16, h, **kw)
        self.layer_norm = pnn.LayerNorm(h, epsilon=config.layer_norm_eps, **kw)
        self.dropout = pnn.Dropout(config.hidden_dropout_prob)
        self._use_task_id = config.use_task_id

    def forward(self, input_ids, token_type_ids=None, position_ids=None, task_type_ids=None):
        S = input_ids.shape[1]
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(S, device=dev)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids.long())
               + self.position_embeddings(position_ids.long())
               + self.token_type_embeddings(token_type_ids.long()))
        if self._use_task_id and task_type_ids is not None:
            emb = emb + self.task_type_embeddings(task_type_ids.long())
        return self.dropout(self.layer_norm(emb))


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, dtype=None):
        super().__init__()
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        h = config.hidden_size
        self.qkv = pnn.Linear(h, 3 * h, device=device, dtype=dtype)
        self.out = pnn.Linear(h, h, device=device, dtype=dtype)
        self.attn_drop = config.attention_probs_dropout_prob

    def forward(self, x, mask=None):
        B, S = x.shape[0], x.shape[1]
        qkv = self.qkv(x).reshape(B, S, 3, self.num_heads, self.head_dim)
        # three strided views the kernels read in place; unbind's backward
        # stacks the three gradients once
        q, k, v = qkv.unbind(2)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=self.attn_drop if self.training else 0.0)
        return self.out(out.reshape(B, S, self.num_heads * self.head_dim))


class BertLayer(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention = BertSelfAttention(config, **kw)
        self.attn_norm = pnn.LayerNorm(h, epsilon=eps, **kw)
        self.ffn_in = pnn.Linear(h, config.intermediate_size, **kw)
        self.ffn_out = pnn.Linear(config.intermediate_size, h, **kw)
        self.ffn_norm = pnn.LayerNorm(h, epsilon=eps, **kw)
        self.dropout = pnn.Dropout(config.hidden_dropout_prob)
        self.act = getattr(F, config.hidden_act)

    def forward(self, x, mask=None):
        # dropout + residual + LN in one kernel on CUDA
        # (F.fused_dropout_add_layer_norm).  The Dropout sublayer's own
        # flags rule, as in the reference: the fused path assumes
        # upscale_in_train, so other modes take the composed ops
        drop = self.dropout
        if drop.mode != "upscale_in_train":
            x = self.attn_norm(x + drop(self.attention(x, mask)))
            return self.ffn_norm(x + drop(self.ffn_out(self.act(self.ffn_in(x)))))
        x = F.fused_dropout_add_layer_norm(
            self.attention(x, mask), x, self.attn_norm.weight, self.attn_norm.bias,
            drop.p, self.attn_norm._epsilon, drop.training)
        return F.fused_dropout_add_layer_norm(
            self.ffn_out(self.act(self.ffn_in(x))), x, self.ffn_norm.weight,
            self.ffn_norm.bias, drop.p, self.ffn_norm._epsilon, drop.training)


class BertModel(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.config = config
        self.embeddings = BertEmbeddings(config, **kw)
        self.encoder = nn.ModuleList([BertLayer(config, **kw)
                                      for _ in range(config.num_hidden_layers)])
        self.pooler = pnn.Linear(config.hidden_size, config.hidden_size, **kw)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, task_type_ids=None):
        """(sequence output [B, S, h], pooled [B, h]).  A 2-D 1/0
        ``attention_mask`` [B, S] becomes an additive [B, 1, 1, S] one."""
        if attention_mask is not None and attention_mask.dim() == 2:
            attention_mask = ((1.0 - attention_mask.float()) * -1e9)[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids, task_type_ids=task_type_ids)
        for layer in self.encoder:
            x = layer(x, attention_mask)
        return x, F.tanh(self.pooler(x[:, 0]))


ErnieModel = BertModel


class BertPretrainingHeads(nn.Module):
    """MLM transform + decoder and NSP head.  Given ``word_embeddings`` (the
    word-embedding module), the MLM decoder is tied to its weight: logits =
    x W_emb^T + b."""

    def __init__(self, config: BertConfig, word_embeddings=None, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = config.hidden_size
        self.transform = pnn.Linear(h, h, **kw)
        self.act = getattr(F, config.hidden_act)
        self.norm = pnn.LayerNorm(h, epsilon=config.layer_norm_eps, **kw)
        # held unregistered, as the reference does (bert.py:180): the weight
        # stays under the embedding's name only, in state_dict() and in
        # parameters(), and both uses add their gradients into it.  The
        # module, not its Parameter, is held, so that .to() and friends
        # keep the two uses tied.
        object.__setattr__(self, "_tied_embedding", word_embeddings)
        if word_embeddings is not None:
            self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size, **kw))
            self.decoder = None
        else:
            self.decoder = pnn.Linear(h, config.vocab_size, **kw)
        self.seq_relationship = pnn.Linear(h, 2, **kw)

    def forward(self, sequence_output, pooled_output, masked_positions=None):
        if masked_positions is not None:
            # the reference pretraining recipe: gather the masked rows before
            # the transform and decoder, so that the [*, vocab] product runs
            # over B * P rows, not B * S.  masked_positions: [B, P] indices
            # into each sequence, or flat [B * P] indices already offset into
            # the flattened [B * S] rows
            B, S, h = sequence_output.shape
            pos = masked_positions.long()
            if pos.dim() == 2:
                pos = (pos + torch.arange(B, device=pos.device)[:, None] * S).reshape(-1)
            sequence_output = sequence_output.reshape(B * S, h)[pos]
        x = self.norm(self.act(self.transform(sequence_output)))
        if self._tied_embedding is not None:
            mlm = torch.matmul(x, self._tied_embedding.weight.t()) + self.decoder_bias
        else:
            mlm = self.decoder(x)
        return mlm, self.seq_relationship(pooled_output)


class BertForPretraining(nn.Module):
    """MLM + NSP pretraining."""

    def __init__(self, config: BertConfig, device=None, dtype=None):
        """``device`` defaults to cuda (raises without it; pass "cpu" for the
        CPU); ``dtype`` to torch's default.  Parameters start from the
        reference's initializers on the global torch RNG: call
        ``init_weights(generator)`` for a seeded init, or load converted
        weights (paddle_tpu_torch.convert)."""
        super().__init__()
        if config.tensor_parallel:
            raise NotImplementedError(
                "BERT tensor parallelism is not ported yet (ROADMAP.md Queue 1 item 4: "
                "distributed)")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.config = config
        self.bert = BertModel(config, **kw)
        self.cls = BertPretrainingHeads(config, self.bert.embeddings.word_embeddings, **kw)

    @property
    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init_weights(self, generator=None):
        """Re-initialize every parameter with the reference's initializers
        (Xavier-normal Linear, N(0, 1) Embedding, ones/zeros LayerNorm, a
        zero decoder bias), drawing from ``generator``."""
        for m in self.modules():
            if isinstance(m, (pnn.Linear, pnn.Embedding, pnn.LayerNorm)):
                m.reset_parameters(generator=generator)
        if self.cls.decoder is None:
            self.cls.decoder_bias.zero_()
        return self

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_label=None, masked_positions=None):
        """(mlm_logits, nsp_logits); with ``masked_lm_labels``, (loss,
        mlm_logits): the MLM cross entropy (rows labelled -100 ignored) plus,
        with ``next_sentence_label``, the NSP one.  With ``masked_positions``
        [B, P], ``masked_lm_labels`` are the gathered [B, P] (or flat)
        labels of those positions."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        mlm_logits, nsp_logits = self.cls(seq, pooled, masked_positions)
        if masked_lm_labels is None:
            return mlm_logits, nsp_logits
        loss = F.cross_entropy(mlm_logits.reshape(-1, self.config.vocab_size),
                               masked_lm_labels.reshape(-1), ignore_index=-100)
        if next_sentence_label is not None:
            loss = loss + F.cross_entropy(nsp_logits, next_sentence_label.reshape(-1))
        return loss, mlm_logits


class ErnieForPretraining(BertForPretraining):
    def __init__(self, config: BertConfig, device=None, dtype=None):
        super().__init__(dataclasses.replace(config, use_task_id=True), device, dtype)
