"""Linear, Embedding and Dropout (counterpart of paddle_tpu/nn/layer/common.py).

These are ``torch.nn.Linear``/``Embedding`` with the reference's
initializers and a Paddle-style ``bias_attr``.  One layout difference: the
reference stores a Linear weight as ``[in, out]`` (``y = x @ W``), the port
as torch's ``[out, in]`` (``y = x @ W.T``); ``paddle_tpu_torch.convert``
transposes when weights cross over.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..functional.common import dropout


class Linear(nn.Linear):
    """y = x W^T + b; weight [out, in], Xavier-normal init, zero bias."""

    def __init__(self, in_features, out_features, bias_attr=None, *,
                 device=None, dtype=None):
        super().__init__(in_features, out_features,
                         bias=bias_attr is not False, device=device,
                         dtype=dtype)

    def reset_parameters(self, generator=None):
        std = math.sqrt(2.0 / (self.in_features + self.out_features))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)
            if self.bias is not None:
                self.bias.zero_()


class Embedding(nn.Embedding):
    """Lookup table [num_embeddings, embedding_dim], N(0, 1) init."""

    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=None):
        super().__init__(num_embeddings, embedding_dim, device=device,
                         dtype=dtype)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)


class Dropout(nn.Module):
    """``F.dropout`` with this layer's p, axis and mode, active in training
    mode (``self.training``) only."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train"):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training, mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"
