"""Loss layers (counterpart of paddle_tpu/nn/layer/loss.py)."""
from __future__ import annotations

from torch import nn

from ..functional.loss import cross_entropy


class CrossEntropyLoss(nn.Module):
    """``F.cross_entropy`` with this layer's arguments."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean", soft_label=False,
                 axis=-1, use_softmax=True, label_smoothing=0.0, name=None):
        super().__init__()
        self.weight = weight
        self.args = dict(ignore_index=ignore_index, reduction=reduction, soft_label=soft_label,
                         axis=axis, use_softmax=use_softmax, label_smoothing=label_smoothing)

    def forward(self, input, label):
        return cross_entropy(input, label, weight=self.weight, **self.args)
