"""Loss layers (ref paddle_tpu/nn/layer/loss.py)."""

from __future__ import annotations

from .layers import Layer

from .. import functional as F

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    """Hard-label softmax cross entropy over the last axis (the
    reference's defaults); class weights, soft labels, another axis and
    ``use_softmax=False`` are not ported yet."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        if weight is not None or soft_label or axis != -1 or \
                not use_softmax:
            raise NotImplementedError(
                "CrossEntropyLoss: only hard labels over the last axis "
                "with softmax and no class weights are ported yet")
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.cross_entropy(input, label, ignore_index=self._ignore_index,
                               reduction=self._reduction)
