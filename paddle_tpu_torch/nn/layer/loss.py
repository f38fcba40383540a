"""Loss layers (ref paddle_tpu/nn/layer/loss.py): each calls its
`nn.functional` loss with the arguments it was built with."""

from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss",
           "MarginRankingLoss", "CTCLoss", "HSigmoidLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction
        self._soft_label = soft_label
        self._axis = axis
        self._use_softmax = use_softmax

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self._weight,
            ignore_index=self._ignore_index, reduction=self._reduction,
            soft_label=self._soft_label, axis=self._axis,
            use_softmax=self._use_softmax)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self._weight, self._ignore_index,
                          self._reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self._weight,
                                      self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction
        self._pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self._weight, self._reduction, self._pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction = reduction
        self._delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          blank=self.blank, reduction=self.reduction,
                          norm_by_times=norm_by_times)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid loss: weight [num_classes - 1, feature_size]
    and bias [num_classes - 1, 1] over the default tree (num_classes
    rows with ``is_custom``)."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, generator=None):
        super().__init__()
        if not is_custom and num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self._feature_size = feature_size
        self._num_classes = num_classes
        self._is_custom = is_custom
        rows = num_classes if is_custom else num_classes - 1
        self.weight = self.create_parameter(
            [rows, feature_size], attr=weight_attr, generator=generator)
        self.bias = self.create_parameter(
            [rows, 1], attr=bias_attr, is_bias=True, generator=generator)

    def forward(self, input, label, path_table=None, path_code=None):
        if self._is_custom and (path_table is None or path_code is None):
            raise ValueError("is_custom=True needs path_table and path_code")
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight,
                               self.bias, path_table, path_code)
