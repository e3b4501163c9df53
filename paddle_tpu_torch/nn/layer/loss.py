"""Loss layers (port of paddle_tpu/nn/layer/loss.py).

Each layer holds its options and calls its function in
``nn.functional``. A loss without parameters is a plain
``torch.nn.Module`` (``_Loss``): it has nothing to place, so it takes no
device and runs wherever its inputs are (a class ``weight`` is given on
the inputs' device). ``HSigmoidLoss`` owns a weight table and is a
``Layer``.
"""
from __future__ import annotations

import torch

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss",
           "MarginRankingLoss", "CTCLoss", "HingeEmbeddingLoss",
           "CosineEmbeddingLoss", "TripletMarginLoss",
           "SoftMarginLoss", "MultiLabelSoftMarginLoss", "PoissonNLLLoss",
           "TripletMarginWithDistanceLoss",
           "HSigmoidLoss"]


class _Loss(torch.nn.Module):
    """A loss layer without parameters."""


class CrossEntropyLoss(_Loss):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, weight=self.weight,
                               ignore_index=self.ignore_index,
                               reduction=self.reduction,
                               soft_label=self.soft_label, axis=self.axis,
                               use_softmax=self.use_softmax)


class MSELoss(_Loss):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.mse_loss(input, label, self.reduction)


class L1Loss(_Loss):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.l1_loss(input, label, self.reduction)


class NLLLoss(_Loss):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.nll_loss(input, label, self.weight, self.ignore_index,
                          self.reduction)


class BCELoss(_Loss):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.binary_cross_entropy(input, label, self.weight,
                                      self.reduction)


class BCEWithLogitsLoss(_Loss):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight = weight
        self.reduction = reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self.weight, self.reduction, self.pos_weight)


class KLDivLoss(_Loss):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.kl_div(input, label, self.reduction)


class SmoothL1Loss(_Loss):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction = reduction
        self.delta = delta

    def forward(self, input, label):  # noqa: A002
        return F.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(_Loss):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, other, label):  # noqa: A002
        return F.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class CTCLoss(_Loss):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HingeEmbeddingLoss(_Loss):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input, label):  # noqa: A002
        return F.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(_Loss):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.reduction = reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class TripletMarginLoss(_Loss):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin = margin
        self.p = p
        self.epsilon = epsilon
        self.swap = swap
        self.reduction = reduction

    def forward(self, input, positive, negative):  # noqa: A002
        return F.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class SoftMarginLoss(_Loss):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.soft_margin_loss(input, label, reduction=self._reduction)


class MultiLabelSoftMarginLoss(_Loss):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(
            input, label, weight=self._weight, reduction=self._reduction)


class PoissonNLLLoss(_Loss):
    def __init__(self, log_input=True, full=False, epsilon=1e-8,
                 reduction="mean", name=None):
        super().__init__()
        self._log_input = log_input
        self._full = full
        self._epsilon = epsilon
        self._reduction = reduction

    def forward(self, input, label):
        return F.poisson_nll_loss(input, label, log_input=self._log_input,
                                  full=self._full, epsilon=self._epsilon,
                                  reduction=self._reduction)


class TripletMarginWithDistanceLoss(_Loss):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._distance_function = distance_function
        self._margin = margin
        self._swap = swap
        self._reduction = reduction

    def forward(self, input, positive, negative):
        return F.triplet_margin_with_distance_loss(
            input, positive, negative,
            distance_function=self._distance_function, margin=self._margin,
            swap=self._swap, reduction=self._reduction)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid loss layer (reference nn/layer/loss.py
    HSigmoidLoss): owns the internal-node weight table and delegates to
    F.hsigmoid_loss's complete-binary-tree path layout; takes the
    device, dtype and generator of its table as every Layer does."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None,
                 **factory):
        super().__init__(**factory)
        if is_custom:
            raise NotImplementedError(
                "custom-tree HSigmoidLoss is not implemented")
        self._num_classes = num_classes
        self.weight = self.create_parameter(
            [num_classes - 1 if num_classes > 1 else 1, feature_size],
            attr=weight_attr)
        self.bias = (self.create_parameter(
            [num_classes - 1 if num_classes > 1 else 1], attr=bias_attr,
            is_bias=True) if bias_attr is not False else None)

    def forward(self, input, label):
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight,
                               self.bias)
