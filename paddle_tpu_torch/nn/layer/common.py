"""Linear, Embedding, Dropout (port of paddle_tpu/nn/layer/common.py)."""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Embedding", "Dropout"]


class Linear(Layer):
    """weight (in_features, out_features), bias (out_features,): paddle's
    layout, not torch.nn.Linear's, so weights cross without transposes."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, **factory):
        super().__init__(**factory)
        self._in_features = in_features
        self._out_features = out_features
        self.weight = self.create_parameter(
            shape=[in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(
            shape=[out_features], attr=bias_attr, is_bias=True)

    def forward(self, input):  # noqa: A002
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Embedding(Layer):
    """A lookup table (num_embeddings, embedding_dim) drawn from N(0, 1);
    the ``padding_idx`` row starts at zero and its positions give zero
    rows. ``sparse=True``: the weight's gradient is a sparse COO tensor
    in eager mode (F.embedding)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, **factory):
        super().__init__(**factory)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._sparse = sparse
        self._padding_idx = (None if padding_idx is None else
                             padding_idx if padding_idx >= 0
                             else num_embeddings + padding_idx)
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self._padding_idx,
                           sparse=self._sparse)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Dropout(Layer):
    """Identity in eval; in training draws its mask from the layer's
    generator."""

    def __init__(self, p=0.5, **factory):
        super().__init__(**factory)
        self.p = p

    def forward(self, input):  # noqa: A002
        return F.dropout(input, p=self.p, training=self.training,
                         generator=self._generator)

    def extra_repr(self):
        return f"p={self.p}"
