"""Linear, Embedding, Dropout (port of paddle_tpu/nn/layer/common.py)."""
from __future__ import annotations

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
    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 **factory):
        super().__init__(**factory)
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self.weight = self.create_parameter(
            shape=[num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 1.0))

    def forward(self, x):
        return F.embedding(x, self.weight)

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
