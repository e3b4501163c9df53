"""The common layers (port of paddle_tpu/nn/layer/common.py): Linear,
Embedding, the dropouts, Identity, Flatten, the upsamplers, the pads,
CosineSimilarity, Bilinear, Unfold/Fold, the pixel and channel
shuffles, PairwiseDistance and MaxUnPool2D."""
from __future__ import annotations

import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
           "Embedding", "Flatten", "Upsample", "UpsamplingNearest2D",
           "UpsamplingBilinear2D", "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D",
           "CosineSimilarity", "Bilinear", "Identity", "Unfold", "Fold",
           "PixelShuffle", "PixelUnshuffle", "ChannelShuffle",
           "PairwiseDistance", "MaxUnPool2D"]


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):  # noqa: A002
        return input


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
    generator (F.dropout: ``axis``, ``mode``)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 **factory):
        super().__init__(**factory)
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, input):  # noqa: A002
        return F.dropout(input, p=self.p, axis=self.axis,
                         training=self.training, mode=self.mode,
                         generator=self._generator)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None, **factory):
        super().__init__(**factory)
        self.p = p
        self.data_format = data_format

    def forward(self, input):  # noqa: A002
        return F.dropout2d(input, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self._generator)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, **factory):
        super().__init__(**factory)
        self.p = p
        self.data_format = data_format

    def forward(self, input):  # noqa: A002
        return F.dropout3d(input, p=self.p, training=self.training,
                           data_format=self.data_format,
                           generator=self._generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, **factory):
        super().__init__(**factory)
        self.p = p

    def forward(self, input):  # noqa: A002
        return F.alpha_dropout(input, p=self.p, training=self.training,
                               generator=self._generator)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1, **factory):
        super().__init__(**factory)
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, input):  # noqa: A002
        return torch.flatten(input, self.start_axis, self.stop_axis)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None, **factory):
        super().__init__(**factory)
        self.size = size
        self.scale_factor = scale_factor
        self.mode = mode
        self.align_corners = align_corners
        self.align_mode = align_mode
        self.data_format = data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None, **factory):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format, **factory)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None, **factory):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format, **factory)


class _PadNd(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", **factory):
        super().__init__(**factory)
        self.padding = padding
        self.mode = mode
        self.value = value
        self.data_format = data_format

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None, **factory):
        super().__init__(padding, mode, value, data_format, **factory)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None, **factory):
        super().__init__(padding, mode, value, data_format, **factory)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None, **factory):
        super().__init__(padding, mode, value, data_format, **factory)


class ZeroPad2D(_PadNd):
    def __init__(self, padding, data_format="NCHW", name=None, **factory):
        super().__init__(padding, "constant", 0.0, data_format, **factory)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8, **factory):
        super().__init__(**factory)
        self.axis = axis
        self.eps = eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, axis=self.axis, eps=self.eps)


class Bilinear(Layer):
    """weight (out, in1, in2) from XavierNormal, bias (out,) from 0."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, **factory):
        super().__init__(**factory)
        self.weight = self.create_parameter(
            shape=[out_features, in1_features, in2_features],
            attr=weight_attr, default_initializer=I.XavierNormal())
        self.bias = self.create_parameter(shape=[out_features],
                                          attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None, **factory):
        super().__init__(**factory)
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None, **factory):
        super().__init__(**factory)
        self.output_sizes = output_sizes
        self.kernel_sizes = kernel_sizes
        self.strides = strides
        self.paddings = paddings
        self.dilations = dilations

    def forward(self, x):
        return F.fold(x, self.output_sizes, self.kernel_sizes, self.strides,
                      self.paddings, self.dilations)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None,
                 **factory):
        super().__init__(**factory)
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None,
                 **factory):
        super().__init__(**factory)
        self.downscale_factor = downscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None, **factory):
        super().__init__(**factory)
        self.groups = groups
        self.data_format = data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class PairwiseDistance(Layer):
    """The p-norm of x - y + epsilon over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None,
                 **factory):
        super().__init__(**factory)
        self._p = p
        self._epsilon = epsilon
        self._keepdim = keepdim

    def forward(self, x, y):
        d = x - y + self._epsilon
        return torch.sum(d.abs() ** self._p, dim=-1,
                         keepdim=self._keepdim) ** (1.0 / self._p)


class MaxUnPool2D(Layer):
    """The inverse of max_pool2d(return_mask=True): F.max_unpool2d with
    the layer's arguments."""

    def __init__(self, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None,
                 **factory):
        super().__init__(**factory)
        self._args = (kernel_size, stride, padding, data_format, output_size)

    def forward(self, x, indices):
        k, s, p, df, osz = self._args
        return F.max_unpool2d(x, indices, k, stride=s, padding=p,
                              data_format=df, output_size=osz)
