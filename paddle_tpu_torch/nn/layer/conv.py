"""The conv layers, 1-D to 3-D and transposed (port of
paddle_tpu/nn/layer/conv.py).

The weight is (out, in / groups, *k) for a convolution and (in, out /
groups, *k) for a transposed one, as in the reference and in torch;
weight and bias start at U(-1/sqrt(fan_in), +1/sqrt(fan_in)), fan_in =
in / groups * prod(k) for both, drawn from the layer's generator. Under
``data_format="NHWC"`` a Conv2D keeps its weight in channels_last memory
format, the one cuDNN's NHWC kernels read, so no call copies it.
``_stride``, ``_padding``, ``_dilation``, ``_groups`` and
``_data_format`` are read by the fused conv + BN wiring of the vision
models, as in the reference. The reference never reads
``padding_mode``: anything but 'zeros' raises (ROADMAP C-ref-4).
``Conv1DTranspose`` takes ``groups`` before ``dilation``, the others
``dilation`` before ``groups``, each as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return [int(v)] * n
    return list(v)


class _ConvNd(Layer):
    def __init__(self, ndim, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, transpose=False, output_padding=0,
                 **factory):
        super().__init__(**factory)
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: the reference never reads "
                f"it (ROADMAP C-ref-4); only 'zeros' is ported")
        self._ndim = ndim
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, ndim)
        self._stride = _ntuple(stride, ndim)
        self._padding = padding
        self._dilation = _ntuple(dilation, ndim)
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        if transpose:
            shape = [in_channels, out_channels // groups]
        else:
            shape = [out_channels, in_channels // groups]
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        std = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            shape=shape + self._kernel_size, attr=weight_attr,
            default_initializer=I.Uniform(-std, std))
        if data_format == "NHWC":
            with torch.no_grad():
                self.weight.data = self.weight.data.contiguous(
                    memory_format=torch.channels_last)
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-std, std))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class _Conv(_ConvNd):
    def forward(self, x):
        conv = getattr(F, f"conv{self._ndim}d")
        return conv(x, self.weight, self.bias, self._stride, self._padding,
                    self._dilation, self._groups, self._data_format)


class Conv1D(_Conv):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 **factory):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **factory)


class Conv2D(_Conv):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 **factory):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **factory)


class Conv3D(_Conv):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **factory):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, **factory)


class _ConvTranspose(_ConvNd):
    def forward(self, x, output_size=None):
        conv_t = getattr(F, f"conv{self._ndim}d_transpose")
        return conv_t(x, self.weight, self.bias, self._stride, self._padding,
                      self._output_padding, self._groups, self._dilation,
                      output_size, self._data_format)


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 **factory):
        super().__init__(1, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, **factory)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 **factory):
        super().__init__(2, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, **factory)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 **factory):
        super().__init__(3, in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding, **factory)
