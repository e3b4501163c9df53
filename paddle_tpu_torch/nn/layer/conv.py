"""Conv2D (port of paddle_tpu/nn/layer/conv.py).

The weight is OIHW, (out, in / groups, kh, kw), as in the reference and
in torch; weight and bias start at U(-1/sqrt(fan_in), +1/sqrt(fan_in)),
fan_in = in / groups * kh * kw, drawn from the layer's generator. Under
``data_format="NHWC"`` the weight is kept in channels_last memory format,
the one cuDNN's NHWC kernels read, so no call copies it. ``_stride``,
``_padding``, ``_dilation``, ``_groups`` and ``_data_format`` are read by
the fused conv + BN wiring of the vision models, as in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Conv2D"]


def _ntuple(v, n):
    if isinstance(v, (int, np.integer)):
        return [int(v)] * n
    return list(v)


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 **factory):
        super().__init__(**factory)
        if padding_mode != "zeros":
            raise NotImplementedError(
                f"padding_mode={padding_mode!r}: only 'zeros' is ported")
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, 2)
        self._stride = _ntuple(stride, 2)
        self._padding = padding
        self._dilation = _ntuple(dilation, 2)
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        std = 1.0 / math.sqrt(fan_in)
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups] + self._kernel_size,
            attr=weight_attr, default_initializer=I.Uniform(-std, std))
        if data_format == "NHWC":
            with torch.no_grad():
                self.weight.data = self.weight.data.contiguous(
                    memory_format=torch.channels_last)
        self.bias = self.create_parameter(
            shape=[out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-std, std))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride,
                        self._padding, self._dilation, self._groups,
                        self._data_format)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")
