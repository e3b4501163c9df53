"""MaxPool2D, AvgPool2D and AdaptiveAvgPool2D (port of
paddle_tpu/nn/layer/pooling.py)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D"]


class _PoolNd(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format="NCHW", name=None, **factory):
        super().__init__(**factory)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format


class MaxPool2D(_PoolNd):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class AvgPool2D(_PoolNd):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None,
                 **factory):
        super().__init__(**factory)
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)
