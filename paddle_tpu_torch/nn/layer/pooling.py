"""The pooling layers, 1-D to 3-D and adaptive (port of
paddle_tpu/nn/layer/pooling.py).

The reference's windowed layers take (kernel_size, stride, padding,
ceil_mode, data_format) in that order, the format defaulting to each
rank's channel-first one, and keep any other keyword without reading it:
``return_mask=True``, ``exclusive=False`` or a ``divisor_override`` on a
layer, and ``return_mask=True`` on an adaptive max pooling layer, raise
here (ROADMAP C-ref-17)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D"]

_FACTORY = ("device", "dtype", "generator")
# the keywords the reference's layers accept and never read, with the
# value that matches what they do
_UNREAD = {"return_mask": False, "exclusive": True, "divisor_override": None}


def _refuse_unread(kw):
    for key, value in kw.items():
        if key not in _UNREAD:
            raise TypeError(f"unexpected keyword argument {key!r}")
        if value != _UNREAD[key]:
            raise NotImplementedError(
                f"{key}={value!r}: the reference's layer accepts it but "
                f"never reads it (ROADMAP C-ref-17)")


class _PoolNd(Layer):
    _ndim = 2

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format=None, name=None, **kw):
        super().__init__(**{k: kw.pop(k) for k in _FACTORY if k in kw})
        _refuse_unread(kw)
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.data_format = data_format or ("NCL", "NCHW",
                                           "NCDHW")[self._ndim - 1]


class _MaxPool(_PoolNd):
    def forward(self, x):
        pool = getattr(F, f"max_pool{self._ndim}d")
        return pool(x, self.kernel_size, self.stride, self.padding,
                    ceil_mode=self.ceil_mode, data_format=self.data_format)


class _AvgPool(_PoolNd):
    def forward(self, x):
        pool = getattr(F, f"avg_pool{self._ndim}d")
        return pool(x, self.kernel_size, self.stride, self.padding,
                    ceil_mode=self.ceil_mode, data_format=self.data_format)


class MaxPool1D(_MaxPool):
    _ndim = 1


class MaxPool2D(_MaxPool):
    _ndim = 2


class MaxPool3D(_MaxPool):
    _ndim = 3


class AvgPool1D(_AvgPool):
    _ndim = 1


class AvgPool2D(_AvgPool):
    _ndim = 2


class AvgPool3D(_AvgPool):
    _ndim = 3


class _AdaptivePool(Layer):
    def __init__(self, output_size, fn, data_format=None, **factory):
        super().__init__(**factory)
        self.output_size = output_size
        self.data_format = data_format
        self._fn = fn

    def forward(self, x):
        if self.data_format is None:
            return self._fn(x, self.output_size)
        return self._fn(x, self.output_size, self.data_format)


class AdaptiveAvgPool1D(_AdaptivePool):
    def __init__(self, output_size, name=None, **factory):
        super().__init__(output_size, F.adaptive_avg_pool1d, **factory)


class AdaptiveAvgPool2D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCHW", name=None,
                 **factory):
        super().__init__(output_size, F.adaptive_avg_pool2d, data_format,
                         **factory)


class AdaptiveAvgPool3D(_AdaptivePool):
    def __init__(self, output_size, data_format="NCDHW", name=None,
                 **factory):
        super().__init__(output_size, F.adaptive_avg_pool3d, data_format,
                         **factory)


class _AdaptiveMaxPool(_AdaptivePool):
    def __init__(self, output_size, fn, return_mask, **factory):
        _refuse_unread({"return_mask": return_mask})
        super().__init__(output_size, fn, **factory)


class AdaptiveMaxPool1D(_AdaptiveMaxPool):
    def __init__(self, output_size, return_mask=False, name=None,
                 **factory):
        super().__init__(output_size, F.adaptive_max_pool1d, return_mask,
                         **factory)


class AdaptiveMaxPool2D(_AdaptiveMaxPool):
    def __init__(self, output_size, return_mask=False, name=None,
                 **factory):
        super().__init__(output_size, F.adaptive_max_pool2d, return_mask,
                         **factory)


class AdaptiveMaxPool3D(_AdaptiveMaxPool):
    def __init__(self, output_size, return_mask=False, name=None,
                 **factory):
        super().__init__(output_size, F.adaptive_max_pool3d, return_mask,
                         **factory)
