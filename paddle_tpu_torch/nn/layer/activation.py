"""Activation layers (port of paddle_tpu/nn/layer/activation.py): one
layer per activation of nn.functional, holding its arguments; PReLU
holds its slope as a parameter. Layers take the port's keyword-only
``device``, ``dtype`` and ``generator``; only PReLU uses them."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["Silu", "ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid",
           "LogSigmoid", "Tanh", "Tanhshrink", "Hardtanh", "Hardshrink",
           "Hardsigmoid", "Hardswish", "LeakyReLU", "PReLU", "Softmax",
           "LogSoftmax", "Softplus", "Softshrink", "Softsign", "Swish",
           "SiLU", "Mish", "Maxout", "ThresholdedReLU", "GLU"]


def _simple(name, fname):
    """A layer class calling ``F.<fname>(x, *args, **kwargs)`` with the
    arguments it was built with (``name`` dropped)."""
    fn = getattr(F, fname)

    class _Act(Layer):
        def __init__(self, *args, device=None, dtype=None, generator=None,
                     **kwargs):
            super().__init__(dtype=dtype, device=device, generator=generator)
            kwargs.pop("name", None)
            self._args = args
            self._kwargs = kwargs

        def forward(self, x):
            return fn(x, *self._args, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
ELU = _simple("ELU", "elu")
SELU = _simple("SELU", "selu")
CELU = _simple("CELU", "celu")
GELU = _simple("GELU", "gelu")
Sigmoid = _simple("Sigmoid", "sigmoid")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Tanh = _simple("Tanh", "tanh")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Hardtanh = _simple("Hardtanh", "hardtanh")
Hardshrink = _simple("Hardshrink", "hardshrink")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Hardswish = _simple("Hardswish", "hardswish")
LeakyReLU = _simple("LeakyReLU", "leaky_relu")
Softmax = _simple("Softmax", "softmax")
LogSoftmax = _simple("LogSoftmax", "log_softmax")
Softplus = _simple("Softplus", "softplus")
Softshrink = _simple("Softshrink", "softshrink")
Softsign = _simple("Softsign", "softsign")
Swish = _simple("Swish", "swish")
SiLU = _simple("SiLU", "silu")
Silu = _simple("Silu", "silu")
Mish = _simple("Mish", "mish")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu")
GLU = _simple("GLU", "glu")


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None, **factory):
        super().__init__(**factory)
        self.groups = groups
        self.axis = axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class PReLU(Layer):
    """weight (num_parameters,), from ``init``: one slope for every
    element, or one per channel."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, **factory):
        super().__init__(**factory)
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, data_format=self._data_format)
