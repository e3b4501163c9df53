"""Activations (port of paddle_tpu/nn/functional/activation.py): every
function of the reference, with its in-place variants (``relu_``,
``elu_``, ``softmax_``, ``tanh_``).

Each is written as the reference's formula, so the forward and its
autograd backward take the reference's operations: ``hardsigmoid`` is
clip(slope x + offset, 0, 1) with slope 0.1666667, ``gelu`` is exact
(erf) unless ``approximate``, ``softplus`` switches to x where beta x >
threshold. Where the reference's formula evaluates an exponential on the
branch ``where`` discards (elu, selu, celu, softplus), the port clamps
that branch's input first: the forward is the same and a large input
gives a finite gradient. Under ``amp.auto_cast`` each casts its input as
the reference's op of the same name is cast (amp/auto_cast.py): at O1
``softmax`` and ``log_softmax`` run in float32, at O2 every other one in
the low dtype. Random draws (``rrelu`` in training, ``gumbel_softmax``)
come from torch's default generator of the input's device.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast
from ...core.dtypes import convert_dtype
from ...core.random import uniform

__all__ = [
    "relu", "relu6", "relu_", "tanh_", "elu", "selu", "celu", "gelu",
    "sigmoid", "log_sigmoid", "tanh", "tanhshrink", "hardtanh", "hardshrink",
    "hardsigmoid", "hardswish", "leaky_relu", "prelu", "rrelu", "softmax",
    "log_softmax", "softplus", "softshrink", "softsign", "swish", "silu",
    "elu_", "softmax_", "mish", "maxout", "glu", "gumbel_softmax",
    "thresholded_relu",
]

_SELU_SCALE = 1.0507009873554804934193349852946
_SELU_ALPHA = 1.6732632423543772848170429916717


def gelu(x, approximate=False, name=None):
    """approximate=True is the tanh form, jax.nn.gelu(approximate=True):
    0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    x, = amp_cast("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    x, = amp_cast("relu", x)
    return torch.relu(x)


def relu_(x, name=None):
    return torch.relu_(x)


def relu6(x, name=None):
    x, = amp_cast("relu6", x)
    return torch.clamp(x, 0.0, 6.0)


def elu(x, alpha=1.0, name=None):
    x, = amp_cast("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x.clamp(max=0.0)))


def elu_(x, alpha=1.0, name=None):
    with torch.no_grad():
        return x.copy_(elu(x, alpha))


def selu(x, scale=_SELU_SCALE, alpha=_SELU_ALPHA, name=None):
    x, = amp_cast("selu", x)
    return scale * torch.where(x > 0, x,
                               alpha * torch.expm1(x.clamp(max=0.0)))


def celu(x, alpha=1.0, name=None):
    x, = amp_cast("celu", x)
    return torch.where(x > 0, x,
                       alpha * torch.expm1(x.clamp(max=0.0) / alpha))


def sigmoid(x, name=None):
    x, = amp_cast("sigmoid", x)
    return torch.sigmoid(x)


def log_sigmoid(x, name=None):
    x, = amp_cast("log_sigmoid", x)
    return torch.nn.functional.logsigmoid(x)


def tanh(x, name=None):
    x, = amp_cast("tanh", x)
    return torch.tanh(x)


def tanh_(x, name=None):
    return torch.tanh_(x)


def tanhshrink(x, name=None):
    x, = amp_cast("tanhshrink", x)
    return x - torch.tanh(x)


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    x, = amp_cast("hardtanh", x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    x, = amp_cast("hardshrink", x)
    return torch.where(x.abs() > threshold, x, 0.0)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    x, = amp_cast("hardsigmoid", x)
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    x, = amp_cast("hardswish", x)
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def leaky_relu(x, negative_slope=0.01, name=None):
    x, = amp_cast("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """x where x >= 0, else weight * x: one weight for every element, or
    one per channel (axis 1, or the last axis under a channel-last
    ``data_format``)."""
    x, weight = amp_cast("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x >= 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
    return torch.where(x >= 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """In training each negative element is scaled by its own draw from
    U(lower, upper); otherwise by (lower + upper) / 2."""
    if not training:
        return leaky_relu(x, (lower + upper) / 2.0)
    x, = amp_cast("rrelu", x)
    a = lower + (upper - lower) * uniform(x.shape, None, x.device)
    return torch.where(x >= 0, x, a.to(x.dtype) * x)


def _cast(x, dtype):
    d = convert_dtype(dtype)
    return x if d is None else x.to(d)


def softmax(x, axis=-1, dtype=None, name=None):
    """``dtype``, where given, is the dtype x is cast to first."""
    x, = amp_cast("softmax", x)
    return torch.softmax(_cast(x, dtype), dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    with torch.no_grad():
        return x.copy_(softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    x, = amp_cast("log_softmax", x)
    return torch.log_softmax(_cast(x, dtype), dim=axis)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """x where beta x > threshold, else log1p(exp(beta x)) / beta."""
    x, = amp_cast("softplus", x)
    bx = beta * x
    big = bx > threshold
    return torch.where(big, x,
                       torch.log1p(torch.exp(torch.where(big, 0.0, bx)))
                       / beta)


def softshrink(x, threshold=0.5, name=None):
    x, = amp_cast("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def softsign(x, name=None):
    x, = amp_cast("softsign", x)
    return x / (1.0 + x.abs())


def swish(x, name=None):
    x, = amp_cast("swish", x)
    return x * torch.sigmoid(x)


silu = swish


def mish(x, name=None):
    """x tanh(softplus(x)), softplus = log(1 + exp(x)) exactly."""
    x, = amp_cast("mish", x)
    return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))


def maxout(x, groups, axis=1, name=None):
    """The maximum over each run of ``groups`` consecutive channels of
    ``axis``: C channels become C / groups."""
    x, = amp_cast("maxout", x)
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = (*x.shape[:ax], c // groups, groups, *x.shape[ax + 1:])
    return x.reshape(shape).amax(dim=ax + 1)


def glu(x, axis=-1, name=None):
    """a * sigmoid(b), a and b the two halves of x along ``axis``."""
    x, = amp_cast("glu", x)
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def thresholded_relu(x, threshold=1.0, name=None):
    x, = amp_cast("thresholded_relu", x)
    return torch.where(x > threshold, x, 0.0)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with g ~ Gumbel(0, 1); ``hard``
    gives the one-hot of its maximum in the forward and the soft
    sample's gradient."""
    x, = amp_cast("gumbel_softmax", x)
    tiny = torch.finfo(torch.float32).tiny
    u = uniform(x.shape, None, x.device).clamp_min(tiny)
    g = (-torch.log(-torch.log(u))).to(x.dtype)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        onehot = (y == y.amax(dim=axis, keepdim=True)).to(y.dtype)
        y = (onehot - y).detach() + y
    return y

