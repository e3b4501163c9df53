"""Initializers (port of paddle_tpu/nn/initializer.py): Constant, Normal,
TruncatedNormal, Uniform, XavierNormal/Uniform, KaimingNormal/Uniform,
Assign, Bilinear, ``calculate_gain`` and ``set_global_initializer``.

An initializer is called with the shape, dtype, target device and a
``torch.Generator`` (None: torch's default generator); it draws in f32 on
the generator's device (as the reference draws in f32 and casts) and
returns the tensor on the target device in the target dtype. The fans
are the reference's: a weight (out, in, *k) has fan_in = in * prod(k)
and fan_out = out * prod(k); a 2-D weight (in, out), Linear's layout,
has fan_in = in.
"""
from __future__ import annotations

import math

import torch

import numpy as np

__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "calculate_gain", "Bilinear", "set_global_initializer"]


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    """The reference's gains; an unknown name raises KeyError."""
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None
                                            else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


def _draw_device(generator):
    return "cpu" if generator is None else generator.device


class Initializer:
    def __call__(self, shape, dtype, device, generator):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device, generator=None):
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device, generator):
        z = torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32, device=_draw_device(generator))
        return (self.mean + self.std * z).to(device=device, dtype=dtype)


class TruncatedNormal(Initializer):
    """mean + std * z, z from N(0, 1) truncated to [-2, 2] (the
    reference's jax.random.truncated_normal(-2, 2)), by the inverse CDF
    of a uniform draw between the bounds' CDF values."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device, generator):
        lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0)))
                  for b in (-2.0, 2.0))
        u = torch.rand(tuple(shape), generator=generator,
                       dtype=torch.float32, device=_draw_device(generator))
        z = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
        z = z.clamp(-2.0, 2.0)
        return (self.mean + self.std * z).to(device=device, dtype=dtype)


class Uniform(Initializer):
    """U(low, high), the conv layers' default: U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) for weights and biases."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device, generator):
        u = torch.rand(tuple(shape), generator=generator,
                       dtype=torch.float32, device=_draw_device(generator))
        return (self.low + (self.high - self.low) * u).to(device=device,
                                                          dtype=dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device, generator):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, device, generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device, generator):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in or fi
        fo = self.fan_out or fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, device, generator)


class KaimingNormal(Initializer):
    """N(0, gain / sqrt(fan_in)), gain = calculate_gain(nonlinearity,
    negative_slope)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device, generator):
        fi = self.fan_in or _fan_in_out(shape)[0]
        std = calculate_gain(self.nonlinearity, self.negative_slope) \
            / math.sqrt(fi)
        return Normal(0.0, std)(shape, dtype, device, generator)


class KaimingUniform(Initializer):
    """U(-limit, limit), limit = gain * sqrt(3 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device, generator):
        fi = self.fan_in or _fan_in_out(shape)[0]
        limit = calculate_gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, device, generator)


class Assign(Initializer):
    """The given values (an array, a list or a tensor), reshaped to the
    parameter's shape."""

    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, device, generator=None):
        v = self.value
        if isinstance(v, torch.Tensor):
            t = v.detach().to(device=device, dtype=dtype, copy=True)
        else:
            t = torch.as_tensor(np.asarray(v), device=device, dtype=dtype)
        return t.reshape(tuple(shape)) if tuple(t.shape) != tuple(shape) \
            else t


class Bilinear(Initializer):
    """The bilinear-interpolation kernel of a transposed-conv upsampler
    (out, in, kh, kw): output channel i holds the filter at input channel
    i % in."""

    def __call__(self, shape, dtype=torch.float32, device="cpu",
                 generator=None):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        c_out, c_in, kh, kw = shape
        f = np.ceil(kw / 2.0)
        center = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:kh, :kw]
        filt = ((1 - abs(og[0] / f - center))
                * (1 - abs(og[1] / f - center)))
        w = np.zeros(shape, dtype=np.float64)
        for i in range(c_out):
            w[i, i % c_in] = filt
        return torch.as_tensor(w, dtype=dtype, device=device)


_GLOBAL_INITIALIZER = [None, None]  # (weight_init, bias_init)


def set_global_initializer(weight_init, bias_init=None):
    """The initializers ``Layer.create_parameter`` uses when a parameter's
    ParamAttr names none: they win over a layer's own default. Process-
    wide; ``set_global_initializer(None)`` restores the layers' defaults."""
    _GLOBAL_INITIALIZER[0] = weight_init
    _GLOBAL_INITIALIZER[1] = bias_init


def _global_initializer(is_bias):
    return _GLOBAL_INITIALIZER[1 if is_bias else 0]
