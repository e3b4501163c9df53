"""Initializers: Constant, Normal, Uniform and XavierNormal, the ones GPT,
BERT and the conv nets use.

Port of paddle_tpu/nn/initializer.py. An initializer is called with the
shape, dtype, target device and a ``torch.Generator`` (None: torch's
default generator); it draws in f32 on the generator's device (as the
reference draws in f32 and casts) and returns the tensor on the target
device in the target dtype.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierNormal"]


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
                        dtype=torch.float32,
                        device="cpu" if generator is None else generator.device)
        return (self.mean + self.std * z).to(device=device, dtype=dtype)


class Uniform(Initializer):
    """U(low, high), the conv layers' default: U(-1/sqrt(fan_in),
    +1/sqrt(fan_in)) for weights and biases."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device, generator):
        u = torch.rand(tuple(shape), generator=generator,
                       dtype=torch.float32,
                       device="cpu" if generator is None else generator.device)
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
