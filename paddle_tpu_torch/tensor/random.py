"""Random sampling (port of paddle_tpu/tensor/random.py).

Every draw comes from an explicit generator, the port's tensor-API
generator of the target device (core/random.py ``api_generator``, seeded
by ``paddle.seed``), never from torch's global one. A draw inside a
``to_static`` step registers its generator with the capture, so each
replay draws anew.
"""
from __future__ import annotations

import torch

from ..core.device import resolve_device
from ..core.dtypes import convert_dtype, get_default_dtype
from ..core.random import api_generator, note_draw
from .creation import _shape

__all__ = ["rand", "randn", "standard_normal", "normal", "uniform",
           "randint", "randint_like", "randperm", "multinomial", "bernoulli",
           "poisson", "exponential_"]


def _gen(device):
    gen = api_generator(device)
    note_draw(gen)
    return gen


def rand(shape, dtype=None, name=None):
    device = resolve_device()
    return torch.rand(_shape(shape), dtype=convert_dtype(dtype)
                      or get_default_dtype(), device=device,
                      generator=_gen(device))


def randn(shape, dtype=None, name=None):
    device = resolve_device()
    return torch.randn(_shape(shape), dtype=convert_dtype(dtype)
                       or get_default_dtype(), device=device,
                       generator=_gen(device))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype=dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """mean + std * N(0, 1), of ``shape`` or of the tensors' broadcast
    shape."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        shp = torch.broadcast_shapes(torch.as_tensor(mean).shape,
                                     torch.as_tensor(std).shape)
        z = torch.randn(shp, dtype=get_default_dtype(), device=like.device,
                        generator=_gen(like.device))
        return mean + std * z
    device = resolve_device()
    z = torch.randn(_shape(shape) if shape is not None else (),
                    dtype=get_default_dtype(), device=device,
                    generator=_gen(device))
    return mean + std * z


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            name=None):
    device = resolve_device()
    lo = float(min.item() if isinstance(min, torch.Tensor) else min)
    hi = float(max.item() if isinstance(max, torch.Tensor) else max)
    u = torch.rand(_shape(shape), dtype=convert_dtype(dtype)
                   or get_default_dtype(), device=device,
                   generator=_gen(device))
    return lo + (hi - lo) * u


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    device = resolve_device()
    return torch.randint(low, high, _shape(shape), device=device,
                         dtype=convert_dtype(dtype) or torch.int32,
                         generator=_gen(device))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    return torch.randint(low, high, tuple(x.shape), device=x.device,
                         dtype=convert_dtype(dtype) or x.dtype,
                         generator=_gen(x.device))


def randperm(n, dtype="int64", name=None):
    device = resolve_device()
    return torch.randperm(n, device=device,
                          generator=_gen(device)).to(
        convert_dtype(dtype))


def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x, num_samples, replacement,
                             generator=_gen(x.device)).to(
        torch.int32)


def bernoulli(x, name=None):
    return torch.bernoulli(x, generator=_gen(x.device))


def poisson(x, name=None):
    return torch.poisson(x, generator=_gen(x.device))


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device))
