"""Tensor creation (port of paddle_tpu/tensor/creation.py).

Creation functions place their tensors on the current device
(``set_device``; cuda:0 unless another was set) and keep the reference's
dtype rules: floats default to the default dtype (``set_default_dtype``,
float32 unless set), Python integers to int32, and a 64-bit dtype request
narrows to 32 bits (core/dtypes.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtypes import (convert_dtype, get_default_dtype,
                           narrow_host_array)
from ..framework.io_utils import tensor_from_numpy

__all__ = [
    "to_tensor", "zeros", "ones", "full", "empty", "zeros_like", "ones_like",
    "full_like", "empty_like", "arange", "linspace", "eye", "diag", "diagflat",
    "tril", "triu", "meshgrid", "assign", "clone", "complex", "tril_indices",
]


def _shape(shape):
    """A shape given as an int, a list or tuple (of ints or 0-d tensors)
    or a tensor, as a tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor: a tensor on ``place`` (the current device when
    None) from a tensor, an array, a list or a scalar. Host float64 data
    takes the default dtype and 64-bit integer data int32, range-checked,
    unless ``dtype`` says otherwise; ``stop_gradient=False`` makes it
    require grad."""
    device = resolve_device(place)
    dtype = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=device, dtype=dtype or
                             convert_dtype(data.dtype), copy=True)
    else:
        arr = np.asarray(data)
        if dtype is None and arr.dtype == np.float64:
            dtype = get_default_dtype()
        if dtype is None or not (dtype.is_floating_point or dtype.is_complex
                                 or dtype == torch.bool):
            arr = narrow_host_array(arr)
        t = tensor_from_numpy(arr)
        t = t.to(device=device, dtype=dtype or convert_dtype(t.dtype))
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=convert_dtype(dtype)
                       or get_default_dtype(), device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=convert_dtype(dtype)
                      or get_default_dtype(), device=resolve_device())


def _fill_dtype(fill_value):
    if isinstance(fill_value, bool):
        return torch.bool
    if isinstance(fill_value, (int, np.integer)):
        return torch.int32
    return get_default_dtype()


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _scalar(fill_value)
    return torch.full(_shape(shape), fill_value,
                      dtype=convert_dtype(dtype) or _fill_dtype(fill_value),
                      device=resolve_device())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype=dtype)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _scalar(fill_value), dtype=convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype=dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = (_scalar(v) for v in (start, end, step))
    if end is None:
        start, end = 0, start
    dtype = convert_dtype(dtype)
    if dtype is None:
        dtype = get_default_dtype() if any(isinstance(v, float)
                                     for v in (start, end, step)) \
            else torch.int32
    return torch.arange(start, end, step, dtype=dtype,
                        device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=convert_dtype(dtype) or get_default_dtype(),
                          device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=convert_dtype(dtype)
                     or get_default_dtype(), device=resolve_device())


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D x: the square matrix with x on diagonal ``offset`` and
    ``padding_value`` elsewhere; a 2-D x: its diagonal ``offset``."""
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        on = torch.ones(len(x), dtype=torch.bool, device=x.device)
        out = torch.where(torch.diag(on, offset), out, padding_value)
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def tril_indices(row, col=None, offset=0, dtype="int64", name=None):
    return torch.tril_indices(row, row if col is None else col, offset,
                              device=resolve_device()).to(
        convert_dtype(dtype))


def meshgrid(*args, **kwargs):
    arrs = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*arrs, indexing="ij"))


def assign(x, output=None):
    """x (a tensor, an array or a list) as a new tensor, or copied into
    ``output`` in place."""
    v = x if isinstance(x, torch.Tensor) else to_tensor(
        x, place=output.device if output is not None else None)
    if output is not None:
        with torch.no_grad():
            output.copy_(v)
        return output
    return v.clone() if v is x else v


def clone(x, name=None):
    return x.clone()


def complex(real, imag, name=None):  # noqa: A001
    return torch.complex(real, imag)
