"""Statistics (port of paddle_tpu/tensor/stat.py).

``median`` and ``quantile`` interpolate linearly (numpy's default: the
median of an even count is the mean of the two middle values, not
torch.median's lower one); ``axis`` may name several axes.
"""
from __future__ import annotations

import torch

from .math import _dims, _float
from .math import mean as _mean

__all__ = ["mean", "var", "std", "median", "nanmedian", "quantile",
           "nanquantile", "numel"]


def mean(x, axis=None, keepdim=False, name=None):
    return _mean(x, axis=axis, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(_float(x), _dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(_float(x), _dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim):
    """``fn`` (torch.quantile or nanquantile) over the axes of ``axis``,
    moved last and flattened into one."""
    x = _float(x)
    dims = sorted(d % max(x.dim(), 1) for d in _dims(x, axis))
    rest = [d for d in range(x.dim()) if d not in dims]
    flat = x.permute(*rest, *dims).reshape(*[x.shape[d] for d in rest], -1)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    out = fn(flat, qt, dim=-1)
    if keepdim:
        for d in dims:
            out = out.unsqueeze(d + (qt.dim() if qt.dim() else 0))
    return out


def median(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, 0.5, axis, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)
