"""Search and sort (port of paddle_tpu/tensor/search.py).

Indices are int32; ties resolve as in the reference: ``argsort`` and
``kthvalue`` are stable, ``mode`` gives the smallest most frequent value
and the last index where it occurs.
"""
from __future__ import annotations

import torch

from ..core.dtypes import convert_dtype
from .manipulation import masked_select

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "nonzero",
           "index_of_max", "searchsorted", "masked_select", "kthvalue",
           "mode", "bucketize"]


def _arg(fn, x, axis, keepdim, dtype):
    if axis is None:
        return fn(x.reshape(-1)).to(convert_dtype(dtype))
    return fn(x, axis, keepdim=keepdim).to(convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    return torch.argsort(x, dim=axis, descending=descending,
                         stable=True).to(torch.int32)


def sort(x, axis=-1, descending=False, name=None):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):  # noqa: A002
    """(values, int32 indices) of the k largest (smallest) along axis."""
    k = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return vals, idx.to(torch.int32)


def nonzero(x, as_tuple=False):
    """The coordinates of the non-zero elements: an (n, x.dim()) int32
    tensor, or a tuple of (n, 1) ones."""
    nz = torch.nonzero(x).to(torch.int32)
    if as_tuple:
        return tuple(nz[:, i:i + 1] for i in range(nz.shape[1]))
    return nz


def index_of_max(x):
    return argmax(x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values,
                              right=right).to(torch.int32)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The k-th smallest value along ``axis`` and its index in a stable
    sort."""
    vals, idx = torch.sort(x, dim=axis, stable=True)
    vals = vals.narrow(axis, k - 1, 1)
    idx = idx.narrow(axis, k - 1, 1).to(torch.int32)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the last index where it occurs. Counts by pairwise comparison: memory
    grows with the square of the axis length."""
    rows = torch.movedim(x, axis, -1)
    counts = (rows.unsqueeze(-1) == rows.unsqueeze(-2)).sum(-1)
    best = counts.amax(-1, keepdim=True)
    vals = torch.where(counts == best, rows,
                       rows.amax(-1, keepdim=True)).amin(-1)
    pos = torch.arange(rows.shape[-1], device=x.device)
    idx = torch.where(rows == vals.unsqueeze(-1), pos, -1).amax(-1)
    idx = idx.to(torch.int32)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx
