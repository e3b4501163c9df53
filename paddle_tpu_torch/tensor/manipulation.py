"""Shape and layout manipulation (port of
paddle_tpu/tensor/manipulation.py).

Shapes are lists, tuples or tensors; ``transpose`` takes paddle's full
permutation; ``split`` takes a count or sections (one of them -1);
``gather``/``scatter`` follow the reference (``scatter(overwrite=False)``
zeroes the target rows, then adds every update); index outputs are
int32. The ``*_`` functions update their input in place.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..nn.functional.common import pad
from .creation import _shape

__all__ = [
    "cast", "reshape", "reshape_", "flatten", "squeeze", "unsqueeze",
    "transpose", "moveaxis", "swapaxes", "concat", "stack", "unstack",
    "split", "chunk", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "flip", "rot90", "roll", "gather", "gather_nd",
    "take_along_axis", "put_along_axis", "scatter", "scatter_nd_add",
    "scatter_nd", "index_select", "index_sample", "slice", "strided_slice",
    "unbind", "unique", "unique_consecutive", "masked_select", "masked_fill",
    "pad", "crop", "repeat_interleave", "as_complex", "as_real", "reverse",
    "squeeze_", "unsqueeze_", "scatter_"]


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _axes_of(axis):
    return (axis,) if isinstance(axis, (int, np.integer)) else _shape(axis)


def cast(x, dtype):
    """x in ``dtype`` (64-bit names narrow to 32 bits)."""
    return x.to(convert_dtype(dtype))


def reshape(x, shape, name=None):
    return torch.reshape(x, _shape(shape))


def reshape_(x, shape, name=None):
    """Reshape x itself (its data keeps its storage where it can)."""
    x.data = torch.reshape(x.data, _shape(shape))
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def squeeze(x, axis=None, name=None):
    """Drop the size-1 axes (of ``axis`` only, where given; other named
    axes stay)."""
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, tuple(a for a in _axes_of(axis)
                                  if x.shape[a] == 1))


def _unsqueeze_positions(x, axis):
    axes = _axes_of(axis)
    nd = x.dim() + len(axes)
    return sorted(a % nd for a in axes)


def unsqueeze(x, axis, name=None):
    """Insert size-1 axes at ``axis`` (positions in the result)."""
    for a in _unsqueeze_positions(x, axis):
        x = x.unsqueeze(a)
    return x


def transpose(x, perm, name=None):
    return x.permute(*_shape(perm))


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(x, axis1, axis2)


def concat(x, axis=0, name=None):
    return torch.cat(list(x), _int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(list(x), axis)


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(x, axis))


def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces along ``axis``: ``num_or_sections`` equal ones
    (which must divide the axis), or pieces of the given sizes (one may be
    -1: the rest)."""
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, (int, np.integer)):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dim {dim} along axis {axis} is not divisible by "
                f"num_or_sections={num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = [_int(s) for s in num_or_sections]
        total = builtins.sum(s for s in sections if s >= 0)
        sections = [s if s >= 0 else dim - total for s in sections]
    return list(torch.split(x, sections, axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def tile(x, repeat_times, name=None):
    return torch.tile(x, _shape(repeat_times))


def expand(x, shape, name=None):
    """x broadcast to ``shape``; -1 keeps the input's size."""
    return x.expand(*_shape(shape))


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def flip(x, axis, name=None):
    return torch.flip(x, _axes_of(axis))


def reverse(x, axis, name=None):
    """fluid.layers.reverse: ``flip``."""
    return flip(x, axis)


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


def roll(x, shifts, axis=None, name=None):
    return torch.roll(x, shifts, axis)


def gather(x, index, axis=0, name=None):
    """numpy's take along ``axis``: the output has ``index``'s shape in
    place of that axis."""
    axis = _int(axis)
    out = torch.index_select(x, axis, index.reshape(-1).long())
    return out.reshape(*x.shape[:axis], *index.shape, *x.shape[axis + 1:])


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis=axis)


def gather_nd(x, index, name=None):
    """x at the coordinates in ``index``'s last axis."""
    index = index.long()
    return x[tuple(index[..., i] for i in range(index.shape[-1]))]


def take_along_axis(arr, indices, axis, name=None):
    return torch.take_along_dim(arr, indices.long(), axis)


def index_sample(x, index, name=None):
    return take_along_axis(x, index, 1)


def put_along_axis(arr, indices, values, axis, reduce="assign",  # noqa: A002
                   name=None):
    """``arr`` with ``values`` (broadcast to ``indices``' shape) put at
    ``indices`` along ``axis``: assigned, added or multiplied in."""
    indices = indices.long()
    values = torch.as_tensor(values, device=arr.device).to(arr.dtype) \
        .expand(indices.shape)
    if reduce == "assign":
        return torch.scatter(arr, axis, indices, values)
    if reduce == "add":
        return torch.scatter_add(arr, axis, indices, values)
    if reduce in ("multiply", "mul"):
        return torch.scatter_reduce(arr, axis, indices, values, "prod")
    raise ValueError(reduce)


def scatter(x, index, updates, overwrite=True, name=None):
    """x with rows ``index`` replaced by ``updates``; with overwrite=False
    those rows are zeroed first and every update added (duplicates
    accumulate)."""
    index = index.reshape(-1).long()
    out = x.clone()
    updates = updates.to(x.dtype)
    if overwrite:
        out[index] = updates
    else:
        out[index] = 0
        out.index_put_((index,), updates, accumulate=True)
    return out


def scatter_(x, index, updates, overwrite=True, name=None):
    with torch.no_grad():
        return x.copy_(scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates, name=None):
    index = index.long()
    coords = tuple(index[..., d] for d in range(index.shape[-1]))
    return x.index_put(coords, updates.to(x.dtype), accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    return scatter_nd_add(torch.zeros(_shape(shape), dtype=updates.dtype,
                                      device=updates.device), index, updates)


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    """x[starts:ends] on ``axes``, negative bounds counted from the end
    and clipped to the axis."""
    idx = [builtins.slice(None)] * x.dim()
    for a, s, e in zip(_shape(axes), _shape(starts), _shape(ends)):
        dim = x.shape[a]
        s = builtins.min(builtins.max(s + dim if s < 0 else s, 0), dim)
        e = builtins.min(builtins.max(e + dim if e < 0 else e, 0), dim)
        idx[a] = builtins.slice(s, e)
    return x[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python's slicing on ``axes``, negative strides included."""
    for a, s, e, st in zip(*map(_shape, (axes, starts, ends, strides))):
        picked = list(range(x.shape[a]))[builtins.slice(s, e, st)]
        x = torch.index_select(x, a, torch.tensor(picked, dtype=torch.long,
                                                  device=x.device))
    return x


def unbind(input, axis=0):  # noqa: A002
    return unstack(input, axis=axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values (of x flattened, or slices along
    ``axis``), and where asked the index of each one's first occurrence,
    the inverse map and the counts, as int32."""
    src = x.reshape(-1) if axis is None else x
    dim = 0 if axis is None else axis
    vals, inverse, counts = torch.unique(src, sorted=True,
                                         return_inverse=True,
                                         return_counts=True, dim=dim)
    outs = [vals]
    if return_index:
        n = src.shape[dim]
        first = torch.full((vals.shape[dim],), n, dtype=torch.long,
                           device=x.device)
        outs.append(first.scatter_reduce(
            0, inverse, torch.arange(n, device=x.device), "amin")
            .to(torch.int32))
    if return_inverse:
        outs.append(inverse.to(torch.int32))
    if return_counts:
        outs.append(counts.to(torch.int32))
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    vals, inverse, counts = torch.unique_consecutive(
        x.reshape(-1) if axis is None else x, return_inverse=True,
        return_counts=True, dim=None if axis is None else axis)
    outs = [vals]
    if return_inverse:
        outs.append(inverse.to(torch.int32))
    if return_counts:
        outs.append(counts.to(torch.int32))
    return outs[0] if len(outs) == 1 else tuple(outs)


def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask.bool())


def masked_fill(x, mask, value, name=None):
    value = value.to(x.dtype) if isinstance(value, torch.Tensor) else value
    return torch.where(mask.bool(), value, x)


def crop(x, shape=None, offsets=None, name=None):
    shp = _shape(shape)
    offs = _shape(offsets) if offsets is not None else (0,) * len(shp)
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, repeats, axis)


def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    return torch.stack([torch.real(x), torch.imag(x)], -1)


def squeeze_(x, axis=None, name=None):
    """squeeze, in place."""
    dims = range(x.dim()) if axis is None else _axes_of(axis)
    for a in sorted((a % x.dim() for a in dims), reverse=True):
        if x.shape[a] == 1:
            x.squeeze_(a)
    return x


def unsqueeze_(x, axis, name=None):
    """unsqueeze, in place."""
    for a in _unsqueeze_positions(x, axis):
        x.unsqueeze_(a)
    return x
