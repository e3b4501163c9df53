"""Elementwise math and reductions (port of paddle_tpu/tensor/math.py).

Paddle's names over torch ops, with the reference's conventions:
``axis`` (an int, a list or a tensor; None for every axis) and
``keepdim``; integer results in 32 bits (the 64-bit policy,
core/dtypes.py), where torch would give int64; ties and formulas as the
reference computes them where torch's own op differs (``lerp``,
``cummax``/``cummin``, ``outer``).
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dtypes import convert_dtype

__all__ = [
    "exp", "expm1", "log", "log2", "log10", "log1p", "sqrt", "rsqrt",
    "square", "reciprocal", "abs", "sign", "neg", "floor", "ceil", "round",
    "trunc", "frac", "sin", "cos", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "tanh", "asinh", "acosh", "atanh", "erf", "erfinv", "sigmoid",
    "digamma", "lgamma", "angle", "conj", "real", "imag", "add", "subtract",
    "multiply", "divide", "floor_divide", "mod", "remainder", "floor_mod",
    "pow", "maximum", "minimum", "fmax", "fmin", "atan2", "logaddexp",
    "hypot", "inner", "outer", "kron", "gcd", "lcm", "heaviside",
    "nextafter", "copysign", "scale", "multiplex", "clip", "lerp", "stanh",
    "rad2deg", "deg2rad", "isnan", "isinf", "isfinite", "nan_to_num", "sum",
    "mean", "prod", "nansum", "nanmean", "max", "min", "amax", "amin",
    "logsumexp", "all", "any", "count_nonzero", "cumsum", "cumprod",
    "cummax", "cummin", "diff", "trace", "addmm", "increment", "vander",
    "frexp", "ldexp", "add_n", "tensordot", "diagonal", "broadcast_shape",
    "shard_index"]


def _narrow(t):
    """int64 results as int32 (the 64-bit policy)."""
    return t.to(torch.int32) if t.dtype == torch.int64 else t


def _as_tensor(y, like):
    return y if isinstance(y, torch.Tensor) else torch.as_tensor(
        y, device=like.device)


def _defun(name, fn):
    def op(x, name=None):
        return fn(x)
    op.__name__ = op.__qualname__ = name
    return op


def _defbin(name, fn):
    def op(x, y, name=None):
        if not isinstance(x, torch.Tensor):
            x = _as_tensor(x, y)
        return fn(x, _as_tensor(y, x))
    op.__name__ = op.__qualname__ = name
    return op


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


# ---- unary -------------------------------------------------------------------
exp = _defun("exp", lambda x: torch.exp(_float(x)))
expm1 = _defun("expm1", lambda x: torch.expm1(_float(x)))
log = _defun("log", lambda x: torch.log(_float(x)))
log2 = _defun("log2", lambda x: torch.log2(_float(x)))
log10 = _defun("log10", lambda x: torch.log10(_float(x)))
log1p = _defun("log1p", lambda x: torch.log1p(_float(x)))
sqrt = _defun("sqrt", lambda x: torch.sqrt(_float(x)))
rsqrt = _defun("rsqrt", lambda x: torch.rsqrt(_float(x)))
square = _defun("square", torch.square)
reciprocal = _defun("reciprocal", lambda x: 1.0 / x)
abs = _defun("abs", torch.abs)  # noqa: A001
sign = _defun("sign", torch.sign)
neg = _defun("neg", torch.neg)
floor = _defun("floor", torch.floor)
ceil = _defun("ceil", torch.ceil)
round = _defun("round", torch.round)  # noqa: A001
trunc = _defun("trunc", torch.trunc)
frac = _defun("frac", lambda x: x - torch.trunc(x))
sin = _defun("sin", lambda x: torch.sin(_float(x)))
cos = _defun("cos", lambda x: torch.cos(_float(x)))
tan = _defun("tan", lambda x: torch.tan(_float(x)))
asin = _defun("asin", lambda x: torch.asin(_float(x)))
acos = _defun("acos", lambda x: torch.acos(_float(x)))
atan = _defun("atan", lambda x: torch.atan(_float(x)))
sinh = _defun("sinh", lambda x: torch.sinh(_float(x)))
cosh = _defun("cosh", lambda x: torch.cosh(_float(x)))
tanh = _defun("tanh", lambda x: torch.tanh(_float(x)))
asinh = _defun("asinh", lambda x: torch.asinh(_float(x)))
acosh = _defun("acosh", lambda x: torch.acosh(_float(x)))
atanh = _defun("atanh", lambda x: torch.atanh(_float(x)))
erf = _defun("erf", lambda x: torch.erf(_float(x)))
erfinv = _defun("erfinv", lambda x: torch.erfinv(_float(x)))
sigmoid = _defun("sigmoid", lambda x: torch.sigmoid(_float(x)))
digamma = _defun("digamma", lambda x: torch.digamma(_float(x)))
lgamma = _defun("lgamma", lambda x: torch.lgamma(_float(x)))
angle = _defun("angle", torch.angle)
conj = _defun("conj", lambda x: torch.conj(x).resolve_conj())
real = _defun("real", lambda x: torch.real(x).clone() if x.is_complex()
              else x.clone())
imag = _defun("imag", lambda x: torch.imag(x).clone() if x.is_complex()
              else torch.zeros_like(x))

# ---- binary ------------------------------------------------------------------
add = _defbin("add", torch.add)
subtract = _defbin("subtract", torch.subtract)
multiply = _defbin("multiply", torch.multiply)
divide = _defbin("divide", torch.true_divide)
floor_divide = _defbin("floor_divide", torch.floor_divide)
mod = _defbin("mod", torch.remainder)
remainder = mod
floor_mod = mod
pow = _defbin("pow", torch.pow)  # noqa: A001
maximum = _defbin("maximum", torch.maximum)
minimum = _defbin("minimum", torch.minimum)
fmax = _defbin("fmax", torch.fmax)
fmin = _defbin("fmin", torch.fmin)
atan2 = _defbin("atan2", torch.atan2)
logaddexp = _defbin("logaddexp", torch.logaddexp)
hypot = _defbin("hypot", torch.hypot)
inner = _defbin("inner", torch.inner)
outer = _defbin("outer", lambda x, y: torch.outer(x.reshape(-1),
                                                  y.reshape(-1)))
kron = _defbin("kron", torch.kron)
gcd = _defbin("gcd", torch.gcd)
lcm = _defbin("lcm", torch.lcm)
heaviside = _defbin("heaviside", torch.heaviside)
nextafter = _defbin("nextafter", torch.nextafter)
copysign = _defbin("copysign", torch.copysign)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """x * scale + bias (or (x + bias) * scale), then the activation
    ``act`` of nn.functional where named."""
    out = x * scale + bias if bias_after_scale else (x + bias) * scale
    if act:
        from ..nn import functional as F
        out = getattr(F, act)(out)
    return out


def multiplex(inputs, index, name=None):
    """Row i of the output is row i of ``inputs[index[i]]``."""
    stacked = torch.stack(list(inputs), 0)
    idx = index.reshape(1, -1, *([1] * (stacked.dim() - 2))).long()
    idx = idx.expand(1, *stacked.shape[1:])
    return torch.gather(stacked, 0, idx)[0]


def clip(x, min=None, max=None, name=None):  # noqa: A002
    return torch.clamp(x, min, max)


def lerp(x, y, weight, name=None):
    """x + weight * (y - x), rounded as the reference computes it."""
    return x + weight * (y - x)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


def rad2deg(x, name=None):
    return torch.rad2deg(_float(x))


def deg2rad(x, name=None):
    return torch.deg2rad(_float(x))


def isnan(x, name=None):
    return torch.isnan(x)


def isinf(x, name=None):
    return torch.isinf(x)


def isfinite(x, name=None):
    return torch.isfinite(x)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


# ---- reductions --------------------------------------------------------------
def _axes(axis):
    """None (every axis), an int, or a tuple of ints."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        return tuple(int(a) for a in axis.reshape(-1).tolist())
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """The axes to reduce as a tuple (every axis when None)."""
    ax = _axes(axis)
    if ax is None:
        return tuple(range(x.dim()))
    return ax if isinstance(ax, tuple) else (ax,)


def _defreduce(name, fn, to_float=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        if to_float:
            x = _float(x)
        out = fn(x, _dims(x, axis), keepdim)
        if dtype is not None:
            return out.to(convert_dtype(dtype))
        return out if x.dtype == torch.int64 else _narrow(out)
    op.__name__ = op.__qualname__ = name
    return op


def _prod(x, dims, keepdim):
    out = x
    for d in sorted((d % builtins.max(x.dim(), 1) for d in dims),
                    reverse=True):
        out = torch.prod(out, d, keepdim=keepdim)
    return out


sum = _defreduce("sum", lambda x, d, k: torch.sum(x, d, keepdim=k))  # noqa: A001
mean = _defreduce("mean", lambda x, d, k: torch.mean(x, d, keepdim=k),
                  to_float=True)
prod = _defreduce("prod", _prod)
nansum = _defreduce("nansum", lambda x, d, k: torch.nansum(x, d, keepdim=k))
nanmean = _defreduce("nanmean",
                     lambda x, d, k: torch.nanmean(x, d, keepdim=k),
                     to_float=True)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.amax(x, _dims(x, axis), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.amin(x, _dims(x, axis), keepdim=keepdim)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    return torch.logsumexp(_float(x), _dims(x, axis), keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.all(x.bool(), _dims(x, axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    return torch.any(x.bool(), _dims(x, axis), keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    out = torch.count_nonzero(x, _dims(x, axis)).to(torch.int32)
    if keepdim:
        for d in sorted(a % x.dim() for a in _dims(x, axis)):
            out = out.unsqueeze(d)
    return out


def cumsum(x, axis=None, dtype=None, name=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    out = torch.cumsum(x, axis)
    return out.to(convert_dtype(dtype)) if dtype else (
        out if x.dtype == torch.int64 else _narrow(out))


def cumprod(x, dim=None, dtype=None, name=None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    out = torch.cumprod(x, dim)
    return out.to(convert_dtype(dtype)) if dtype else (
        out if x.dtype == torch.int64 else _narrow(out))


def _cummaxmin(x, axis, dtype, is_max):
    """Running max (min) and the index where it was first reached, as the
    reference's scan keeps the earlier index on ties."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    vals = (torch.cummax if is_max else torch.cummin)(x, axis).values
    n = x.shape[axis]
    prev = torch.cat([vals.narrow(axis, 0, 1), vals.narrow(axis, 0, n - 1)],
                     axis)
    new = (vals > prev) if is_max else (vals < prev)
    shape = [1] * x.dim()
    shape[axis] = n
    pos = torch.arange(n, device=x.device).reshape(shape).expand(x.shape)
    idx = torch.cummax(torch.where(new, pos, 0), axis).values
    return vals, idx.to(convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    return _cummaxmin(x, axis, dtype, True)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cummaxmin(x, axis, dtype, False)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n, axis, prepend, append)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return _narrow(torch.diagonal(x, offset, axis1, axis2).sum(-1))


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):  # noqa: A002
    return beta * input + alpha * (x @ y)


def increment(x, value=1.0, name=None):
    """x += value, in place; returns x."""
    with torch.no_grad():
        return x.add_(value)


def vander(x, n=None, increasing=False, name=None):
    return torch.vander(x, n, increasing)


def frexp(x, name=None):
    """(mantissa in [0.5, 1), int32 exponent)."""
    m, e = torch.frexp(x)
    return m, e.to(torch.int32)


def ldexp(x, y, name=None):
    """x * 2 ** y."""
    return torch.ldexp(_float(x), y.to(torch.int32))


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors, left to right."""
    if isinstance(inputs, torch.Tensor):
        return inputs
    out = inputs[0]
    for t in inputs[1:]:
        out = out + t
    return out


def tensordot(x, y, axes=2, name=None):
    """numpy's tensordot, except that a flat list of ints names the same
    axes of both tensors (paddle's convention)."""
    if isinstance(axes, (list, tuple)):
        if builtins.all(isinstance(a, int) for a in axes):
            dims = (list(axes), list(axes))
        elif len(axes) >= 2:
            dims = ([*axes[0]] if isinstance(axes[0], (list, tuple))
                    else [axes[0]],
                    [*axes[1]] if isinstance(axes[1], (list, tuple))
                    else [axes[1]])
        else:
            sub = [*axes[0]] if isinstance(axes[0], (list, tuple)) \
                else [axes[0]]
            dims = (sub, sub)
    else:
        dims = int(axes)
    return torch.tensordot(x, y, dims=dims)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,  # noqa: A002
                name=None):
    """Global ids to shard-local ids: the ids shard ``shard_id`` owns map
    to their offset in it, the others to ``ignore_value``."""
    if shard_id < 0 or shard_id >= nshards:
        raise ValueError(
            f"shard_id {shard_id} out of range for nshards {nshards}")
    size = (index_num + nshards - 1) // nshards
    lo = shard_id * size
    inside = (input >= lo) & (input < lo + size)
    return torch.where(inside, input - lo, ignore_value).to(input.dtype)
