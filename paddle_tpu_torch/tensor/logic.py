"""Comparison and logical ops (port of paddle_tpu/tensor/logic.py).

Outputs are bool tensors (no gradient); ``y`` may be a Python scalar.
"""
from __future__ import annotations

import torch

__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "bitwise_and", "bitwise_or", "bitwise_xor",
           "logical_not", "bitwise_not", "equal_all", "allclose", "isclose",
           "is_tensor", "is_empty", "where"]


def _as_tensor(y, like):
    return y if isinstance(y, torch.Tensor) else torch.as_tensor(
        y, device=like.device)


def _defcmp(name_, fn):
    def op(x, y, name=None):
        return fn(x, _as_tensor(y, x))
    op.__name__ = op.__qualname__ = name_
    return op


equal = _defcmp("equal", torch.eq)
not_equal = _defcmp("not_equal", torch.ne)
greater_than = _defcmp("greater_than", torch.gt)
greater_equal = _defcmp("greater_equal", torch.ge)
less_than = _defcmp("less_than", torch.lt)
less_equal = _defcmp("less_equal", torch.le)
logical_and = _defcmp("logical_and", torch.logical_and)
logical_or = _defcmp("logical_or", torch.logical_or)
logical_xor = _defcmp("logical_xor", torch.logical_xor)
bitwise_and = _defcmp("bitwise_and", torch.bitwise_and)
bitwise_or = _defcmp("bitwise_or", torch.bitwise_or)
bitwise_xor = _defcmp("bitwise_xor", torch.bitwise_xor)


def logical_not(x, name=None):
    return torch.logical_not(x)


def bitwise_not(x, name=None):
    return torch.bitwise_not(x)


def equal_all(x, y, name=None):
    """A 0-d bool: same shape and equal everywhere."""
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y)),
                        device=x.device)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.tensor(torch.allclose(x, y, rtol, atol, equal_nan),
                        device=x.device)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(x, y, rtol, atol, equal_nan)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_empty(x, name=None):
    return torch.tensor(x.numel() == 0, device=x.device)


def where(condition, x=None, y=None, name=None):
    """x where condition holds, else y; with neither, the indices of the
    true elements (``nonzero``)."""
    if x is None and y is None:
        from .search import nonzero
        return nonzero(condition)
    return torch.where(condition.bool(), x, y)
