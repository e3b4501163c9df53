"""Attribute ops (port of paddle_tpu/tensor/attribute.py)."""
from __future__ import annotations

import torch

__all__ = ["shape", "rank", "is_floating_point", "is_integer_tensor",
           "is_complex_tensor"]


def shape(input, name=None):  # noqa: A002
    """The shape as an int32 tensor on the input's device."""
    return torch.tensor(list(input.shape), dtype=torch.int32,
                        device=input.device)


def rank(input, name=None):  # noqa: A002
    return torch.tensor(input.dim(), dtype=torch.int32, device=input.device)


def is_floating_point(x):
    return x.is_floating_point()


def is_integer_tensor(x):
    return not (x.is_floating_point() or x.is_complex()
                or x.dtype == torch.bool)


def is_complex_tensor(x):
    return x.is_complex()
