"""einsum (port of paddle_tpu/tensor/einsum.py)."""
from __future__ import annotations

import torch

__all__ = ["einsum"]


def einsum(equation, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    return torch.einsum(equation, *operands)
