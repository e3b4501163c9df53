"""linear, embedding and dropout on torch tensors.

Port of paddle_tpu/nn/functional/common.py (the functions GPT uses).
``linear`` keeps paddle's (in, out) weight layout: y = x @ W + b. Under
``amp.auto_cast`` each casts its inputs as the reference's op of the same
name is cast (amp/auto_cast.py).
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast
from ...core.random import uniform

__all__ = ["linear", "embedding", "dropout"]


def linear(x, weight, bias=None):
    """weight shape (in, out), the reference layout."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight):
    """Gather rows of ``weight`` (int32 or int64 ids)."""
    weight, = amp_cast("embedding", weight)
    return torch.nn.functional.embedding(x, weight)


def dropout(x, p=0.5, training=True, generator=None):
    """Identity in eval and at p == 0; in training, zero each element with
    probability p and scale the rest by 1 / (1 - p) (paddle's
    upscale_in_train), the keep mask drawn from ``generator``."""
    if not training or p == 0.0:
        return x
    x, = amp_cast("dropout", x)
    if p == 1.0:
        return torch.zeros_like(x)
    keep = uniform(x.shape, generator, x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
