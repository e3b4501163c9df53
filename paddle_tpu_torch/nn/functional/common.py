"""linear, embedding and dropout on torch tensors.

Port of paddle_tpu/nn/functional/common.py (the functions GPT uses).
``linear`` keeps paddle's (in, out) weight layout: y = x @ W + b.
"""
from __future__ import annotations

import torch

__all__ = ["linear", "embedding", "dropout"]


def linear(x, weight, bias=None):
    """weight shape (in, out), the reference layout."""
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight):
    """Gather rows of ``weight`` (int32 or int64 ids)."""
    return torch.nn.functional.embedding(x, weight)


def dropout(x, p=0.5, training=True, generator=None):
    """Identity in eval and at p == 0; in training, zero each element with
    probability p and scale the rest by 1 / (1 - p) (paddle's
    upscale_in_train), the keep mask drawn from ``generator``."""
    if not training or p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    dev = generator.device if generator is not None else x.device
    keep = (torch.rand(x.shape, generator=generator, device=dev)
            < 1.0 - p).to(x.device)
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
