"""Fused transformer feed-forward, forward.

Port of the forward of paddle_tpu/ops/fused_ffn.py:
y = act(x @ w1 + b1) @ w2 + b2 with paddle's (in, out) weights. The two
matmuls stay torch.matmul, as the reference leaves them to XLA outside any
kernel. The reference's backward, which recomputes the activation instead
of saving it, comes with the training slice.
"""
from __future__ import annotations

import torch

__all__ = ["fused_ffn"]

_ACTIVATIONS = {
    "gelu": lambda h: torch.nn.functional.gelu(h, approximate="none"),
    "gelu_tanh": lambda h: torch.nn.functional.gelu(h, approximate="tanh"),
    "relu": torch.relu,
}


def fused_ffn(x, w1, b1, w2, b2, activation="gelu"):
    """x: (..., d_model); w1: (d_model, d_ff); w2: (d_ff, d_model);
    activation: gelu | gelu_tanh | relu."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")
    h = torch.matmul(x, w1) + b1
    return torch.matmul(_ACTIVATIONS[activation](h), w2) + b2
