"""Activations (port of paddle_tpu/nn/functional/activation.py: gelu)."""
from __future__ import annotations

import torch

__all__ = ["gelu"]


def gelu(x, approximate=False):
    """approximate=True is the tanh form, jax.nn.gelu(approximate=True):
    0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
