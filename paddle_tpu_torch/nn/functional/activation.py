"""Activations (port of paddle_tpu/nn/functional/activation.py: gelu,
relu, tanh). Under ``amp.auto_cast`` each casts its input as the
reference's op of the same name is cast (amp/auto_cast.py): at O1 none
is listed, at O2 each runs in the low dtype."""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["gelu", "relu", "tanh"]


def gelu(x, approximate=False, name=None):
    """approximate=True is the tanh form, jax.nn.gelu(approximate=True):
    0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    x, = amp_cast("gelu", x)
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def relu(x, name=None):
    x, = amp_cast("relu", x)
    return torch.relu(x)


def tanh(x, name=None):
    x, = amp_cast("tanh", x)
    return torch.tanh(x)
