"""ReLU (port of paddle_tpu/nn/layer/activation.py)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["ReLU"]


class ReLU(Layer):
    def __init__(self, name=None, **factory):
        super().__init__(**factory)

    def forward(self, x):
        return F.relu(x)
