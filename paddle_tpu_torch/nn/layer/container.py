"""LayerList (port of paddle_tpu/nn/layer/container.py).

torch.nn.ModuleList already names its members "0", "1", ..., which is
what keeps GPT's parameter names at ``h.{i}.*`` as in the reference."""
from __future__ import annotations

import torch

__all__ = ["LayerList"]


class LayerList(torch.nn.ModuleList):
    pass
