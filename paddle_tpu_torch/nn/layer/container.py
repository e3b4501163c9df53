"""LayerList and Sequential (port of paddle_tpu/nn/layer/container.py).

torch.nn.ModuleList and torch.nn.Sequential already name their members
"0", "1", ..., which is what keeps GPT's parameter names at ``h.{i}.*``
and ResNet's at ``layer1.0.downsample.0.weight`` as in the reference."""
from __future__ import annotations

from collections import OrderedDict

import torch

__all__ = ["LayerList", "Sequential"]


class LayerList(torch.nn.ModuleList):
    pass


class Sequential(torch.nn.Sequential):
    """``Sequential(l0, l1, ...)`` names its members "0", "1", ...;
    ``Sequential(OrderedDict(...))`` and ``Sequential([(name, layer),
    ...])`` name them as given, as the reference does."""

    def __init__(self, *layers):
        if layers and isinstance(layers[0], (list, tuple)) \
                and not isinstance(layers[0], torch.nn.Module):
            layers = (OrderedDict(layers[0]),)
        super().__init__(*layers)
