"""Sequential, LayerList, ParameterList and LayerDict (port of
paddle_tpu/nn/layer/container.py).

Each is a ``Layer`` (so ``set_state_dict``, ``full_name`` and the rest of
the reference's API apply) over torch's own container, which already
names its members "0", "1", ...: that keeps GPT's parameter names at
``h.{i}.*`` and ResNet's at ``layer1.0.downsample.0.weight`` as in the
reference."""
from __future__ import annotations

from collections import OrderedDict

import torch

from .layers import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer, torch.nn.Sequential):
    """``Sequential(l0, l1, ...)`` names its members "0", "1", ...;
    ``Sequential(OrderedDict(...))`` and ``Sequential([(name, layer),
    ...])`` name them as given, as the reference does."""

    def __init__(self, *layers):
        Layer.__init__(self)
        if layers and isinstance(layers[0], (list, tuple)) \
                and not isinstance(layers[0], torch.nn.Module):
            layers = (OrderedDict(layers[0]),)
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, layer in layers[0].items():
                self.add_module(name, layer)
        else:
            for i, layer in enumerate(layers):
                self.add_module(str(i), layer)


class LayerList(Layer, torch.nn.ModuleList):
    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.extend(sublayers)


class ParameterList(Layer, torch.nn.ParameterList):
    """Parameters named "0", "1", ..., with ``append``."""

    def __init__(self, parameters=None):
        Layer.__init__(self)
        if parameters is not None:
            for p in parameters:
                self.append(p)


class LayerDict(Layer, torch.nn.ModuleDict):
    """Sublayers by key, in insertion order: ``d[k] = layer``, ``update``,
    ``pop``, ``keys``, ``items``, ``values``, ``clear``."""

    def __init__(self, sublayers=None):
        Layer.__init__(self)
        if sublayers is not None:
            self.update(sublayers)
