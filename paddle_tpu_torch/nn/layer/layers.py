"""Layer: paddle's base layer as a thin torch.nn.Module.

Port of paddle_tpu/nn/layer/layers.py, only what GPT and BERT need: a
module that knows the device (default cuda:0), dtype (default float32)
and generator its parameters are created with, ``create_parameter`` and
``sublayers``. Everything else (state_dict, eval, bfloat16, named
parameters) is torch.nn.Module's own; parameter names follow the
attribute names, as in the reference, so state dicts cross unchanged.
"""
from __future__ import annotations

import torch

from ...core.device import resolve_device
from ...core.dtypes import convert_dtype
from .. import initializer as I

__all__ = ["Layer"]


class Layer(torch.nn.Module):
    def __init__(self, device=None, dtype=None, generator=None):
        super().__init__()
        self._device = resolve_device(device)
        self._dtype = convert_dtype(dtype) or torch.float32
        self._generator = generator

    def factory_kwargs(self):
        """The (device, dtype, generator) to build sublayers with."""
        return {"device": self._device, "dtype": self._dtype,
                "generator": self._generator}

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """``attr`` is None, False (no parameter: returns None) or an
        Initializer, which wins over ``default_initializer``. Without
        either, biases start at 0 and weights XavierNormal."""
        if attr is False:
            return None
        init = attr if isinstance(attr, I.Initializer) else \
            default_initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        value = init(shape, convert_dtype(dtype) or self._dtype,
                     self._device, self._generator)
        return torch.nn.Parameter(value)

    def sublayers(self, include_self=False):
        """Every sublayer, each once, depth first with a layer before its
        children (the reference's order, which is Module.modules')."""
        layers = list(self.modules())
        return layers if include_self else layers[1:]
