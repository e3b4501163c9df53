"""paddle.jit.save/load (port of paddle_tpu/jit/save_load.py; reference
fluid/dygraph/jit.py:529,901; io.py:1092 TranslatedLayer).

Serialization format, the reference's: `<path>.pdparams` (the state dict
pickle of ``framework/io_utils.py``) + `<path>.pdmodel.json` (layer-class
metadata). The reference serializes a pruned ProgramDesc; here, as there,
the program is re-derived from the Python layer on load, so weights and
structural metadata are all that is stored, and an artifact written by
either package loads in the other. Serializing a whole program
(``torch.export``) is ROADMAP A12's.
"""
from __future__ import annotations

import json
import os

import torch

from ..framework.io_utils import load as _load_obj
from ..framework.io_utils import load_numpy_state_dict
from ..framework.io_utils import save as _save_obj

__all__ = ["save", "load", "TranslatedLayer"]


def save(layer, path, input_spec=None, **configs):
    if not isinstance(layer, torch.nn.Module):
        raise TypeError("jit.save expects a Layer")
    _save_obj(layer.state_dict(), path + ".pdparams")
    meta = {
        "class": type(layer).__name__,
        "module": type(layer).__module__,
        "input_spec": [
            {"shape": list(s.shape), "dtype": str(s.dtype)}
            for s in (input_spec or [])
            if hasattr(s, "shape")
        ],
    }
    with open(path + ".pdmodel.json", "w") as f:
        json.dump(meta, f)


class TranslatedLayer:
    """Loaded model wrapper: the state dict and the metadata; ``bind``
    copies the weights into a layer instance, which calls then run."""

    def __init__(self, state_dict, meta):
        self._state_dict = state_dict
        self._meta = meta
        self._layer = None

    def state_dict(self):
        return self._state_dict

    def bind(self, layer):
        load_numpy_state_dict(layer, self._state_dict)
        self._layer = layer
        return layer

    def __call__(self, *args, **kwargs):
        if self._layer is None:
            raise RuntimeError(
                "TranslatedLayer: call .bind(layer_instance) first (the "
                "artifact holds weights and metadata; the Python Layer is "
                "re-instantiated rather than deserialized)")
        return self._layer(*args, **kwargs)


def load(path, **configs):
    state = _load_obj(path + ".pdparams")
    meta = {}
    if os.path.exists(path + ".pdmodel.json"):
        with open(path + ".pdmodel.json") as f:
            meta = json.load(f)
    return TranslatedLayer(state, meta)
