"""paddle.save / paddle.load on the same .pdparams pickle, and the carry-
across of numpy weights into a module.

Port of paddle_tpu/framework/io_utils.py: nested dicts/lists whose tensors
are stored as ``{"__tensor__": True, "data": ndarray, "stop_gradient",
"name"}``. A file written by either package loads in the other. bfloat16
payloads are ml_dtypes arrays, as JAX writes them; saving one needs
ml_dtypes, which is imported only then.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..ops._param_guard import clear_degenerate_cache

__all__ = ["save", "load", "load_numpy_state_dict", "tensor_from_numpy"]

_PROTO = 4


def tensor_from_numpy(arr):
    """CPU tensor with the array's dtype and values (bfloat16 included)."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _numpy_from_tensor(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "data": _numpy_from_tensor(obj),
                "stop_gradient": not obj.requires_grad, "name": None}
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    return obj


def _from_serializable(obj):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            return tensor_from_numpy(obj["data"])
        return {k: _from_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v) for v in obj)
    return obj


def save(obj, path, protocol=_PROTO):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_serializable(obj), f, protocol=protocol)


def load(path):
    """Tensors come back as CPU torch tensors with the stored dtypes."""
    with open(path, "rb") as f:
        return _from_serializable(pickle.load(f))


def load_numpy_state_dict(module, arrays):
    """Copy ``arrays`` ({name: ndarray or tensor}) into ``module``'s
    parameters and buffers by name: no renaming, no transposes. Raises on
    a missing key, an extra key or a shape mismatch. Values are cast to
    each parameter's dtype and device. Each parameter forgets the
    degenerate-weight guard's cached verdict (ops/_param_guard.py), as the
    reference's set_value does."""
    own = module.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, dst in own.items():
        src = arrays[name]
        if not isinstance(src, torch.Tensor):
            src = tensor_from_numpy(np.asarray(src))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                             f"match the module's {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
    # state_dict() holds detached aliases; the cache lives on the
    # parameters themselves
    for param in module.parameters():
        clear_degenerate_cache(param)
    return module
