"""paddle.save / paddle.load on the same .pdparams pickle, and the carry-
across of numpy weights into a module.

Port of paddle_tpu/framework/io_utils.py: nested dicts/lists whose tensors
are stored as ``{"__tensor__": True, "data": ndarray, "stop_gradient",
"name"}``. A file written by either package loads in the other. bfloat16
payloads are ml_dtypes arrays, as JAX writes them. The port needs no
ml_dtypes for them: ``dump`` writes a bf16 tensor's 16-bit words under the
array's own pickle opcodes (the global ``ml_dtypes.bfloat16`` written by
hand, since pickling that global the usual way imports its module), and
``loads`` reads such an array back as a bf16 tensor.

A tensor-parallel model (distributed/fleet/meta_parallel.py) takes the
reference's full arrays by name, each rank its shard
(``load_numpy_state_dict``), and gives them back gathered
(``full_state_dict``); so do a ZeRO-3 model's shards
(distributed/spec_layout.py, ``p.fsdp_split``) and a PipelineStageStack's
stages (``p.stage_split``): ``param_split`` names a parameter's split.
These readers take each module's own shards (``local_state_dict``): the
state dict of a ZeRO-3 module gathers them.
"""
from __future__ import annotations

import io
import os
import pickle
import threading
from contextlib import contextmanager

import numpy as np
import torch

from ..ops._param_guard import recheck

__all__ = ["save", "load", "load_numpy_state_dict", "full_state_dict",
           "unshard", "tensor_from_numpy", "param_split", "local_state_dict"]

_PROTO = 4
_LOCAL = threading.local()


def param_split(p):
    """How a distributed parameter is split over ranks: its
    tensor-parallel, ZeRO-3, pipeline-stage or expert split (a
    ``TPSplit``), or None for a whole one."""
    for attr in ("tp_split", "fsdp_split", "stage_split", "ep_split"):
        split = getattr(p, attr, None)
        if split is not None:
            return split
    return None


def reading_local_state():
    """Whether this thread reads a module's own shards (inside
    ``local_state_dict``)."""
    return getattr(_LOCAL, "depth", 0) > 0


@contextmanager
def _local_state():
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1


def local_state_dict(module):
    """``module.state_dict()`` as this rank holds it: shards as shards."""
    with _local_state():
        return module.state_dict()


def tensor_from_numpy(arr):
    """CPU tensor with the array's dtype, shape (0-d included) and values
    (bfloat16 included)."""
    if isinstance(arr, torch.Tensor):
        return arr
    if isinstance(arr, _Bf16Words):
        return arr.tensor()
    shape = np.shape(arr)
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(arr.copy()).reshape(shape)


class _Bf16Words:
    """A bf16 tensor's 16-bit words on their way into a pickle, where
    ``dump`` writes them as the reference's ml_dtypes bfloat16 ndarray.
    As an array (``np.asarray``) it is the int16 words."""

    __slots__ = ("words",)

    def __init__(self, words):
        self.words = np.ascontiguousarray(words, dtype="<i2")

    @property
    def shape(self):
        return self.words.shape

    def __array__(self, dtype=None, copy=None):
        return self.words if dtype is None else self.words.astype(dtype)

    def tensor(self):
        return torch.from_numpy(self.words.copy()).view(torch.bfloat16)


def _numpy_from_tensor(t):
    """A tensor as what a checkpoint pickles: its ndarray, or for bf16 its
    words (``_Bf16Words``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _Bf16Words(t.view(torch.int16).numpy())
    return t.numpy()


class _Global:
    """A global written by name, without importing its module."""

    def __init__(self, module, name):
        self.module, self.name = module, name


# ml_dtypes' bfloat16 dtype as numpy pickles it:
# numpy.dtype(ml_dtypes.bfloat16, False, True) with this state
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)
_ND_RECONSTRUCT = np.ndarray.__reduce__(np.zeros(0))[0]


class _Bf16Dtype:
    """Stands for numpy's bfloat16 dtype, in a pickle either way."""

    def __setstate__(self, state):
        pass


class _Pickler(pickle._Pickler):
    """pickle's Python pickler with bf16 words written as an ml_dtypes
    bfloat16 ndarray: ``_reconstruct(ndarray, (0,), b'b')``, then its
    state (1, shape, dtype, False, raw bytes), the dtype being
    ``numpy.dtype(ml_dtypes.bfloat16, False, True)``."""

    dispatch = dict(pickle._Pickler.dispatch)

    def _save_global_name(self, obj):
        if self.proto >= 4:
            self.save(obj.module)
            self.save(obj.name)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{obj.module}\n{obj.name}\n"
                       .encode("utf-8"))

    def _save_bf16_dtype(self, obj):
        self.save_reduce(np.dtype, (_Global("ml_dtypes", "bfloat16"), False,
                                    True), state=_BF16_DTYPE_STATE)

    def _save_bf16(self, obj):
        w = obj.words
        self.save_reduce(_ND_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                         state=(1, w.shape, _Bf16Dtype(), False,
                                w.tobytes()), obj=obj)

    dispatch[_Global] = _save_global_name
    dispatch[_Bf16Dtype] = _save_bf16_dtype
    dispatch[_Bf16Words] = _save_bf16


def dump(obj, file, protocol=_PROTO):
    """``pickle.dump`` that writes ``_Bf16Words`` as ml_dtypes arrays."""
    _Pickler(file, protocol=protocol).dump(obj)


class _BF16:
    """Stands for the global ml_dtypes.bfloat16 while unpickling."""


class _ArraySlot:
    """An ndarray being unpickled: ``_reconstruct`` makes it, pickle's
    BUILD hands it its state; a bf16 one becomes a bf16 tensor."""

    __slots__ = ("args", "value")

    def __init__(self, *args):
        self.args, self.value = args, None

    def __setstate__(self, state):
        if isinstance(state[2], _Bf16Dtype):
            words = np.frombuffer(state[4], dtype="<i2").reshape(state[1])
            self.value = torch.from_numpy(words.copy()).view(torch.bfloat16)
        else:
            a = _ND_RECONSTRUCT(*self.args)
            a.__setstate__(state)
            self.value = a


def _dtype(*args):
    if args and args[0] is _BF16:
        return _Bf16Dtype()
    return np.dtype(*args)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _BF16
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if name == "_reconstruct" and module in ("numpy.core.multiarray",
                                                 "numpy._core.multiarray"):
            return _ArraySlot
        return super().find_class(module, name)


def _resolve(obj):
    if isinstance(obj, _ArraySlot):
        return obj.value
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve(v) for v in obj)
    return obj


def loads(data):
    """``pickle.loads`` reading an ml_dtypes bfloat16 array as a bf16
    tensor (every other array as its ndarray), without ml_dtypes."""
    return _resolve(_Unpickler(io.BytesIO(data)).load())


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
        dump(_to_serializable(obj), f, protocol=protocol)


def load(path):
    """Tensors come back as CPU torch tensors with the stored dtypes."""
    with open(path, "rb") as f:
        return _from_serializable(loads(f.read()))


def _shard(full, split):
    """This rank's shard of a distributed parameter's full array: along
    ``split.axis``, its piece of each of the axis's ``split.blocks``
    blocks (distributed/fleet/meta_parallel.py ``TPSplit``)."""
    axis, blocks, rank, n = split.axis, split.blocks, split.rank, \
        split.nranks
    block = full.shape[axis] // blocks
    piece = block // n
    parts = [full.narrow(axis, b * block + rank * piece, piece)
             for b in range(blocks)]
    return parts[0] if blocks == 1 else torch.cat(parts, dim=axis)


def load_numpy_state_dict(module, arrays, strict=True):
    """Copy ``arrays`` ({name: ndarray or tensor}) into ``module``'s
    parameters and buffers by name: no renaming, no transposes. Raises on
    a shape mismatch, and, when ``strict``, on a missing or an extra key
    (``strict=False`` skips a name only one side has, as the reference's
    ``set_state_dict`` does). Values are cast to each parameter's dtype
    and device, in place: the parameter objects, their addresses and
    their memory format stay, so captured steps and optimizer state keep
    pointing at them. A tensor-parallel parameter (``tp_split``) given
    the full array of the reference's layout takes this rank's shard of
    it; given an array of its own shape, the array itself. The
    degenerate-weight guard's cached verdict on each parameter is
    checked again (ops/_param_guard.py), as the reference's set_value
    drops it."""
    own = local_state_dict(module)
    splits = {name: param_split(p) for name, p in module.named_parameters()
              if param_split(p) is not None}
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if strict and (missing or extra):
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, dst in own.items():
        if name not in arrays:
            continue
        src = arrays[name]
        if not isinstance(src, torch.Tensor):
            src = tensor_from_numpy(np.asarray(src))
        if name in splits and tuple(src.shape) != tuple(dst.shape):
            src = _shard(src, splits[name])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} does not "
                             f"match the module's {tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
    # state_dict() holds detached aliases; the cache lives on the
    # parameters themselves
    for param in module.parameters():
        recheck(param)
    return module


def unshard(t, split):
    """The full tensor of a distributed parameter (or its gradient) from
    its shards on the members of ``split.group``, in the reference's
    layout: the inverse of ``_shard``. Every member calls it."""
    from ..distributed.collective import all_gather
    parts = []
    all_gather(parts, t.detach().contiguous(), group=split.group)
    blocks = [p.chunk(split.blocks, dim=split.axis) for p in parts]
    return torch.cat([b[i] for i in range(split.blocks) for b in blocks],
                     dim=split.axis)


def full_state_dict(module):
    """``module``'s state with every tensor-parallel parameter gathered
    from the ranks of its group into the reference's full layout (the
    inverse of ``load_numpy_state_dict``'s shard): {name: tensor} on the
    module's devices, the same on every member of each group. Every
    member calls it, in one order."""
    splits = {name: param_split(p) for name, p in module.named_parameters()
              if param_split(p) is not None}
    return {name: unshard(t, splits[name]) if name in splits
            else t.detach().clone()
            for name, t in local_state_dict(module).items()}
