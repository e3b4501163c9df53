"""paddle.amp.auto_cast (port of paddle_tpu/amp/auto_cast.py).

O1 casts the inputs of white-listed ops to the low dtype (bf16 by
default) and of black-listed ops to float32; O2 casts every op not
black-listed to the low dtype; ``decorate`` casts a model for O2. The
reference casts at its one op-dispatch seam by op name
(core/dispatch.py). The port has no dispatch layer: each entry point on
the ported path asks ``amp_cast(op_name, ...)`` for its inputs, under the
reference's op names (``linear``, ``layer_norm``, ``cross_entropy``,
``sdpa``, ``flash_attention``, ``fused_residual_ln``, and at O2
``embedding``, ``dropout`` and ``fused_ffn``). torch.autocast is not used:
its op lists differ from the reference's. The casts are differentiable
``Tensor.to`` calls, so an f32 parameter still receives an f32 gradient.

The state is a module global, read when an op runs: a step captured as a
CUDA graph keeps the casts of its capture. ``snapshot``/``restore`` let
recompute rerun a forward under the state it first ran with.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.dtypes import convert_dtype

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_guard", "decorate",
           "is_enabled", "amp_dtype", "amp_level", "should_cast_to_low",
           "should_cast_to_high", "amp_cast", "snapshot", "restore"]

# the reference's copy of fluid/contrib/mixed_precision/fp16_lists.py
WHITE_LIST = {"matmul", "linear", "conv1d", "conv2d", "conv3d", "bmm", "mm",
              "einsum", "sdpa", "flash_attention"}
BLACK_LIST = {"exp", "log", "softmax", "log_softmax", "cross_entropy",
              "mean", "sum", "layer_norm", "batch_norm", "norm",
              "softmax_with_cross_entropy", "cumsum", "logsumexp",
              # norm-family fused op, promoted like layer_norm; the
              # residual stream it returns keeps its own dtype
              "fused_residual_ln"}

_state = {"enabled": False, "dtype": torch.bfloat16, "level": "O1",
          "custom_white": set(), "custom_black": set()}


def is_enabled():
    return _state["enabled"]


def amp_dtype():
    return _state["dtype"]


def amp_level():
    return _state["level"]


def snapshot():
    """A copy of the current state, for ``restore``."""
    return dict(_state)


def restore(state):
    _state.update(state)


def should_cast_to_low(op_name: str) -> bool:
    if not _state["enabled"]:
        return False
    if _state["level"] == "O2":
        return op_name not in BLACK_LIST | _state["custom_black"]
    return op_name in (WHITE_LIST | _state["custom_white"]) \
        and op_name not in _state["custom_black"]


def should_cast_to_high(op_name: str) -> bool:
    if not _state["enabled"]:
        return False
    return op_name in BLACK_LIST | _state["custom_black"]


def amp_cast(op_name, *tensors):
    """The inputs an entry point called ``op_name`` computes with: under
    auto_cast its floating tensors cast to the low dtype
    (``should_cast_to_low``) or to float32 (``should_cast_to_high``);
    otherwise, and for every other value, as given. Returns a tuple."""
    if not _state["enabled"]:
        return tensors
    if should_cast_to_low(op_name):
        target = _state["dtype"]
    elif should_cast_to_high(op_name):
        target = torch.float32
    else:
        return tensors
    return tuple(t.to(target) if isinstance(t, torch.Tensor)
                 and (t.is_floating_point() or t.is_complex())
                 and t.dtype != target else t for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast; the low dtype defaults to bfloat16."""
    prev = snapshot()
    _state["enabled"] = bool(enable)
    _state["dtype"] = convert_dtype(dtype)
    _state["level"] = level
    _state["custom_white"] = set(custom_white_list or ())
    _state["custom_black"] = set(custom_black_list or ())
    try:
        yield
    finally:
        restore(prev)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """paddle.amp.decorate: O2 casts the models' parameters to the low
    dtype and (master_weight None or True) turns on the optimizers'
    multi_precision, so f32 masters back the cast parameters. The cast
    gives the parameters new storage: take optimizer steps and capture a
    step after decorating."""
    d = convert_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=d)
    if optimizers is None:
        return models if single else model_list
    if level == "O2" and (master_weight is None or master_weight):
        opt_single = not isinstance(optimizers, (list, tuple))
        for o in ([optimizers] if opt_single else optimizers):
            o._multi_precision = True
    return (models if single else model_list), optimizers
