"""paddle.incubate (port of paddle_tpu/incubate/__init__.py): the
LookAhead and ModelAverage optimizers, the fused transformer layers
(``nn``), the MoE layer with expert parallelism (``moe``) and the segment
reductions, and ``checkpoint`` (auto-checkpoint over fleet's file
systems). ``asp`` (the sparsity package) comes with ROADMAP A13."""
import torch

from . import checkpoint, moe, nn, optimizer  # noqa: F401
from .moe import MoELayer  # noqa: F401
from .nn import (softmax_mask_fuse,  # noqa: F401
                 softmax_mask_fuse_upper_triangle)
from .optimizer import LookAhead, ModelAverage  # noqa: F401

__all__ = ["LookAhead", "ModelAverage", "MoELayer", "nn", "checkpoint",
           "segment_sum",
           "segment_mean", "segment_max", "segment_min",
           "softmax_mask_fuse", "softmax_mask_fuse_upper_triangle"]


def _segment_reduce(data, segment_ids, mode):
    """Rows of ``data`` reduced by ``segment_ids`` into max(ids) + 1 rows;
    an empty segment is 0 (sum, mean), or the dtype's lowest (max) or
    highest (min) value, as jax.ops' segment reductions give. The row
    count depends on the data, so a captured step cannot hold it (the
    reference refuses under jit likewise)."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise TypeError(
            "segment_* ops need concrete segment_ids (the output row count "
            "max(ids)+1 is data-dependent, which a captured CUDA graph "
            "cannot hold); compute segments eagerly outside to_static")
    ids = segment_ids.long()
    n_seg = int(ids.max()) + 1 if ids.numel() else 0
    shape = (n_seg,) + tuple(data.shape[1:])
    if mode in ("sum", "mean"):
        tot = data.new_zeros(shape).index_add(0, ids, data)
        if mode == "sum":
            return tot
        cnt = torch.zeros(n_seg, dtype=data.dtype, device=data.device) \
            .index_add(0, ids, torch.ones_like(ids, dtype=data.dtype))
        return tot / cnt.clamp_min(1).reshape((-1,) + (1,) * (data.dim() - 1))
    if data.is_floating_point():
        start = -float("inf") if mode == "max" else float("inf")
    else:
        info = torch.iinfo(data.dtype)
        start = info.min if mode == "max" else info.max
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    return torch.full(shape, start, dtype=data.dtype, device=data.device) \
        .scatter_reduce(0, index, data, "amax" if mode == "max" else "amin",
                        include_self=True)


def segment_sum(data, segment_ids, name=None):
    """paddle.incubate.segment_sum (operators/segment_ops)."""
    return _segment_reduce(data, segment_ids, "sum")


def segment_mean(data, segment_ids, name=None):
    return _segment_reduce(data, segment_ids, "mean")


def segment_max(data, segment_ids, name=None):
    return _segment_reduce(data, segment_ids, "max")


def segment_min(data, segment_ids, name=None):
    return _segment_reduce(data, segment_ids, "min")
