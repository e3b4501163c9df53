"""Distributed (global) metrics (port of
paddle_tpu/distributed/fleet/metrics.py).

Paddle's fleet/metrics/metric.py: global sum/max/min/auc/mae/rmse/mse/acc
from each worker's local statistics, all-reduced over the job's process
group (the reference's gloo path). The statistics travel in float64 on
the process group's device; at world size 1 they stay local.
"""
from __future__ import annotations

import numpy as np

__all__ = ["sum", "max", "min", "auc", "mae", "rmse", "mse", "acc"]


def _to_np(x):
    if hasattr(x, "detach"):
        return x.detach().cpu().double().numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy(), dtype=np.float64)
    return np.asarray(x, dtype=np.float64)


def _allreduce(arr, op="sum"):
    """All-reduce over the worker processes; local at world size 1."""
    from ..collective import ReduceOp, _dist, all_reduce
    from ..env import device, get_world_size
    if get_world_size() <= 1 or _dist() is None:
        return arr
    import torch
    # a copy: the reduction is in place, and the caller keeps its array
    t = torch.tensor(arr, dtype=torch.float64, device=device() or "cpu")
    all_reduce(t, op={"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
                      "min": ReduceOp.MIN}[op])
    return t.cpu().numpy()


def sum(input, scope=None, util=None):  # noqa: A001
    return _allreduce(_to_np(input), "sum")


def max(input, scope=None, util=None):  # noqa: A001
    return _allreduce(_to_np(input), "max")


def min(input, scope=None, util=None):  # noqa: A001
    return _allreduce(_to_np(input), "min")


def auc(stat_pos, stat_neg, scope=None, util=None):
    """Global AUC from per-bucket positive/negative counts (metric.py:144:
    the same trapezoid accumulation over the merged histograms)."""
    pos = _allreduce(_to_np(stat_pos), "sum").reshape(-1)
    neg = _allreduce(_to_np(stat_neg), "sum").reshape(-1)
    # buckets from the highest score to the lowest
    tot_pos = tot_neg = 0.0
    area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        new_pos = tot_pos + pos[i]
        new_neg = tot_neg + neg[i]
        area += (new_neg - tot_neg) * (tot_pos + new_pos) / 2.0
        tot_pos, tot_neg = new_pos, new_neg
    if tot_pos == 0.0 or tot_neg == 0.0:
        return 0.5
    return float(area / (tot_pos * tot_neg))


def mae(abserr, total_ins_num, scope=None, util=None):
    e = sum(abserr).reshape(-1).sum()
    n = sum(total_ins_num).reshape(-1).sum()
    return float(e) / float(np.maximum(n, 1.0))


def mse(sqrerr, total_ins_num, scope=None, util=None):
    e = sum(sqrerr).reshape(-1).sum()
    n = sum(total_ins_num).reshape(-1).sum()
    return float(e) / float(np.maximum(n, 1.0))


def rmse(sqrerr, total_ins_num, scope=None, util=None):
    return float(np.sqrt(mse(sqrerr, total_ins_num)))


def acc(correct, total, scope=None, util=None):
    c = sum(correct).reshape(-1).sum()
    t = sum(total).reshape(-1).sum()
    return float(c) / float(np.maximum(t, 1.0))
