"""ZeRO-1: the optimizer's state split over the sharding ranks (port of
paddle_tpu/distributed/fleet/sharding_optimizer.py).

The reference shards its accumulators with a ``NamedSharding`` over the
"sharding" axis and lets GSPMD partition the update under one controller.
The port runs one process per rank and does what upstream Paddle's
``DygraphShardingOptimizer`` does, which the reference's docstring
names: a greedy, size-balanced partition of the parameters over the
sharding ranks (each parameter, in list order, to the rank holding the
fewest elements so far); each rank creates accumulators and f32 masters
for the parameters it owns only and updates only those; then each owner
broadcasts its parameters to the other ranks. The gradients are
reduced before the step over the sharding ranks, and over the data ranks
where dp > 1 (``ShardingParallel``'s Reducer over the group of both), so
every rank sees every parameter's reduced gradient. A GradScaler checks
only the owned gradients on each rank, so it reduces its ``found_inf``
over the sharding group (``_found_inf_group``, amp/grad_scaler.py).

``shard_params=True`` is ZeRO-3, the parameters themselves split, as the
reference's ``shard_params`` branch does: each parameter keeps this
rank's slice of its first dim that the sharding degree divides (the
reference's ``_shard_spec_for``), through the same code as
``spec_layout.shard_params`` (``shard_parameters``); the optimizer then
updates every local slice, and its moments and masters are born from
them. A model's forward gathers the slices where it uses them and its
backward averages their gradients over the sharding group
(distributed/spec_layout.py), so no broadcast follows the step.
"""
from __future__ import annotations

import torch

from .meta_parallel import _broadcast_params

__all__ = ["ShardingOptimizerWrapper", "shard_optimizer_states",
           "partition_parameters"]


def _shard_dim(shape, degree):
    """The reference's choice: the first dim that ``degree`` divides, or
    None."""
    for i, size in enumerate(shape):
        if size >= degree and size % degree == 0:
            return i
    return None


def partition_parameters(params, nranks):
    """Greedy, size-balanced: each parameter in order to the rank with the
    fewest elements so far (the lowest such rank). Returns one list of
    parameters a rank."""
    parts = [[] for _ in range(nranks)]
    sizes = [0] * nranks
    for p in params:
        r = sizes.index(min(sizes))
        parts[r].append(p)
        sizes[r] += p.numel()
    return parts


def _sharding_group(hcg, axis):
    if hcg is not None:
        return hcg.get_sharding_parallel_group()
    from ..mesh import get_mesh
    mesh = get_mesh()
    return mesh.group(axis) if axis in mesh.axis_names else None


class ShardingOptimizerWrapper:
    """ZeRO-1 around ``optimizer`` (module docstring). ``step()`` updates
    this rank's parameters and broadcasts every rank's; the wrapped
    optimizer's ``clear_grad()`` clears every parameter's gradient (its
    parameter list stays whole)."""

    def __init__(self, optimizer, hcg=None, axis="sharding",
                 shard_params=False, group=None):
        """``group``: the ranks to shard over, given by the caller where
        they are its data axis (auto_parallel's Engine): each then holds
        its own part of the batch, and a slice's gradient is averaged over
        them once, in its gathering. Else the hybrid group's sharding
        ranks, or the mesh's ``axis``."""
        self._inner = optimizer
        replicas = None
        if group is None:
            group = _sharding_group(hcg, axis)
            if shard_params:
                from ..mesh import get_mesh
                from ..spec_layout import _replicas
                replicas = _replicas(get_mesh(), "data")
        self._sharding_group = group
        params = list(optimizer._parameter_list or ())
        n = group.nranks if group is not None else 1
        self.shards_params = bool(shard_params)
        if shard_params:
            self._shard(params, group, n, axis, replicas)
            return
        self._parts = partition_parameters(params, n)
        rank = max(group.rank, 0) if group is not None else 0
        self._owned = self._parts[rank]
        self._found_inf_group = group if n > 1 else None
        if n > 1:
            owned = {id(p) for p in self._owned}
            # the rule, its accumulators and masters see the owned ones
            optimizer._owned_ids = owned

    def _shard(self, params, group, n, axis, replicas):
        """ZeRO-3: every parameter with a dim the degree divides keeps
        its slice; each rank updates all of its slices. ``replicas``: the
        group the Reducer averages the slices' gradients over."""
        self._parts, self._owned = [params], params
        self._found_inf_group = group if n > 1 else None
        if n <= 1:
            return
        from ..spec_layout import shard_parameters
        items = []
        for p in params:
            if getattr(p, "fsdp_split", None) is not None or \
                    getattr(p, "tp_split", None) is not None:
                continue
            dim = _shard_dim(tuple(p.shape), n)
            if dim is not None:
                spec = [None] * p.dim()
                spec[dim] = axis
                p.sharding_spec = tuple(spec)
                items.append((p, dim))
        shard_parameters(items, group, replicas)

    @property
    def owned_parameters(self):
        return list(self._owned)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @torch.no_grad()
    def step(self):
        self._inner.step()
        g = self._sharding_group
        if g is None or g.nranks == 1 or self.shards_params:
            return
        for r, part in enumerate(self._parts):
            if part:
                _broadcast_params(part, g.global_rank(r), g)

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        return None, None


def shard_optimizer_states(optimizer, hcg=None, axis="sharding"):
    """``optimizer`` under ZeRO-1 over the sharding group."""
    return ShardingOptimizerWrapper(optimizer, hcg=hcg, axis=axis)
