"""The global device mesh: named axes over the job's ranks (port of
paddle_tpu/distributed/mesh.py).

The reference builds one logical N-D ``jax.sharding.Mesh`` over every
device and names its axes in the hybrid order ``HYBRID_AXES`` (data,
pipe, sharding, sep, model). The port runs one process per rank, so a
mesh is the same registry over ranks: ``axis_degrees`` lay the ranks out
in that order (the last axis varies fastest, as a reshaped device array
does), and each axis has, for this rank, the group of ranks that share
every other coordinate (``Mesh.group``), created on every rank in one
order, as ``torch.distributed.new_group`` requires.

fleet's ``HybridCommunicateGroup`` (fleet/base.py) builds its mesh here
over the data, pipe, sharding and model axes, and the tensor-parallel
layers and ZeRO-1 (fleet/meta_parallel.py, fleet/sharding_optimizer.py)
split over its "model" and "sharding" groups. ``build_mesh({"sep": n})``
gives ring attention its group (fleet/sequence_parallel.py),
``build_mesh({"pipe": n})`` the SPMD pipeline its (fleet/spmd_pipeline.py)
and ``{"data": d, "sharding": s}`` a SpecLayout's
(distributed/spec_layout.py).

``shard_map`` has no counterpart in a process-per-rank design: each rank
already runs its shard's program. The reference's uses of it became
per-rank code: the MoE's token exchange (``incubate.MoELayer`` over
``distributed.utils``' all-to-alls), ring attention's schedule
(fleet/sequence_parallel.py) and the SPMD pipeline's
(fleet/spmd_pipeline.py). It raises, naming them.
"""
from __future__ import annotations

import numpy as np

from .env import get_rank, get_world_size

__all__ = ["HYBRID_AXES", "Mesh", "build_mesh", "set_mesh", "get_mesh",
           "global_mesh", "axis_degree", "shard_map"]

HYBRID_AXES = ("data", "pipe", "sharding", "sep", "model")

_STATE = {"mesh": None}


class Mesh:
    """Named axes over ranks: ``ranks`` is an int array of the axes'
    degrees, ``axis_names`` their names."""

    def __init__(self, ranks, axis_names):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"{self.ranks.ndim} axes, names "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self._groups = {}

    def group(self, axis):
        """This rank's ``collective.Group`` along ``axis``."""
        if axis not in self._groups:
            raise KeyError(f"axis {axis!r} not in {self.axis_names}")
        return self._groups[axis]

    def _make_groups(self):
        from . import collective
        i_of = {a: i for i, a in enumerate(self.axis_names)}
        for axis in self.axis_names:
            if self.shape[axis] == self.ranks.size:
                self._groups[axis] = collective.get_group(0)
                continue
            # every rank creates every group of the axis, in one order
            moved = np.moveaxis(self.ranks, i_of[axis], -1)
            mine = None
            for row in moved.reshape(-1, self.shape[axis]):
                g = collective.new_group([int(r) for r in row], axis=axis)
                if get_rank() in g.ranks:
                    mine = g
            self._groups[axis] = mine


def build_mesh(axis_degrees=None):
    """The global mesh over ``get_world_size()`` ranks. ``axis_degrees``:
    {axis: degree}, their product the world size; a missing factor goes
    to "data"; default: every rank on "data"."""
    n = get_world_size()
    if axis_degrees is None:
        axis_degrees = {"data": n}
    names = [a for a in HYBRID_AXES if a in axis_degrees] + \
        [a for a in axis_degrees if a not in HYBRID_AXES]
    degrees = [int(axis_degrees[a]) for a in names]
    total = int(np.prod(degrees))
    if total != n:
        if "data" in axis_degrees or n % total:
            raise ValueError(
                f"axis degrees {axis_degrees} do not cover {n} ranks")
        names, degrees = ["data"] + names, [n // total] + degrees
    mesh = Mesh(np.arange(n).reshape(degrees), names)
    mesh._make_groups()
    _STATE["mesh"] = mesh
    return mesh


def set_mesh(mesh):
    _STATE["mesh"] = mesh
    return mesh


def get_mesh():
    if _STATE["mesh"] is None:
        build_mesh()
    return _STATE["mesh"]


def global_mesh():
    return get_mesh()


def axis_degree(axis):
    return get_mesh().shape.get(axis, 1)


def shard_map(fn, mesh, in_specs, out_specs, check_rep=True):
    raise NotImplementedError(
        "shard_map: the port runs one process per rank, so each rank "
        "already runs its shard's program; the reference's SPMD regions "
        "are per-rank code here: the MoE's token exchange "
        "(incubate.MoELayer with expert_axis, distributed.utils."
        "expert_dispatch/expert_combine), ring attention "
        "(fleet.sequence_parallel) and the SPMD pipeline "
        "(fleet.spmd_pipeline)")
