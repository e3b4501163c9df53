"""Fleet's hybrid-parallel entry (port of paddle_tpu/distributed/fleet/
base.py): the strategy, the topology, the hybrid communicate group and
the ``Fleet`` object behind ``fleet.init``.

The reference lays its hybrid axes over one JAX mesh that a single
controller drives; the port runs one process per rank, so the
``HybridCommunicateGroup`` lays them over the port's mesh
(``distributed/mesh.py``, axes in ``HYBRID_AXES`` order, the last varying
fastest) and hands out each axis's ``collective.Group`` for this rank.
Its ``get_*_rank()`` are this rank's real coordinates, where the
reference's are 0 (ROADMAP, "Differences by design").
"""
from __future__ import annotations

import warnings

import numpy as np

from ..env import get_rank, get_world_size, init_parallel_env
from ..mesh import build_mesh

__all__ = ["Fleet", "DistributedStrategy", "HybridCommunicateGroup",
           "CommunicateTopology", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


# the strategy's fields that fleet stores and does not act on, as the
# reference does not: where the port does what each asks for instead.
# fleet.init warns when one is set away from its default.
STORED_ONLY = {
    "amp": "paddle.amp.auto_cast and GradScaler",
    "recompute": "fleet.utils.recompute",
    "sharding": "hybrid_configs['sharding_degree']",
    "tensor_parallel": "hybrid_configs['mp_degree']",
    "lamb": "paddle.optimizer.Lamb",
    "lars": "paddle.optimizer.Lars",
    "dgc": "nothing: the port, like the reference, has no DGC",
    "localsgd": "nothing: the port, like the reference, has no LocalSGD",
    "sync_batch_norm": "nn.SyncBatchNorm",
    "nccl_comm_num": "nothing: one communicator a group",
    "fuse_all_reduce_ops": "fuse_grad_size_in_MB (the Reducer's buckets)",
}


class DistributedStrategy:
    """fleet's strategy object: every field of the reference's, as plain
    attributes. ``hybrid_configs`` lays out the ranks; ``gradient_merge``
    and ``fp16_allreduce`` change what ``distributed_optimizer`` and
    ``distributed_model`` build; the rest is stored (``STORED_ONLY``)."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.localsgd = False
        self.fp16_allreduce = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.sync_batch_norm = False

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"


def _warn_stored_only(strategy):
    """Warn of each ``STORED_ONLY`` field (or its ``*_configs``) that
    ``strategy`` sets away from its default: fleet ignores it."""
    default = DistributedStrategy()
    for name, instead in STORED_ONLY.items():
        for field in (name, name + "_configs"):
            if hasattr(default, field) and \
                    getattr(strategy, field, None) != getattr(default, field):
                warnings.warn(
                    f"DistributedStrategy.{field} is stored but fleet does "
                    f"not act on it; use {instead}", UserWarning,
                    stacklevel=3)


class CommunicateTopology:
    """An N-D cartesian layout of the ranks: axis names and degrees."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "model"),
                 dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self._world = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    def world_size(self):
        return self._world


class HybridCommunicateGroup:
    """This rank's place in the hybrid layout: the mesh over the job's
    ranks (data, pipe, sharding, model; a degree-1 data axis takes the
    ranks the others leave) and each axis's group. Every rank builds it,
    in one order (the groups are ``torch.distributed`` groups). Besides
    the axes' groups it holds the group over the data and sharding axes
    together (``get_dp_sharding_parallel_group``), over which the
    wrappers reduce gradients."""

    def __init__(self, topology):
        self._topo = topology
        degrees = {n: topology.get_dim(n)
                   for n in topology.get_hybrid_group_names()}
        world = get_world_size()
        others = int(np.prod([d for n, d in degrees.items() if n != "data"]))
        if degrees.get("data", 1) == 1 and world % others == 0:
            degrees["data"] = world // others
        if int(np.prod(list(degrees.values()))) != world:
            raise ValueError(f"hybrid degrees {degrees} do not cover the "
                             f"{world} ranks")
        self.mesh = build_mesh(degrees)
        self._dp_degree = degrees.get("data", 1)
        self._mp_degree = degrees.get("model", 1)
        self._pp_degree = degrees.get("pipe", 1)
        self._sharding_degree = degrees.get("sharding", 1)
        self._dp_sharding = self._joint_group(("data", "sharding"))

    def _joint_group(self, axes):
        """The group of the ranks that share every coordinate but
        ``axes``: one axis's own group where the other has degree 1."""
        wide = [a for a in axes if self.mesh.shape.get(a, 1) > 1]
        if len(wide) <= 1:
            return self.mesh.group(wide[0] if wide else axes[0])
        from .. import collective
        names = self.mesh.axis_names
        keep = [i for i, a in enumerate(names) if a not in axes]
        moved = np.moveaxis(self.mesh.ranks, keep,
                            list(range(len(keep))))
        size = int(np.prod([self.mesh.shape[a] for a in axes]))
        mine = None
        for row in moved.reshape(-1, size):
            g = collective.new_group([int(r) for r in row],
                                     axis="+".join(axes))
            if get_rank() in g.ranks:
                mine = g
        return mine

    def get_parallel_mode(self):
        if self._pp_degree > 1:
            return "pipeline"
        if self._sharding_degree > 1:
            return "sharding"
        if self._mp_degree > 1:
            return "tensor"
        return "data"

    def topology(self):
        return self._topo

    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_data_parallel_rank(self):
        return self.mesh.group("data").rank

    def get_model_parallel_rank(self):
        return self.mesh.group("model").rank

    def get_sharding_parallel_rank(self):
        return self.mesh.group("sharding").rank

    def get_stage_id(self):
        return self.mesh.group("pipe").rank

    def get_data_parallel_group(self):
        return self.mesh.group("data")

    def get_model_parallel_group(self):
        return self.mesh.group("model")

    def get_pipe_parallel_group(self):
        return self.mesh.group("pipe")

    def get_sharding_parallel_group(self):
        return self.mesh.group("sharding")

    def get_dp_sharding_parallel_group(self):
        return self._dp_sharding


class PaddleCloudRoleMaker:
    """The role of this process: a collective worker (the port has no
    parameter server)."""

    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    pass


class Fleet:
    """``fleet.init`` and what follows it: ``distributed_model`` wraps a
    layer for the strategy's parallel mode, ``distributed_optimizer``
    wraps an optimizer (ZeRO-1 first, then gradient merge, then the
    hybrid optimizer)."""

    def __init__(self):
        self._role_maker = None
        self._strategy = None
        self._hcg = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None):
        """Join the process group and lay out the ranks. Every rank calls
        it with the same strategy. ``sep_degree > 1`` raises (ROADMAP
        C-ref-24): the reference stores it and builds no sep axis from
        it; ring attention takes its group from
        ``build_mesh({"sep": n})``."""
        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        sep = hc.get("sep_degree", 1)
        if sep > 1:
            raise NotImplementedError(
                f"sep_degree {sep}: fleet builds no sep axis from it (nor "
                f"does the reference, which only stores it; ROADMAP "
                f"C-ref-24); lay out the sequence_parallel ranks with "
                f"distributed.mesh.build_mesh({{'sep': {sep}}})")
        _warn_stored_only(self._strategy)
        init_parallel_env()
        topo = CommunicateTopology(
            ("data", "pipe", "sharding", "model"),
            (hc.get("dp_degree", 1), hc.get("pp_degree", 1),
             hc.get("sharding_degree", 1), hc.get("mp_degree", 1)))
        self._hcg = HybridCommunicateGroup(topo)
        self._is_initialized = True
        return self

    def is_first_worker(self):
        return get_rank() == 0

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_worker(self):
        return True

    def worker_endpoints(self, to_string=False):
        eps = ["127.0.0.1:0"]
        return ",".join(eps) if to_string else eps

    def get_hybrid_communicate_group(self):
        return self._hcg

    def _ensure_init(self):
        if self._hcg is None:
            self.init()

    def distributed_model(self, model):
        """``model`` wrapped for the parallel mode: PipelineParallel,
        TensorParallel, ShardingParallel, or DataParallel over the data
        group (its Reducer in bf16 under ``fp16_allreduce``)."""
        from ..parallel import DataParallel
        from .meta_parallel import (PipelineParallel, ShardingParallel,
                                    TensorParallel)
        self._ensure_init()
        mode = self._hcg.get_parallel_mode()
        if mode == "pipeline":
            return PipelineParallel(model, self._hcg, self._strategy)
        if mode == "tensor":
            return TensorParallel(model, self._hcg, self._strategy)
        if mode == "sharding":
            return ShardingParallel(model, self._hcg, self._strategy)
        st = self._strategy
        dp = DataParallel(
            model, strategy=st,
            comm_buffer_size=getattr(st, "fuse_grad_size_in_MB", 25),
            find_unused_parameters=getattr(st, "find_unused_parameters",
                                           False),
            group=self._hcg.get_data_parallel_group())
        if getattr(st, "fp16_allreduce", False) and dp._reducer is not None:
            import torch
            dp._reducer.comm_dtype = torch.bfloat16
        return dp

    def distributed_optimizer(self, optimizer, strategy=None):
        """The ZeRO-1 wrapper where sharding_degree > 1, then gradient
        merge where the strategy asks for it, then the hybrid optimizer
        outside data-parallel mode."""
        if strategy is not None:
            self._strategy = strategy
        self._ensure_init()
        st = self._strategy
        hcg = self._hcg
        if hcg.get_sharding_parallel_world_size() > 1:
            from .sharding_optimizer import ShardingOptimizerWrapper
            optimizer = ShardingOptimizerWrapper(optimizer, hcg=hcg)
        if getattr(st, "gradient_merge", False):
            from .meta_optimizers import GradientMergeOptimizer
            cfg = getattr(st, "gradient_merge_configs", {}) or {}
            optimizer = GradientMergeOptimizer(
                optimizer, k_steps=cfg.get("k_steps", 1),
                avg=cfg.get("avg", True))
        if hcg.get_parallel_mode() != "data":
            from .meta_parallel import HybridParallelOptimizer
            return HybridParallelOptimizer(optimizer, hcg, st)
        return optimizer
