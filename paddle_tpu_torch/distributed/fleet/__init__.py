"""paddle.distributed.fleet (port of paddle_tpu/distributed/fleet/
__init__.py): the module-level entry points over one ``Fleet``
(``init``, ``distributed_model``, ``distributed_optimizer``,
``get_hybrid_communicate_group``, the worker queries), the strategy and
topology (``base.py``), the tensor-parallel layers and wrappers
(``meta_parallel.py``), the 1F1B pipeline engine
(``pipeline_engine.py``, behind ``PipelineParallel``), ZeRO-1
(``sharding_optimizer.py``), gradient merge (``meta_optimizers.py``),
``utils.recompute``, the hybrid checkpoint's save and load
(distributed/checkpoint.py), ring attention (``sequence_parallel.py``),
the SPMD circular pipeline (``spmd_pipeline.py``), elastic training
(``elastic.py``: the FileStore and ElasticManager), the file systems
(``fs.py``: ``LocalFS``, ``HDFSClient``), the global metrics
(``metrics.py``), the datasets (``dataset.py``), the elastic
expert-parallel engine (``expert_parallel.py``: ``ExpertPlacement``,
``ExpertParallelEngine``), ``Role``, ``UtilBase`` and the slot data
generators.
"""
from __future__ import annotations

from . import (dataset, elastic, expert_parallel, fs,  # noqa: F401
               meta_optimizers, meta_parallel, metrics, pipeline_engine,
               sequence_parallel, sharding_optimizer, spmd_pipeline, utils)
from ..checkpoint import (  # noqa: F401
    load_hybrid_checkpoint, save_hybrid_checkpoint)
from .fs import HDFSClient, LocalFS  # noqa: F401
from .base import (  # noqa: F401
    CommunicateTopology, DistributedStrategy, Fleet, HybridCommunicateGroup,
    PaddleCloudRoleMaker, UserDefinedRoleMaker,
)
from .expert_parallel import (  # noqa: F401
    ExpertParallelEngine, ExpertPlacement)
from .meta_parallel import PipelineParallel  # noqa: F401
from .utils import recompute  # noqa: F401

_fleet = Fleet()

init = _fleet.init
is_first_worker = _fleet.is_first_worker
worker_index = _fleet.worker_index
worker_num = _fleet.worker_num
is_worker = _fleet.is_worker
worker_endpoints = _fleet.worker_endpoints
distributed_model = _fleet.distributed_model
distributed_optimizer = _fleet.distributed_optimizer
get_hybrid_communicate_group = _fleet.get_hybrid_communicate_group


class Role:
    """The role maker's roles."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class UtilBase:
    """Small cross-rank helpers over the collectives, on numpy values."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):  # noqa: A002
        import numpy as np
        import torch

        from .. import ReduceOp, all_reduce as _ar, get_world_size
        if get_world_size() <= 1:
            return input
        ops = {"sum": ReduceOp.SUM, "max": ReduceOp.MAX,
               "min": ReduceOp.MIN}
        t = torch.tensor(np.asarray(input))
        _ar(t, op=ops.get(mode, ReduceOp.SUM))
        return t.numpy()

    def barrier(self, comm_world="worker"):
        from .. import barrier as _barrier
        _barrier()

    def all_gather(self, input, comm_world="worker"):  # noqa: A002
        import numpy as np
        import torch

        from .. import all_gather as _ag, get_world_size
        if get_world_size() <= 1:
            return [input]
        out = []
        _ag(out, torch.tensor(np.asarray(input)))
        return [o.numpy() for o in out]

    def get_file_shard(self, files):
        from .. import get_rank, get_world_size
        n, r = get_world_size(), get_rank()
        return [f for i, f in enumerate(files) if i % n == r]


class MultiSlotDataGenerator:
    """The parameter server's data generator: subclass it and implement
    ``generate_sample(line)`` yielding [(slot_name, [values])];
    ``run_from_stdin`` writes each sample in the slot format."""

    def generate_sample(self, line):
        raise NotImplementedError

    def _format(self, sample):
        parts = []
        for _, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts)

    def run_from_stdin(self):
        import sys
        for line in sys.stdin:
            for sample in self.generate_sample(line.rstrip("\n")):
                sys.stdout.write(self._format(sample) + "\n")

    run = run_from_stdin


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """The string-slot variant: values are written as they are."""


__all__ = ["Role", "UtilBase", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator", "Fleet", "DistributedStrategy",
           "CommunicateTopology", "HybridCommunicateGroup",
           "PaddleCloudRoleMaker", "UserDefinedRoleMaker",
           "init", "is_first_worker", "worker_index", "worker_num",
           "is_worker", "worker_endpoints", "distributed_model",
           "distributed_optimizer", "get_hybrid_communicate_group",
           "recompute", "utils", "meta_parallel", "meta_optimizers",
           "sharding_optimizer", "pipeline_engine", "PipelineParallel",
           "sequence_parallel", "spmd_pipeline",
           "save_hybrid_checkpoint", "load_hybrid_checkpoint",
           "expert_parallel", "ExpertParallelEngine", "ExpertPlacement"]
