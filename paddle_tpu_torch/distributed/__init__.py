"""paddle.distributed (port of paddle_tpu/distributed/__init__.py): the
process group (``init_parallel_env``, ``env.py``), the mesh's named axes
(``mesh.py``), the collectives (``collective.py``), ``DataParallel`` and
its bucketed Reducer, ``fleet.utils.recompute`` and the launcher helpers
below.

The port runs one process per rank where the reference drives every local
device from one controller process: ``spawn`` starts ``nprocs``
processes and runs ``func`` in each, where the reference runs it once
(ROADMAP, "Differences by design"). ``fleet`` holds the hybrid-parallel
entry points (``fleet.init``, ``distributed_model``,
``distributed_optimizer``), the tensor-parallel layers, the 1F1B
pipeline, ZeRO-1 and gradient merge, ring attention and the SPMD
pipeline; ``checkpoint`` the hybrid save and load with resharding;
``spec_layout`` the declarative layouts with ZeRO-3 (``SpecLayout``,
``shard_params``, ``shard_batch``, ``shard_stacked_batch``,
``unshard``); ``auto_parallel`` the semi-automatic API (``ProcessMesh``,
``shard_tensor``, ``Engine`` with ZeRO and gradient merge); ``utils`` the
expert-parallel token exchange of ``incubate.MoELayer``; ``wire`` the
framed codec and ``p2p`` the TCP channel beside the process group (the
abort broadcast, the subgroup collectives); ``launch`` and
``launch_utils`` the job launcher (``python -m
paddle_tpu_torch.distributed.launch``) with the supervised relaunch of a
failed rank. The parameter-server half: ``ps`` (the tables, the server
and client, the asynchronous communicator, ``TheOnePSRuntime``),
``transpiler`` (``DistributeTranspiler`` over two or more pservers),
``fleet_executor`` (the actor runtime) and the datasets
(``InMemoryDataset``, ``QueueDataset``, fleet/dataset.py).
"""
from __future__ import annotations

import os

from . import (auto_parallel, checkpoint, fleet,  # noqa: F401
               fleet_executor, launch, launch_utils, p2p, ps, spec_layout,
               transpiler, utils, wire)
from .auto_parallel import (  # noqa: F401
    ProcessMesh, dtensor_from_fn, reshard, shard_op, shard_tensor)
from .checkpoint import (  # noqa: F401
    CorruptCheckpointError, load_hybrid_checkpoint, reshard_model,
    save_hybrid_checkpoint)
from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_reduce, alltoall, barrier, broadcast,
    get_group, new_group, recv, reduce, reduce_scatter, scatter, send, split)
from .fleet.dataset import InMemoryDataset, QueueDataset  # noqa: F401
from .env import (  # noqa: F401
    get_rank, get_world_size, init_parallel_env, is_initialized,
    parallel_device_count)
from .mesh import get_mesh, global_mesh, set_mesh  # noqa: F401
from .parallel import DataParallel  # noqa: F401
from .spec_layout import (  # noqa: F401
    SpecLayout, shard_batch, shard_params, shard_stacked_batch, unshard)

__all__ = [
    "init_parallel_env", "get_rank", "get_world_size", "all_reduce",
    "all_gather", "reduce", "broadcast", "scatter", "alltoall", "barrier",
    "send", "recv", "reduce_scatter", "new_group", "get_group", "split",
    "ReduceOp", "DataParallel", "fleet", "get_mesh", "set_mesh", "spawn",
    "ParallelEnv", "gloo_init_parallel_env", "gloo_barrier", "gloo_release",
    "wait", "CountFilterEntry", "ProbabilityEntry", "is_initialized",
    "parallel_device_count", "global_mesh", "save_hybrid_checkpoint",
    "load_hybrid_checkpoint", "reshard_model", "CorruptCheckpointError",
    "spec_layout", "SpecLayout", "shard_params", "shard_batch",
    "shard_stacked_batch", "unshard", "auto_parallel", "ProcessMesh",
    "dtensor_from_fn", "reshard", "shard_op", "shard_tensor", "utils",
    "launch", "launch_utils", "wire", "p2p"]


def spawn(func, args=(), nprocs=-1, join=True, daemon=False,
          backend=None, **options):
    """Run ``func(*args)`` in ``nprocs`` processes, one per rank, each in
    the process group (ranks 0..nprocs-1 on this host, a free localhost
    port). ``nprocs=-1``: one per card, or 1 without a card. Returns the
    processes' context (``torch.multiprocessing.spawn``'s)."""
    import socket

    import torch
    import torch.multiprocessing as mp
    if nprocs == -1:
        nprocs = max(torch.cuda.device_count(), 1)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    return mp.start_processes(
        _spawn_entry, args=(func, args, nprocs, addr, backend),
        nprocs=nprocs, join=join, daemon=daemon, start_method="spawn")


def _spawn_entry(rank, func, args, nprocs, addr, backend):
    os.environ.update({"PADDLE_TRAINER_ID": str(rank),
                       "PADDLE_TRAINERS_NUM": str(nprocs),
                       "PADDLE_COORDINATOR_ADDR": addr})
    init_parallel_env(backend=backend)
    func(*args)


class ParallelEnv:
    """The process's distributed context, read-only (the reference's
    fluid/dygraph/parallel.py ParallelEnv)."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        from .env import device
        d = device()
        return d.index if d is not None and d.index is not None else 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []

    local_rank = rank
    nranks = world_size
    dev_id = device_id


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """The reference's gloo bootstrap for CPU collectives: the process
    group on gloo at ``server_endpoint`` (host:port)."""
    os.environ.update({"PADDLE_TRAINER_ID": str(rank_id),
                       "PADDLE_TRAINERS_NUM": str(rank_num),
                       "PADDLE_COORDINATOR_ADDR": server_endpoint})
    return init_parallel_env(backend="gloo")


def gloo_barrier():
    barrier()


def gloo_release():
    return None


def wait(tensor, group=None, use_calc_stream=True):
    """c_wait_*: the host waits until ``tensor``'s pending work is done."""
    import torch
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class CountFilterEntry:
    """Sparse-table admission policy of the parameter server: admit a
    feature after ``count`` occurrences."""

    def __init__(self, count=1):
        if count < 1:
            raise ValueError("count must be >= 1")
        self._count = int(count)

    def __str__(self):
        return f"count_filter_entry:{self._count}"


class ProbabilityEntry:
    """Sparse-table admission policy: admit with probability p."""

    def __init__(self, probability):
        if not 0 < probability <= 1:
            raise ValueError("probability must be in (0, 1]")
        self._probability = float(probability)

    def __str__(self):
        return f"probability_entry:{self._probability}"
