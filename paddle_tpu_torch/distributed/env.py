"""Rank, world size and the process group (port of
paddle_tpu/distributed/env.py).

The one place the port decides this process's rank and the number of
processes. The reference reads its process index from JAX after a
bootstrap driven by the launcher's environment variables; the port reads,
in order:

1. the reference's variables: ``PADDLE_TRAINER_ID`` (or
   ``JAX_PROCESS_ID``) for the rank, ``PADDLE_TRAINERS_NUM`` (or
   ``JAX_NUM_PROCESSES``) for the world size;
2. an initialised ``torch.distributed`` process group;
3. torch's launcher variables, ``RANK`` and ``WORLD_SIZE`` (torchrun).

With none of them set, the rank is 0 and the world size 1.

``init_parallel_env`` joins the process group of a job of more than one
process: ``torch.distributed.init_process_group`` at
``PADDLE_COORDINATOR_ADDR`` (host:port), or torchrun's ``MASTER_ADDR``
and ``MASTER_PORT``. The port runs one process per rank, where the
reference drives every local device from one process. The backend is an
explicit choice (``backend()`` names it): NCCL when each rank has a card
of its own, gloo on the CPU, and gloo over CUDA tensors when more ranks
than cards share a host, since NCCL refuses two ranks on one device. The
group's own timeout is ``FLAGS_collective_timeout``, the deadline of the
watchdog's sections (``resilience/watchdog.py``): a collective whose peer
never comes fails at it, where gloo alone would wait 30 minutes.

After an elastic rendezvous (``fleet.elastic.ElasticManager.rendezvous``
over a ``FileStore``) the group forms on a ``torch.distributed.FileStore``
in the elastic directory, one file a generation, so it outlives any one
rank's process (a TCPStore lives in rank 0's). ``teardown`` leaves the
group and drops the state tied to it (the mesh, the groups, the Reducers'
pending buckets); ``init_parallel_env`` then forms it again, at the
rendezvous' generation: the in-job recovery of
``resilience.recovery.RecoveryManager``.
"""
from __future__ import annotations

import os

__all__ = ["get_rank", "get_world_size", "init_parallel_env",
           "is_initialized", "parallel_device_count", "backend", "device",
           "teardown"]

_STATE = {"initialized": False, "backend": None, "device": None,
          # (generation, directory) of the last elastic rendezvous
          "rendezvous": None,
          # a group of more than one rank was formed (teardown keeps it:
          # the recovery forms one again)
          "formed": False}


def _env_int(names):
    for name in names:
        value = os.environ.get(name)
        if value:
            return int(value)
    return None


def _torch_group():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def get_rank(group=None):
    """This process's data-parallel rank."""
    rank = _env_int(("PADDLE_TRAINER_ID", "JAX_PROCESS_ID"))
    if rank is None:
        dist = _torch_group()
        rank = dist.get_rank() if dist is not None \
            else _env_int(("RANK",))
    return 0 if rank is None else rank


def get_world_size(group=None):
    """The number of data-parallel processes (``group.nranks`` for a
    group that has one)."""
    if group is not None and hasattr(group, "nranks"):
        return group.nranks
    size = _env_int(("PADDLE_TRAINERS_NUM", "JAX_NUM_PROCESSES"))
    if size is None:
        dist = _torch_group()
        size = dist.get_world_size() if dist is not None \
            else _env_int(("WORLD_SIZE",))
    return 1 if size is None else size


def _choose_backend(world):
    """(backend, device) of this rank: NCCL and a card of its own where
    every rank has one, else gloo (over the card's tensors when ranks
    share a card)."""
    import torch
    if not torch.cuda.is_available():
        return "gloo", torch.device("cpu")
    cards = torch.cuda.device_count()
    local = _env_int(("LOCAL_RANK",))
    local = get_rank() % cards if local is None else local
    if world <= cards:
        return "nccl", torch.device("cuda", local)
    return "gloo", torch.device("cuda", local % cards)


def _coordinator():
    addr = os.environ.get("PADDLE_COORDINATOR_ADDR")
    if addr:
        return addr
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def init_parallel_env(strategy=None, backend=None):
    """Join this job's process group (module docstring) and build the
    data mesh. At world size 1 no group is formed and every collective is
    a no-op, as in the reference. ``backend`` overrides the choice."""
    import torch
    import torch.distributed as dist
    if _STATE["initialized"]:
        return
    world = get_world_size()
    if dist.is_available() and dist.is_initialized():
        _STATE["backend"] = dist.get_backend()
        _STATE["device"] = _choose_backend(world)[1]
    elif world > 1:
        addr = _coordinator()
        if addr is None and _STATE["rendezvous"] is None:
            raise RuntimeError(
                f"init_parallel_env at world size {world}: set "
                f"PADDLE_COORDINATOR_ADDR (host:port of rank 0), or "
                f"MASTER_ADDR and MASTER_PORT")
        chosen, dev = _choose_backend(world)
        chosen = backend or chosen
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(chosen, world_size=world, rank=get_rank(),
                                timeout=_timeout(), **_store(world, addr))
        _STATE["backend"], _STATE["device"] = chosen, dev
        _STATE["formed"] = True
        # a killed rank leaves its flight-recorder dump behind
        from ..resilience.recorder import install_signal_dump
        install_signal_dump()
    from .mesh import build_mesh
    build_mesh()
    _STATE["initialized"] = True


def _timeout():
    import datetime

    from ..framework.flags import get_flag
    return datetime.timedelta(
        seconds=float(get_flag("FLAGS_collective_timeout", 300.0)))


def _store(world, addr):
    """init_process_group's rendezvous: the generation's FileStore after
    an elastic rendezvous, else the coordinator's TCPStore."""
    if _STATE["rendezvous"] is None:
        return {"init_method": f"tcp://{addr}"}
    import torch.distributed as dist
    gen, root = _STATE["rendezvous"]
    os.makedirs(root, exist_ok=True)
    return {"store": dist.FileStore(os.path.join(root, f"gen{gen}"), world)}


def set_rendezvous(generation, directory):
    """Form the next group on a FileStore in ``directory`` keyed by
    ``generation`` (ElasticManager.rendezvous calls this)."""
    _STATE["rendezvous"] = (int(generation), directory)


def teardown():
    """Leave the process group (if any) and drop what was tied to it: the
    mesh and its groups, the Reducers' pending buckets. Every collective
    afterwards needs ``init_parallel_env`` again. Idempotent."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:
            pass  # a group whose peers are gone may not leave cleanly
    from . import collective, mesh, reducer
    _STATE.update(initialized=False, backend=None, device=None)
    mesh._STATE["mesh"] = None
    for gid in [k for k in collective._GROUPS if k != 0]:
        del collective._GROUPS[gid]
    for r in list(reducer._LIVE):
        r.reset()


def is_initialized():
    return _STATE["initialized"]


def backend():
    """The process group's backend ("nccl" or "gloo"), None without one."""
    return _STATE["backend"]


def device():
    """This rank's device as init_parallel_env chose it (None before)."""
    return _STATE["device"]


def parallel_device_count():
    """The devices one process drives: one card (or the CPU)."""
    return 1
