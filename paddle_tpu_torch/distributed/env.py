"""Rank and world size (port of paddle_tpu/distributed/env.py).

The one place the port decides this process's rank and the number of
processes. The reference reads its process index from JAX after a
bootstrap driven by the launcher's environment variables; the port reads,
in order:

1. the reference's variables: ``PADDLE_TRAINER_ID`` (or
   ``JAX_PROCESS_ID``) for the rank, ``PADDLE_TRAINERS_NUM`` (or
   ``JAX_NUM_PROCESSES``) for the world size;
2. an initialised ``torch.distributed`` process group;
3. torch's launcher variables, ``RANK`` and ``WORLD_SIZE`` (torchrun).

With none of them set, the rank is 0 and the world size 1. Only world
size 1 trains here: data-parallel training (``DataParallel``,
``init_parallel_env``) comes with ROADMAP A10.
"""
from __future__ import annotations

import os

__all__ = ["get_rank", "get_world_size"]


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
