"""paddle.distributed: ``fleet.utils.recompute`` and the rank and world
size (``env``). Collectives, ``DataParallel`` and the mesh come with
ROADMAP A10."""
from .env import get_rank, get_world_size

__all__ = ["get_rank", "get_world_size"]
