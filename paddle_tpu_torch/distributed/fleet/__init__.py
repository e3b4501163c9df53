"""paddle.distributed.fleet: so far only ``utils.recompute``."""
from . import utils

__all__ = ["utils"]
