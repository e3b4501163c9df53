"""paddle.distributed: so far only ``fleet.utils.recompute``."""
