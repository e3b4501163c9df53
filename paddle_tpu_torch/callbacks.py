"""paddle.callbacks: the hapi callbacks (port of paddle_tpu/callbacks.py)."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    ReduceLROnPlateau, VisualDL,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau"]
