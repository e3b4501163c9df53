"""paddle.hapi: ``Model`` (fit, evaluate, predict, save, load), the
callbacks, ``summary`` and ``flops`` (port of paddle_tpu/hapi/)."""
from .callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
)
from .dynamic_flops import flops  # noqa: F401
from .model import Model  # noqa: F401
from .model_summary import summary  # noqa: F401

__all__ = ["Model", "summary", "flops", "Callback", "EarlyStopping",
           "LRScheduler", "ModelCheckpoint", "ProgBarLogger"]
