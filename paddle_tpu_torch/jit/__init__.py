"""paddle.jit: ``to_static`` (eager in this port; see to_static.py)."""
from .to_static import InputSpec, StaticFunction, to_static

__all__ = ["to_static", "StaticFunction", "InputSpec"]
