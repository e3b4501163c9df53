"""paddle.jit: ``to_static`` (a CUDA graph per input signature on the card;
see to_static.py) and ``compiled_step.CompiledTrainStep``."""
from . import compiled_step
from .to_static import InputSpec, StaticFunction, enable_to_static, to_static

__all__ = ["to_static", "StaticFunction", "InputSpec", "enable_to_static",
           "compiled_step"]
