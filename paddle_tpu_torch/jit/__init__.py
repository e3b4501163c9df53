"""paddle.jit: ``to_static`` (a CUDA graph per input signature on the card;
see to_static.py), ``compiled_step.CompiledTrainStep`` and ``save``/
``load`` (weights + metadata, the reference's artifact format)."""
from . import compiled_step
from .save_load import TranslatedLayer, load, save
from .to_static import InputSpec, StaticFunction, enable_to_static, to_static

__all__ = ["to_static", "StaticFunction", "InputSpec", "enable_to_static",
           "compiled_step", "save", "load", "TranslatedLayer"]
