"""paddle.vision: the models ported so far (``vision.models``), the
datasets (``vision.datasets``) and the transforms (``vision.transforms``)."""
from . import datasets, models, transforms

__all__ = ["datasets", "models", "transforms"]
