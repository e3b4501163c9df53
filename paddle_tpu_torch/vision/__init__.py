"""paddle.vision: the models ported so far (``vision.models``)."""
from . import models

__all__ = ["models"]
