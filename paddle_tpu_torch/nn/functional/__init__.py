"""paddle.nn.functional: the functions the serving slice uses."""
from .activation import gelu
from .common import dropout, embedding, linear
from .norm import layer_norm

__all__ = ["gelu", "dropout", "embedding", "linear", "layer_norm"]
