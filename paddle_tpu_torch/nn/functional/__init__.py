"""paddle.nn.functional: the functions the GPT serving and training
slices use."""
from .activation import gelu
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["gelu", "dropout", "embedding", "linear", "cross_entropy",
           "layer_norm"]
