"""paddle.nn.functional: the functions the GPT and BERT/ERNIE slices
use."""
from .activation import gelu, relu, tanh
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["gelu", "relu", "tanh", "dropout", "embedding", "linear",
           "cross_entropy", "layer_norm"]
