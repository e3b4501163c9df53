"""paddle.nn.functional: the functions the GPT, BERT/ERNIE and conv net
slices use."""
from .activation import gelu, relu, tanh
from .common import dropout, embedding, linear, pad
from .conv import conv2d
from .loss import cross_entropy
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d

__all__ = ["gelu", "relu", "tanh", "dropout", "embedding", "linear", "pad",
           "conv2d", "cross_entropy", "batch_norm", "layer_norm",
           "adaptive_avg_pool2d", "avg_pool2d", "max_pool2d"]
