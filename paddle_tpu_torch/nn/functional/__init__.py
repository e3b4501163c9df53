"""paddle.nn.functional: the functions the GPT, BERT/ERNIE and conv net
slices use, and every loss of the reference."""
from .activation import gelu, relu, tanh
from .common import dropout, embedding, linear, pad
from .conv import conv2d
from . import loss as _loss
from .loss import *  # noqa: F401,F403
from .norm import batch_norm, layer_norm
from .pooling import adaptive_avg_pool2d, avg_pool2d, max_pool2d

__all__ = ["gelu", "relu", "tanh", "dropout", "embedding", "linear", "pad",
           "conv2d", "batch_norm", "layer_norm",
           "adaptive_avg_pool2d", "avg_pool2d", "max_pool2d",
           *_loss.__all__]
