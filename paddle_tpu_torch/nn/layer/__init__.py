from .activation import ReLU
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import Conv2D
from . import loss as _loss
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["ReLU", "Dropout", "Embedding", "Linear", "LayerList",
           "Sequential", "Conv2D", "Layer", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "LayerNorm", "AdaptiveAvgPool2D", "AvgPool2D",
           "MaxPool2D", "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer", *_loss.__all__]
