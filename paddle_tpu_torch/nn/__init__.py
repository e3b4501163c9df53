"""paddle.nn: the layers the GPT, BERT/ERNIE and conv net slices use, and
every loss layer of the reference."""
from ..framework.param_attr import ParamAttr
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import loss as _loss
from .layer.loss import *  # noqa: F401,F403
from .layer import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, Conv2D, Dropout, Embedding, Layer,
                    LayerList, LayerNorm, Linear, MaxPool2D,
                    MultiHeadAttention, ReLU, Sequential, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "ParamAttr", "AdaptiveAvgPool2D", "AvgPool2D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "Conv2D", "Dropout",
           "Embedding", "Layer", "LayerList", "LayerNorm", "Linear",
           "MaxPool2D", "MultiHeadAttention", "ReLU", "Sequential",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           *_loss.__all__]
