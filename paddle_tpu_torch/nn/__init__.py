"""paddle.nn: the layers the GPT, BERT/ERNIE and conv net slices use."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, Conv2D, Dropout, Embedding, Layer,
                    LayerList, LayerNorm, Linear, MaxPool2D,
                    MultiHeadAttention, ReLU, Sequential, Transformer,
                    TransformerDecoder, TransformerDecoderLayer,
                    TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "initializer", "AdaptiveAvgPool2D", "AvgPool2D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "Conv2D", "Dropout",
           "Embedding", "Layer", "LayerList", "LayerNorm", "Linear",
           "MaxPool2D", "MultiHeadAttention", "ReLU", "Sequential",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
