"""paddle.nn: the layers the GPT and BERT/ERNIE slices use."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (Dropout, Embedding, Layer, LayerList, LayerNorm, Linear,
                    MultiHeadAttention, Transformer, TransformerDecoder,
                    TransformerDecoderLayer, TransformerEncoder,
                    TransformerEncoderLayer)

__all__ = ["functional", "initializer", "Dropout", "Embedding", "Layer",
           "LayerList", "LayerNorm", "Linear", "MultiHeadAttention",
           "Transformer", "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
