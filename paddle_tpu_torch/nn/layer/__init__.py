from .common import Dropout, Embedding, Linear
from .container import LayerList
from .layers import Layer
from .norm import LayerNorm
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["Dropout", "Embedding", "Linear", "LayerList", "Layer",
           "LayerNorm", "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer"]
