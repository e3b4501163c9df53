from . import activation as _activation
from . import common as _common
from . import container as _container
from . import loss as _loss
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import Conv2D
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import BatchNorm, BatchNorm1D, BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = [*_activation.__all__, *_common.__all__, *_container.__all__,
           "Conv2D", "Layer", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "LayerNorm", "AdaptiveAvgPool2D", "AvgPool2D", "MaxPool2D",
           "MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer", *_loss.__all__]
