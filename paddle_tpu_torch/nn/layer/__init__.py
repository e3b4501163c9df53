from . import activation as _activation
from . import common as _common
from . import container as _container
from . import conv as _conv
from . import loss as _loss
from . import norm as _norm
from . import pooling as _pooling
from . import rnn as _rnn
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .layers import Layer
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import (MultiHeadAttention, Transformer,
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = [*_activation.__all__, *_common.__all__, *_container.__all__,
           *_conv.__all__, "Layer", *_norm.__all__, *_pooling.__all__,
           *_rnn.__all__, "MultiHeadAttention", "Transformer",
           "TransformerDecoder", "TransformerDecoderLayer",
           "TransformerEncoder", "TransformerEncoderLayer", *_loss.__all__]
