"""paddle.nn: Layer and every layer of the reference (containers,
activations, the common layers, the convolutions, the norms, the
poolings, the RNNs, the transformer layers, every loss), decoding
(``decode``: the beam search decoders and ``dynamic_decode``), ``utils``
and ``quant``."""
from ..framework.param_attr import ParamAttr
from . import decode, functional, initializer, quant, utils
from . import layer as _layer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import (BeamSearchDecoder, Decoder,
                     TransformerBeamSearchDecoder, dynamic_decode)
from .layer import *  # noqa: F401,F403

__all__ = ["functional", "initializer", "ParamAttr", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", "decode", "quant",
           "utils", "Decoder", "BeamSearchDecoder",
           "TransformerBeamSearchDecoder", "dynamic_decode",
           *_layer.__all__]
