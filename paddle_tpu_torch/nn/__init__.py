"""paddle.nn: Layer and its containers, every activation and common
layer of the reference, Conv2D, the norms, the 2-D poolings, the
transformer layers and every loss layer. The rest of the reference's
layers (1-D/3-D convs and poolings, RNNs, the other norms, decoding)
come with the rest of nn (ROADMAP A4)."""
from ..framework.param_attr import ParamAttr
from . import functional, initializer
from . import layer as _layer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403

__all__ = ["functional", "initializer", "ParamAttr", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm", *_layer.__all__]
