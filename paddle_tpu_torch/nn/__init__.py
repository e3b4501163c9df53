"""paddle.nn: the layers the GPT serving and training slices use."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Dropout, Embedding, Layer, LayerList, LayerNorm, Linear

__all__ = ["functional", "initializer", "Dropout", "Embedding", "Layer",
           "LayerList", "LayerNorm", "Linear", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
