"""paddle.nn: the layers the serving slice uses."""
from . import functional, initializer
from .layer import Dropout, Embedding, Layer, LayerList, LayerNorm, Linear

__all__ = ["functional", "initializer", "Dropout", "Embedding", "Layer",
           "LayerList", "LayerNorm", "Linear"]
