"""The ``paddle.text.viterbi_decode`` module path: the implementation lives
in text/datasets.py, as in the reference."""
from .datasets import ViterbiDecoder, viterbi_decode  # noqa: F401

__all__ = ["viterbi_decode", "ViterbiDecoder"]
