"""paddle.text: the NLP datasets, ``viterbi_decode`` and ``ViterbiDecoder``,
the BERT tokenizer and the text models."""
# the viterbi_decode submodule is imported first and the name then bound
# to the function: a later ``import paddle_tpu_torch.text.viterbi_decode``
# finds the module in sys.modules and leaves the function bound
from . import viterbi_decode as _viterbi_decode_module  # noqa: F401
from . import models
from .datasets import (Conll05st, Imdb, Imikolov, Movielens, UCIHousing,
                       ViterbiDecoder, WMT14, WMT16, viterbi_decode)
from .tokenizer import (BasicTokenizer, FasterTokenizer, Vocab,
                        WordpieceTokenizer)

__all__ = ["Imdb", "Imikolov", "UCIHousing", "Conll05st", "Movielens",
           "WMT14", "WMT16", "ViterbiDecoder", "viterbi_decode", "models",
           "FasterTokenizer", "Vocab", "BasicTokenizer",
           "WordpieceTokenizer"]
