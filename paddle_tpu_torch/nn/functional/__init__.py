"""paddle.nn.functional: every function of the reference: the
activations, the common functions, the convolutions, the norms, the
poolings, vision.py's samplers, sparse attention and every loss, with
the functions its __init__ defines (``sequence_mask``,
``scaled_dot_product_attention``, ``diag_embed``, ``npair_loss``,
``gather_tree``)."""
import torch

from . import activation as _activation
from . import common as _common
from . import conv as _conv
from . import loss as _loss
from . import norm as _norm
from . import pooling as _pooling
from . import vision  # noqa: F401  (F.vision, as the reference binds it)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .sparse_attention import sparse_attention
from .vision import *  # noqa: F401,F403


def sequence_mask(lengths, maxlen=None, dtype="int64", name=None):
    """mask[..., j] = j < lengths[...], in ``dtype`` (int64 narrows to
    int32, as every 64-bit request does); ``maxlen`` defaults to the
    largest length (a host sync)."""
    from ...core.dtypes import convert_dtype
    m = int(maxlen) if maxlen is not None else int(lengths.max())
    mask = torch.arange(m, device=lengths.device) < lengths.unsqueeze(-1)
    return mask.to(convert_dtype(dtype))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Attention over (batch, seq, heads, head_dim) inputs: flash
    attention (B1-B3) where it applies, else the math path
    (ops/attention.py)."""
    from ...ops.attention import scaled_dot_product_attention as sdpa
    return sdpa(query, key, value, attn_mask=attn_mask, dropout_p=dropout_p,
                is_causal=is_causal, training=training)


def embedding_renorm_(*args, **kwargs):
    raise NotImplementedError("embedding_renorm_ is not implemented in the "
                              "reference either")


def diag_embed(input, offset=0, dim1=-2, dim2=-1):  # noqa: A002
    """The last axis of ``input`` on the diagonal of new (dim1, dim2)
    axes. The reference places the values on the main diagonal whatever
    ``offset`` says, so an offset other than 0 raises (ROADMAP
    C-ref-15)."""
    if offset != 0:
        raise NotImplementedError(
            "diag_embed(offset != 0): the reference ignores the offset, so "
            "the port refuses it (ROADMAP C-ref-15)")
    return torch.diag_embed(input, 0, dim1, dim2)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """The N-pair loss: softmax cross-entropy of anchor . positive^T
    against the label-equality targets (each row normalised), plus
    l2_reg times the mean squared norms' average."""
    sim = anchor @ positive.T
    lab = labels.reshape(-1, 1)
    same = (lab == lab.T).to(anchor.dtype)
    same = same / same.sum(dim=1, keepdim=True)
    ce = (-(same * torch.log_softmax(sim, dim=1)).sum(dim=1)).mean()
    reg = l2_reg * ((anchor * anchor).sum(dim=1).mean()
                    + (positive * positive).sum(dim=1).mean()) / 2
    return ce + reg


def gather_tree(ids, parents):
    """Beam search's backtrack: (max_time, batch, beam) token ids and
    parent beams to the full sequence of each final beam."""
    from ..decode import backtrack
    return backtrack(ids, parents)


__all__ = [*_activation.__all__, *_common.__all__, *_conv.__all__,
           *_norm.__all__, *_pooling.__all__, *vision.__all__,
           "sparse_attention", "sequence_mask",
           "scaled_dot_product_attention", "embedding_renorm_",
           "diag_embed", "npair_loss", "gather_tree", *_loss.__all__]
