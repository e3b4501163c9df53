"""linear, embedding, dropout and pad on torch tensors.

Port of paddle_tpu/nn/functional/common.py (the functions GPT uses) and of
the reference's ``pad`` (tensor/manipulation.py).
``linear`` keeps paddle's (in, out) weight layout: y = x @ W + b. Under
``amp.auto_cast`` each casts its inputs as the reference's op of the same
name is cast (amp/auto_cast.py).
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast
from ...core.random import uniform

__all__ = ["linear", "embedding", "dropout", "pad"]


def linear(x, weight, bias=None):
    """weight shape (in, out), the reference layout."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight):
    """Gather rows of ``weight`` (int32 or int64 ids)."""
    weight, = amp_cast("embedding", weight)
    return torch.nn.functional.embedding(x, weight)


def dropout(x, p=0.5, training=True, generator=None):
    """Identity in eval and at p == 0; in training, zero each element with
    probability p and scale the rest by 1 / (1 - p) (paddle's
    upscale_in_train), the keep mask drawn from ``generator``."""
    if not training or p == 0.0:
        return x
    x, = amp_cast("dropout", x)
    if p == 1.0:
        return torch.zeros_like(x)
    keep = uniform(x.shape, generator, x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


_PAD_MODES = ("constant", "reflect", "replicate", "circular")


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """The reference's flat-list convention: a list of 2 * x.dim() numbers
    pads every axis, first axis first, (lo, hi) each; a shorter list pads
    the spatial axes LAST axis first, [left, right, top, bottom] = W then
    H, as torch does. Under a channel-last ``data_format`` (NHWC, NLC,
    NDHWC) the spatial axes are 1..k, not the trailing ones, so C is never
    padded there."""
    pads = [int(p) for p in pad]
    nd = x.dim()
    if len(pads) == 2 * nd:
        width = [(pads[2 * i], pads[2 * i + 1]) for i in range(nd)]
    else:
        k = len(pads) // 2
        width = [(0, 0)] * nd
        channel_last = data_format in ("NHWC", "NDHWC", "NLC")
        spatial = list(range(1, 1 + k)) if channel_last \
            else list(range(nd - k, nd))
        for j in range(k):
            width[spatial[k - 1 - j]] = (pads[2 * j], pads[2 * j + 1])
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode must be one of {_PAD_MODES}, got "
                         f"{mode!r}")
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    # torch pads only trailing axes in these modes, behind at least one
    # batch axis: move the padded axes last, fold the rest into one
    axes = [i for i, w in enumerate(width) if w != (0, 0)]
    if not axes:
        return x
    rest = [i for i in range(nd) if i not in axes]
    moved = x.permute(*rest, *axes)
    folded = moved.reshape(1, -1, *moved.shape[len(rest):])
    flat = [p for a in reversed(axes) for p in width[a]]
    out = torch.nn.functional.pad(folded, flat, mode=mode)
    out = out.reshape(*moved.shape[:len(rest)], *out.shape[2:])
    inverse = [0] * nd
    for pos, a in enumerate(rest + axes):
        inverse[a] = pos
    return out.permute(*inverse)
