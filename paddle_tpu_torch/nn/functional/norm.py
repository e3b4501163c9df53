"""layer_norm (port of paddle_tpu/nn/functional/norm.py).

Same arithmetic as the reference: mean and population variance over the
normalized axes, computed in x's dtype, then weight and bias; under
``amp.auto_cast`` the inputs are promoted to float32 (black list)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05):
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    axes = tuple(range(x.dim() - len(tuple(normalized_shape)), x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out
