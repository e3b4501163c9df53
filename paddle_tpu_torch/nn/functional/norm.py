"""layer_norm and batch_norm (port of paddle_tpu/nn/functional/norm.py).

Same arithmetic as the reference: mean and population variance over the
normalized (layer_norm) or all but the channel (batch_norm) axes,
computed in x's dtype, then weight and bias; under ``amp.auto_cast`` the
inputs are promoted to float32 (black list).

batch_norm's running statistics follow paddle's convention, which is the
opposite of torch's: ``running = momentum * running + (1 - momentum) *
batch`` with momentum 0.9, the variance taken unbiased (var * n / (n -
1)). They are written in place (``copy_``), in the buffer's own dtype
and the reference's order of operations, so that a step captured as a
CUDA graph moves them on every replay."""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["layer_norm", "batch_norm"]


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


def _bn_axes(x, data_format):
    """(channel axis, reduced axes, the broadcast shape of a channel
    vector)."""
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    ch = x.dim() - 1 if channel_last else (1 if x.dim() > 1 else 0)
    red = tuple(i for i in range(x.dim()) if i != ch)
    bshape = [1] * x.dim()
    bshape[ch] = x.shape[ch]
    return ch, red, bshape


def update_running_stats(running_mean, running_var, mean, var, n, momentum):
    """The reference's moving averages, in place: ``var`` is the batch's
    population variance over ``n`` values per channel."""
    with torch.no_grad():
        if running_mean is not None:
            running_mean.copy_(momentum * running_mean + (1.0 - momentum)
                               * mean.to(running_mean.dtype))
        if running_var is not None:
            unbiased = var * (n / max(n - 1, 1))
            running_var.copy_(momentum * running_var + (1.0 - momentum)
                              * unbiased.to(running_var.dtype))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    if use_global_stats is None:
        use_global_stats = not training
    ch, red, bshape = _bn_axes(x, data_format)
    if use_global_stats:
        x, running_mean, running_var, weight, bias = amp_cast(
            "batch_norm_eval", x, running_mean, running_var, weight, bias)
        inv = torch.rsqrt(running_var.reshape(bshape) + epsilon)
        out = (x - running_mean.reshape(bshape)) * inv
    else:
        x, weight, bias = amp_cast("batch_norm", x, weight, bias)
        mean = x.mean(dim=red)
        var = x.var(dim=red, correction=0)
        inv = torch.rsqrt(var.reshape(bshape) + epsilon)
        out = (x - mean.reshape(bshape)) * inv
        update_running_stats(running_mean, running_var, mean.detach(),
                             var.detach(), x.numel() // x.shape[ch],
                             momentum)
    if weight is not None:
        out = out * weight.reshape(bshape)
    if bias is not None:
        out = out + bias.reshape(bshape)
    return out
