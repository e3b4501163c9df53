"""layer_norm, batch_norm, instance_norm, group_norm,
local_response_norm and normalize (port of
paddle_tpu/nn/functional/norm.py).

Same arithmetic as the reference: mean and population variance over the
normalized (layer_norm) or all but the channel (batch_norm) axes,
computed in x's dtype, then weight and bias; under ``amp.auto_cast`` the
inputs are promoted to float32 (black list).

batch_norm's running statistics follow paddle's convention, which is the
opposite of torch's: ``running = momentum * running + (1 - momentum) *
batch`` with momentum 0.9, the variance taken unbiased (var * n / (n -
1)). They are written in place (``copy_``), in the buffer's own dtype
and the reference's order of operations, so that a step captured as a
CUDA graph moves them on every replay.

instance_norm and group_norm normalise with the biased variance and
``rsqrt(var + eps)``, as the reference does. The reference's
instance_norm never reads ``running_mean``, ``running_var``,
``use_input_stats`` or ``momentum``: anything but their defaults raises
(ROADMAP C-ref-17). local_response_norm sums the squares over a window
of ``size`` channels (``size // 2`` before, the rest after) and divides
``alpha`` by ``size``."""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["layer_norm", "batch_norm", "instance_norm", "group_norm",
           "local_response_norm", "normalize"]


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


def _affine(out, weight, bias, ch):
    """``out`` scaled by ``weight`` and shifted by ``bias``, channel
    vectors along axis ``ch`` (either may be None)."""
    shape = [1] * out.dim()
    shape[ch] = -1
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalised over its spatial axes."""
    unread = [n for n, bad in (
        ("running_mean", running_mean is not None),
        ("running_var", running_var is not None),
        ("use_input_stats", not use_input_stats),
        ("momentum", momentum != 0.9)) if bad]
    if unread:
        raise NotImplementedError(
            f"instance_norm: the reference never reads {', '.join(unread)} "
            f"and always normalises with the input's statistics (ROADMAP "
            f"C-ref-17)")
    x, weight, bias = amp_cast("instance_norm", x, weight, bias)
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    ch = x.dim() - 1 if channel_last else 1
    axes = tuple(range(1, x.dim() - 1)) if channel_last \
        else tuple(range(2, x.dim()))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, correction=0, keepdim=True)
    return _affine((x - mean) * torch.rsqrt(var + eps), weight, bias, ch)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """The channels split into ``num_groups`` groups, each (sample,
    group) normalised over its channels and spatial axes."""
    x, weight, bias = amp_cast("group_norm", x, weight, bias)
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    nd = x.dim()
    ch = nd - 1 if channel_last else 1
    c, g = x.shape[ch], num_groups
    if channel_last:
        r = x.reshape(tuple(x.shape[:-1]) + (g, c // g))
        axes = tuple(range(1, nd - 1)) + (nd,)
    else:
        r = x.reshape((x.shape[0], g, c // g) + tuple(x.shape[2:]))
        axes = (2,) + tuple(range(3, nd + 1))
    mean = r.mean(dim=axes, keepdim=True)
    var = r.var(dim=axes, correction=0, keepdim=True)
    out = ((r - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine(out, weight, bias, ch)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * (sum of squares over ``size`` neighbouring
    channels) / size) ** beta; channels are axis 1 for a format that
    starts with "NC", the last axis otherwise."""
    x, = amp_cast("local_response_norm", x)
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    half = size // 2
    pads = [(0, 0)] * x.dim()
    pads[ch] = (half, size - half - 1)
    padded = torch.nn.functional.pad(
        x * x, [p for lo_hi in reversed(pads) for p in lo_hi])
    acc = torch.zeros_like(x)
    for ofs in range(size):
        acc = acc + padded.narrow(ch, ofs, x.shape[ch])
    return x / (k + alpha * acc / size) ** beta


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p, epsilon) along ``axis``."""
    x, = amp_cast("normalize", x)
    if p == 2:
        n = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        n = torch.sum(x.abs() ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp(n, min=epsilon)
