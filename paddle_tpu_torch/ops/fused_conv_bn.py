"""Fused [ReLU ->] Conv2D -> BatchNorm, with the backward that saves one
activation tensor per layer.

Port of paddle_tpu/ops/fused_conv_bn.py. The convolutions stay cuDNN's
(``torch.nn.functional.conv2d`` forward, ``aten.convolution_backward``
for dgrad and wgrad), as the reference leaves them to XLA; the fusion is
a memory plan. Autograd of relu -> conv -> batch_norm saves two
activation tensors per layer across the forward/backward boundary: the
activated conv input (wgrad's operand) and the conv output z (which BN's
backward reads to re-form x_hat). The ``torch.autograd.Function`` here
saves (x, w, gamma, beta, inv, y), y = gamma * x_hat + beta its own
pre-activation output, and never z nor relu(x). The backward rebuilds the
rest elementwise:

    x_hat    = (y - beta) / gamma       (0 where |gamma| <= _GAMMA_TOL)
    dz       = gamma * inv * (g - mean(g) - x_hat * mean(g * x_hat))
    conv-in  = relu(x)                  (recomputed when act_input)
    dx       = dgrad(dz) * (x > 0)      (the mask when act_input)

Consecutive fused layers hand each other the pre-activation y (the next
layer applies the ReLU on its input side, ``act_input=True``), so a chain
of N conv + BN + ReLU layers keeps N activation tensors instead of 2N.
The activation is fused on the input side because behind an output ReLU
x_hat cannot be recovered where the mask is zero.

Batch statistics and the BN backward run in float32 (float64 for f64
inputs), whatever the input dtype; the forward uses batch_norm's association ((z - mean) * inv, then
gamma, then beta), so in f32 it equals the unfused composition to the
bit. A gamma with a channel inside the |gamma| <= 1e-6 band (where the
custom backward would freeze it) routes through plain autograd of the
same forward; the verdict is cached on the parameter (``_param_guard``),
so it syncs the host once per parameter, in a discovery pass, never
inside a capture. The eval branch folds the running statistics into a
per-channel scale and shift after the conv, the inference path.

When a gradient is wanted in training, the measured fusion policy
(``ops/autotune.py``, ``FLAGS_fusion_policy``) picks per call between
the Function and plain autograd of the same forward, as the reference's
``choose_fused`` does; the degenerate-gamma route comes first. Without a
gradient the two forms are one forward. NHWC input is viewed as NCHW with
channels_last strides (``conv.nchw_view``).
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import amp_cast
from ..nn.functional.common import pad as _pad
from ..nn.functional.conv import (conv2d_nchw, conv_args, from_nchw_view,
                                  nchw_view)
from ..nn.functional.norm import update_running_stats
from . import autotune
from ._param_guard import degenerate_below_tol

__all__ = ["fused_conv_bn"]

# channels with |gamma| at or below this take x_hat = 0 in the backward
# (dgamma = dz = 0 there): x_hat = (y - beta) / gamma is noise once
# |gamma| falls under the rounding of the saved y
_GAMMA_TOL = 1e-6

_RED = (0, 2, 3)        # every axis of an NCHW-shaped tensor but C
_B = (1, -1, 1, 1)      # a channel vector's broadcast shape


def _f32(t):
    """``t`` in float32, or as it is where its dtype is wider (f64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _gamma_degenerate(bn_weight):
    return degenerate_below_tol(bn_weight, _GAMMA_TOL)


def _conv(x, w, cfg):
    stride, sym, pre, dilation, groups, channels_last, act_input = cfg
    if act_input:
        x = torch.relu(x)
    return conv2d_nchw(x, w, None, stride, sym, pre, dilation, groups,
                       channels_last)


def _fwd_impl(x, w, gamma, beta, cfg, eps):
    """(y in z's dtype, batch mean, batch population variance, inv)."""
    z = _conv(x, w, cfg)
    zf = _f32(z)
    mean = zf.mean(dim=_RED)
    var = zf.var(dim=_RED, correction=0)
    inv = torch.rsqrt(var + eps)
    y = (zf - mean.reshape(_B)) * inv.reshape(_B)
    y = y * _f32(gamma).reshape(_B)
    y = y + _f32(beta).reshape(_B)
    return y.to(z.dtype), mean, var, inv


class _FusedConvBNFn(torch.autograd.Function):
    """Returns (y, batch mean, batch var); mean and var are buffers'
    inputs, not differentiable."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, cfg, eps):
        y, mean, var, inv = _fwd_impl(x, w, gamma, beta, cfg, eps)
        # residuals: x and w (the conv's backward), the pre-activation y
        # and per-channel vectors; z and relu(x) are deliberately absent
        ctx.save_for_backward(x, w, gamma, beta, inv, y)
        ctx.cfg = cfg
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, gamma, beta, inv, y = ctx.saved_tensors
        stride, sym, pre, dilation, groups, channels_last, act_input = \
            ctx.cfg
        gf = _f32(gamma)
        live = gf.abs() > _GAMMA_TOL
        gdiv = torch.where(live, gf, 1.0)
        g = _f32(dy)
        xhat = torch.where(live.reshape(_B),
                           (_f32(y) - _f32(beta).reshape(_B))
                           / gdiv.reshape(_B), 0.0)
        m = y.numel() // y.shape[1]
        dbeta = g.sum(dim=_RED)
        dgamma = (g * xhat).sum(dim=_RED)
        coef = (gf * inv).reshape(_B)
        dz = coef * (g - (dbeta / m).reshape(_B)
                     - xhat * (dgamma / m).reshape(_B))
        dz = dz.to(x.dtype)
        xin = torch.relu(x) if act_input else x
        if pre is not None:
            xin = _pad(xin, [pre[2], pre[3], pre[0], pre[1]])
        if channels_last:
            w = w.contiguous(memory_format=torch.channels_last)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dz, xin, w, None, list(stride), list(sym), list(dilation),
            False, [0, 0], groups, [True, True, False])
        if pre is not None:
            dx = dx[:, :, pre[0]:pre[0] + x.shape[2],
                    pre[2]:pre[2] + x.shape[3]]
        if act_input:
            dx = dx.masked_fill(x <= 0, 0)
        return (dx, dw.to(w.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None, None)


def fused_conv_bn(x, weight, bn_weight, bn_bias, running_mean=None,
                  running_var=None, *, training=True, momentum=0.9,
                  epsilon=1e-5, stride=1, padding=0, dilation=1, groups=1,
                  data_format="NCHW", act_input=False):
    """[relu ->] conv2d -> batch_norm as one op whose backward saves one
    activation tensor (module docstring). Returns the PRE-activation BN
    output: apply the output ReLU outside, or fuse it into the next
    layer's ``act_input=True``.

    Training updates the running statistics in place as batch_norm does;
    eval (``training=False``) folds them into a scale and shift after the
    conv. When a gradient is wanted the Function runs, unless gamma is
    degenerate or the fusion policy picks the plain form; otherwise the
    same forward runs under plain autograd."""
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, weight, bn_weight, bn_bias))
    # asked before the amp cast makes a new tensor of the parameter: the
    # verdict is cached on the parameter itself
    fusable = training and wants_grad and not _gamma_degenerate(bn_weight)
    xc = nchw_view(x, data_format)
    stride_t, sym, pre, dil_t = conv_args(xc, weight, stride, padding,
                                          dilation)
    cfg = (stride_t, sym, pre, dil_t, groups, data_format == "NHWC",
           act_input)
    if not training:
        xc, weight, g, b, rm, rv = amp_cast(
            "fused_conv_bn_eval", xc, weight, bn_weight, bn_bias,
            running_mean, running_var)
        z = _conv(xc, weight, cfg)
        inv = torch.rsqrt(_f32(rv) + epsilon)
        scale = _f32(g) * inv
        shift = _f32(b) - scale * _f32(rm)
        # z (bf16 or f32) times the f32 scale computes in f32
        out = z * scale.reshape(_B) + shift.reshape(_B)
        return from_nchw_view(out.to(z.dtype), data_format)
    xc, weight, g, b = amp_cast("fused_conv_bn", xc, weight, bn_weight,
                                bn_bias)

    def plain(xc, weight, g, b):
        return _fwd_impl(xc, weight, g, b, cfg, epsilon)[:3]

    def fused(xc, weight, g, b):
        return _FusedConvBNFn.apply(xc, weight, g, b, cfg, epsilon)

    choice = "unfused"
    if fusable:
        # the probes time y alone: mean and var feed only the buffers
        _, choice = autotune.choose_fused(
            "fused_conv_bn", lambda *a: fused(*a)[0],
            lambda *a: plain(*a)[0], (xc, weight, g, b), module=__name__)
    y, mean, var = (fused if choice == "fused" else plain)(xc, weight, g, b)
    update_running_stats(running_mean, running_var, mean.detach(),
                         var.detach(), y.numel() // y.shape[1], momentum)
    return from_nchw_view(y, data_format)
