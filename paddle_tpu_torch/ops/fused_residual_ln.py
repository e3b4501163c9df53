"""Fused residual add -> LayerNorm, with the backward that never saves z.

Port of paddle_tpu/ops/fused_residual_ln.py. The forward (``_fwd_impl``):
z = x + y in the stream dtype, statistics in f32, the normalized output
cast to z's dtype, and optionally z itself (the carried residual stream of
a pre-LN decoder). The backward is a torch.autograd.Function that saves
(weight, bias, out, rstd) and never z, and rebuilds the normalized input
from the output:

    x_hat = (out - bias) / weight          (where |weight| > 1e-6, else 0)
    dz    = rstd * (dx_hat - mean(dx_hat) - x_hat * mean(dx_hat * x_hat))

Both residual inputs receive dz (plus the incoming dz when z is returned);
dw and db are in the weight's dtype. A weight with a channel inside the
1e-6 band (checked once per parameter, ``_param_guard``) runs plain
autograd through the identical forward instead; otherwise, when a
gradient is wanted, the measured fusion policy (``ops/autotune.py``,
``FLAGS_fusion_policy``) picks the Function or plain autograd per call,
as the reference's ``choose_fused`` does, the degenerate-weight route
first. Without a gradient the two forms are one forward. ``fuse_enabled()`` is the
reference's PADDLE_TPU_FUSED_RESIDUAL_LN escape hatch, read by GPTBlock
and by ``post_residual_ln``, the post-LN residual write of the
transformer layers (nn/layer/transformer.py).
Under ``amp.auto_cast`` the op is black-listed like layer_norm: its
inputs are promoted to float32, and the residual stream z it returns
keeps x's dtype from before the promotion, as the reference's
``stream_dtype`` does.
"""
from __future__ import annotations

import os

import torch

from ..amp.auto_cast import amp_cast
from . import autotune
from ._param_guard import degenerate_below_tol

__all__ = ["fused_residual_ln", "fuse_enabled", "post_residual_ln"]

_W_TOL = 1e-6


def fuse_enabled():
    """PADDLE_TPU_FUSED_RESIDUAL_LN=0 routes the op's hot-path wirings
    (GPTBlock, the post-LN transformer layers) through the plain residual
    + LayerNorm composition."""
    return os.environ.get("PADDLE_TPU_FUSED_RESIDUAL_LN", "1") == "1"


def post_residual_ln(residual, sub, norm):
    """Post-LN residual write: ``norm(residual + sub)`` through the fused
    op, or the plain composition when the norm has no affine parameters
    or the fusion is off (``fuse_enabled``)."""
    if norm.weight is None or norm.bias is None or not fuse_enabled():
        return norm(residual + sub)
    return fused_residual_ln(residual, sub, norm.weight, norm.bias,
                             epsilon=norm._epsilon)


def _fwd_impl(x, y, w, b, eps):
    """The one forward, shared by the Function and the plain route:
    (z, out, rstd)."""
    z = x + y
    zf = z.float()
    mean = zf.mean(dim=-1, keepdim=True)
    var = zf.var(dim=-1, correction=0, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = ((zf - mean) * rstd * w.float() + b.float()).to(z.dtype)
    return z, out, rstd


class _FusedResidualLNFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, w, b, eps, return_residual):
        z, out, rstd = _fwd_impl(x, y, w, b, eps)
        ctx.save_for_backward(w, b, out, rstd)
        ctx.return_residual = return_residual
        return (z, out) if return_residual else out

    @staticmethod
    def backward(ctx, *cts):
        w, b, out, rstd = ctx.saved_tensors
        dz_in, dout = cts if ctx.return_residual else (None, cts[0])
        wf = w.float()
        live = wf.abs() > _W_TOL
        wdiv = torch.where(live, wf, 1.0)
        xhat = torch.where(live, (out.float() - b.float()) / wdiv, 0.0)
        g = dout.float()
        dxhat = g * wf
        m1 = dxhat.mean(dim=-1, keepdim=True)
        m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
        dz = rstd * (dxhat - m1 - xhat * m2)
        if dz_in is not None:
            dz = dz + dz_in.float()
        red = tuple(range(out.dim() - 1))
        dw = (g * xhat).sum(dim=red).to(w.dtype)
        db = g.sum(dim=red).to(b.dtype)
        dz = dz.to(out.dtype)
        return dz, dz, dw, db, None, None


def fused_residual_ln(x, y, weight, bias, epsilon=1e-5,
                      return_residual=False):
    """layer_norm(x + y); with return_residual=True returns (z, out).

    When a gradient is wanted this runs the no-saved-z Function, unless
    the weight is degenerate or the fusion policy picks the plain form;
    otherwise (no_grad, inference_mode, a degenerate weight, or the plain
    form) it runs the same forward under plain autograd."""
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, y, weight, bias))
    # the guard's verdict is cached on the parameter itself, so it is asked
    # before the amp cast makes a new tensor of it
    fusable = wants_grad and not degenerate_below_tol(weight, _W_TOL)
    stream_dtype = x.dtype
    x, y, weight, bias = amp_cast("fused_residual_ln", x, y, weight, bias)

    def plain(x, y, weight, bias):
        z, out, _ = _fwd_impl(x, y, weight, bias, epsilon)
        return (z, out) if return_residual else out

    def fused(x, y, weight, bias):
        return _FusedResidualLNFn.apply(x, y, weight, bias, epsilon,
                                        return_residual)

    fn = autotune.choose_fused(
        "fused_residual_ln", fused, plain, (x, y, weight, bias),
        module=__name__)[0] if fusable else plain
    outs = fn(x, y, weight, bias)
    if return_residual:
        return outs[0].to(stream_dtype), outs[1]
    return outs
