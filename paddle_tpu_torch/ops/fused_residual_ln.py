"""Fused residual add -> LayerNorm, forward.

Port of the forward of paddle_tpu/ops/fused_residual_ln.py (``_fwd_impl``):
z = x + y in the stream dtype, statistics in f32, the normalized output
cast to z's dtype, and optionally z itself (the carried residual stream of
a pre-LN decoder). The reference's custom backward, which never saves z,
comes with the training slice as a torch.autograd.Function.
"""
from __future__ import annotations

import torch

__all__ = ["fused_residual_ln"]


def fused_residual_ln(x, y, weight, bias, epsilon=1e-5,
                      return_residual=False):
    """layer_norm(x + y); with return_residual=True returns (z, out)."""
    z = x + y
    zf = z.float()
    mean = zf.mean(dim=-1, keepdim=True)
    var = zf.var(dim=-1, correction=0, keepdim=True)
    xhat = (zf - mean) * torch.rsqrt(var + epsilon)
    out = (xhat * weight.float() + bias.float()).to(z.dtype)
    if return_residual:
        return z, out
    return out
