"""Fused transformer feed-forward, with the backward that recomputes the
activation.

Port of paddle_tpu/ops/fused_ffn.py: y = act(x @ w1 + b1) @ w2 + b2 with
paddle's (in, out) weights. The two matmuls stay torch.matmul, as the
reference leaves them to XLA outside any kernel. The backward is a
torch.autograd.Function that saves (x, w1, w2, h), h the pre-activation,
and recomputes a = act(h) instead of saving it (a is the widest tensor of
the block). The activation derivatives are the exact ones of the
reference's ``_act_fns``. The reference lists the op in neither amp list,
so under ``amp.auto_cast`` only O2 casts its inputs (to the low dtype).
"""
from __future__ import annotations

import math

import torch

from ..amp.auto_cast import amp_cast

__all__ = ["fused_ffn"]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def _gelu_grad(h):
    # d/dh [h * Phi(h)] = Phi(h) + h * phi(h)
    phi = torch.exp(-0.5 * h * h) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0)))
    return cdf + h * phi


def _gelu_tanh_grad(h):
    u = _SQRT_2_OVER_PI * (h + 0.044715 * h ** 3)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3 * 0.044715 * h * h)
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du


# activation -> (f, df)
_ACTIVATIONS = {
    "gelu": (lambda h: torch.nn.functional.gelu(h, approximate="none"),
             _gelu_grad),
    "gelu_tanh": (lambda h: torch.nn.functional.gelu(h, approximate="tanh"),
                  _gelu_tanh_grad),
    "relu": (torch.relu, lambda h: (h > 0).to(h.dtype)),
}


class _FusedFFNFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation):
        f, _ = _ACTIVATIONS[activation]
        h = torch.matmul(x, w1) + b1
        ctx.save_for_backward(x, w1, w2, h)
        ctx.activation = activation
        return torch.matmul(f(h), w2) + b2

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, h = ctx.saved_tensors
        f, df = _ACTIVATIONS[ctx.activation]
        a = f(h)                                   # recomputed
        red = tuple(range(dy.dim() - 1))
        db2 = dy.sum(dim=red)
        # dW = a^T dy over the flattened tokens
        dw2 = a.reshape(-1, a.shape[-1]).t() @ dy.reshape(-1, dy.shape[-1])
        da = torch.matmul(dy, w2.t())
        dh = (da * df(h)).to(h.dtype)
        db1 = dh.sum(dim=red)
        dw1 = x.reshape(-1, x.shape[-1]).t() @ dh.reshape(-1, dh.shape[-1])
        dx = torch.matmul(dh, w1.t())
        return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2, None


def fused_ffn(x, w1, b1, w2, b2, activation="gelu"):
    """x: (..., d_model); w1: (d_model, d_ff); w2: (d_ff, d_model);
    activation: gelu | gelu_tanh | relu. When a gradient is wanted the
    Function above runs; otherwise the same forward runs plainly."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")
    x, w1, b1, w2, b2 = amp_cast("fused_ffn", x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _FusedFFNFn.apply(x, w1, b1, w2, b2, activation)
    f, _ = _ACTIVATIONS[activation]
    return torch.matmul(f(torch.matmul(x, w1) + b1), w2) + b2
