"""scaled_dot_product_attention: the math path and the flash kernel.

Port of paddle_tpu/ops/attention.py. Two paths behind one entry point:
the math path (logits, offset-aware causal mask, f32 softmax, optional
mask and dropout) and flash attention (ops/cuda/), which the selection
rule takes when the query lies on CUDA, there is no mask and no dropout,
the sequence is at least 256 long and the kernel's shape contract holds.
The reference's measured fusion policy is not ported: on CUDA the kernel
is taken whenever the rule holds, as the reference's checked-in table
keeps flash for every benched signature.

When gradients are wanted, flash attention goes through
``_FlashAttentionFn``, the counterpart of the reference's
``_flash_attention_diff``: its forward runs B1 and saves (q, k, v, out,
lse), its backward runs B2 and B3. Under no_grad/inference_mode the
forward is called directly and saves nothing.

Under ``amp.auto_cast`` the inputs are cast as the reference casts its
ops ``flash_attention`` (the kernel path) and ``sdpa`` (the math path),
both white-listed: to bf16 at O1, so the tensor-core kernels run.
"""
from __future__ import annotations

import math

import torch

from ..amp.auto_cast import amp_cast
from ..core.random import uniform
from .cuda.flash_attention import (flash_attention, flash_attention_bwd,
                                   flash_attention_fwd_for_grad, supports)

__all__ = ["scaled_dot_product_attention", "flash_selected"]

NEG_BIG = -1e30


class _FlashAttentionFn(torch.autograd.Function):
    """Flash attention forward (B1) and backward (B2, B3); the FlashAttention-2
    recompute scheme, so neither direction forms the S x S matrix in device
    memory. The backward's D = rowsum(dO * O) reads the unrounded f32 O that
    B1 writes beside a bf16 O (the reference reads its bf16 O): O's rounding
    would otherwise enter a whole row of dS with one sign."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse, out32 = flash_attention_fwd_for_grad(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            # an expanded cotangent (e.g. of a sum) has stride 0 on D; the
            # kernels read any batch/sequence/head strides but a unit D
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def _math_attention(q, k, v, mask, scale, is_causal, dropout_p, generator):
    # q,k,v: (B, S, H, D) paddle layout -> compute in (B, H, S, D)
    q = q.transpose(1, 2)
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if is_causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        # query rows sit at the END of the key timeline (cached decode)
        causal = torch.ones((s_q, s_k), dtype=torch.bool,
                            device=logits.device).tril(diagonal=s_k - s_q)
        logits = torch.where(causal, logits, NEG_BIG)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, NEG_BIG)
        else:
            logits = logits + mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_p > 0.0:
        keep = uniform(probs.shape, generator, probs.device) < 1.0 - dropout_p
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            0.0).to(probs.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out.transpose(1, 2)


def _kernel_available(t):
    """The flash kernel runs where the tensor lies on a CUDA device."""
    return t.is_cuda


def flash_selected(query, key, attn_mask=None, dropout_p=0.0):
    """The auto-selection rule (reference lines 55-63)."""
    return (_kernel_available(query) and attn_mask is None
            and dropout_p == 0.0 and query.shape[1] >= 256
            and supports(tuple(query.shape), tuple(key.shape)))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, use_kernel=None, scale=None,
                                 generator=None):
    """query/key/value: (B, S, H, D). ``use_kernel`` (the reference's
    ``use_pallas``): None selects by the rule above, False forces the math
    path, True forces flash attention (which runs its plain versions on a
    CPU tensor)."""
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    if not training:
        dropout_p = 0.0
    if use_kernel is None:
        use_kernel = flash_selected(query, key, attn_mask, dropout_p)
    elif use_kernel and (attn_mask is not None or dropout_p > 0.0):
        raise ValueError(
            "use_kernel=True is incompatible with attn_mask/dropout_p: the "
            "flash kernel computes plain (optionally causal) attention")
    if use_kernel:
        query, key, value = amp_cast("flash_attention", query, key, value)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (query, key, value)):
            return _FlashAttentionFn.apply(query, key, value, is_causal,
                                           scale)
        return flash_attention(query, key, value, causal=is_causal,
                               scale=scale)
    query, key, value, attn_mask = amp_cast("sdpa", query, key, value,
                                            attn_mask)
    return _math_attention(query, key, value, attn_mask, scale, is_causal,
                           dropout_p, generator)
