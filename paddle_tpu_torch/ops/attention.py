"""scaled_dot_product_attention: the math path and the flash kernel.

Port of paddle_tpu/ops/attention.py. Two paths behind one entry point:
the math path (logits, offset-aware causal mask, f32 softmax, optional
mask and dropout) and flash attention (ops/cuda/), which the selection
rule takes when the query lies on CUDA, there is no mask and no dropout,
the sequence is at least 256 long and the kernel's shape contract holds.
Where the rule holds, the measured fusion policy has the last word, as
in the reference (``_flash_wins``): flash attention is the fused form
and the math path the unfused one; ``FLAGS_fusion_policy=never`` takes
the math path, ``auto`` the form the card's measured table names (it
keeps flash: ``ops/autotune.py``), so on a CUDA tensor the kernels run
and a kernel that fails to build or launch raises.

When gradients are wanted, flash attention goes through
``_FlashAttentionFn``, the counterpart of the reference's
``_flash_attention_diff``: its forward runs B1 and saves (q, k, v, out,
lse), its backward runs B2 and B3. Under no_grad/inference_mode the
forward is called directly and saves nothing.

``attention_block_fwd`` and ``attention_block_bwd`` are one (query
block, key block) pair of a blockwise attention, for ring attention
(distributed/fleet/sequence_parallel.py): the forward returns the f32 O
and LSE for the caller to merge, the backward takes the merged LSE and
D. They take flash attention (B1, then B2 and B3) by the rule above,
fusion policy included, and the math block otherwise; ``block_paths``
counts which path each call took.

Under ``amp.auto_cast`` the inputs are cast as the reference casts its
ops ``flash_attention`` (the kernel path) and ``sdpa`` (the math path),
both white-listed: to bf16 at O1, so the tensor-core kernels run.
"""
from __future__ import annotations

import math

import torch

from ..amp.auto_cast import amp_cast
from ..core.random import uniform
from . import autotune
from .cuda.flash_attention import (SOURCES, _bwd_plain, _fwd_plain,
                                   flash_attention, flash_attention_block_bwd,
                                   flash_attention_block_fwd,
                                   flash_attention_bwd,
                                   flash_attention_fwd_for_grad, supports)

__all__ = ["scaled_dot_product_attention", "flash_selected",
           "attention_block_fwd", "attention_block_bwd", "block_paths"]

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


def _flash(q, k, v, causal, scale):
    """Flash attention: through ``_FlashAttentionFn`` when a gradient is
    wanted, else the forward alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttentionFn.apply(q, k, v, causal, scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)


def _flash_wins(q, k, v, causal, scale):
    """The measured fusion policy's decision for flash attention (the
    reference's lines 60-75): the kernels against the math path for this
    (dtype, direction), or, when searched, this (shape bucket, dtype,
    direction) signature, versioned by the kernels' CUDA sources."""
    _, choice = autotune.choose_fused(
        "flash_attention",
        lambda q, k, v: _flash(q, k, v, causal, scale),
        lambda q, k, v: _math_attention(q, k, v, None, scale, causal, 0.0,
                                        None),
        (q, k, v), module="paddle_tpu_torch.ops.attention",
        sources=SOURCES)
    return choice == "fused"


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, use_kernel=None, scale=None,
                                 generator=None):
    """query/key/value: (B, S, H, D). ``use_kernel`` (the reference's
    ``use_pallas``): None selects by the rule above, False forces the math
    path, True forces flash attention (which runs its plain versions on a
    CPU tensor). Where the rule selects flash, the fusion policy decides
    (module docstring)."""
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    if not training:
        dropout_p = 0.0
    if use_kernel is None:
        use_kernel = flash_selected(query, key, attn_mask, dropout_p)
        if use_kernel:
            query, key, value = amp_cast("flash_attention", query, key,
                                         value)
            pol = autotune.fusion_policy()
            use_kernel = pol == "always" or (
                pol == "auto"
                and _flash_wins(query, key, value, is_causal, scale))
    elif use_kernel and (attn_mask is not None or dropout_p > 0.0):
        raise ValueError(
            "use_kernel=True is incompatible with attn_mask/dropout_p: the "
            "flash kernel computes plain (optionally causal) attention")
    if use_kernel:
        query, key, value = amp_cast("flash_attention", query, key, value)
        return _flash(query, key, value, is_causal, scale)
    query, key, value, attn_mask = amp_cast("sdpa", query, key, value,
                                            attn_mask)
    return _math_attention(query, key, value, attn_mask, scale, is_causal,
                           dropout_p, generator)


# which path each block call took: "kernel" (B1, or B2 and B3) or "math"
block_paths = {"kernel": 0, "math": 0}


def _block_kernel(q, k):
    """The selection rule of scaled_dot_product_attention for one block
    pair (no mask, no dropout): flash attention where it holds and the
    fusion policy does not say never."""
    if not flash_selected(q, k):
        return False
    return autotune.fusion_policy() != "never"


def attention_block_fwd(q, k, v, causal, scale):
    """One block pair's (out, lse): out (B, S, H, D) in f32 (the math
    dtype), lse (B, H, S), unmerged."""
    if _block_kernel(q, k):
        block_paths["kernel"] += 1
        return flash_attention_block_fwd(q, k, v, causal, scale)
    block_paths["math"] += 1
    return _fwd_plain(q, k, v, causal, scale)


def attention_block_bwd(q, k, v, do, lse, delta, causal, scale):
    """One block pair's (dq, dk, dv) under the merged ``lse`` and ``delta``
    (B, H, S) f32; the kernels' in q's dtype, the math block's in f32."""
    if _block_kernel(q, k):
        block_paths["kernel"] += 1
        return flash_attention_block_bwd(q, k, v, do, lse, delta, causal,
                                         scale)
    block_paths["math"] += 1
    return _bwd_plain(q, k, v, do, lse, delta, causal, scale)
