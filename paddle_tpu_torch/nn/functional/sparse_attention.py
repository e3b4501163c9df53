"""sparse_attention (port of paddle_tpu/nn/functional/sparse_attention.py).

softmax(Q K^T / sqrt(d)) V restricted to the nonzeros of a CSR pattern
per (batch, head): the offsets and columns are scattered into a dense
boolean mask, masked logits take -1e30, the softmax runs in float32, and
a row with no nonzero entry gives zeros. Entries at positions past a
lane's last offset are padding (lanes may have fewer nonzeros than the
columns tensor holds) and unmask nothing. As in the reference this is
plain tensor algebra, not a kernel; ``key_padding_mask`` and
``attn_mask`` raise there and here.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["sparse_attention"]


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """query/key/value: (batch, heads, seq, head_dim); sparse_csr_offset
    (batch, heads, seq + 1) and sparse_csr_columns (batch, heads, nnz),
    integers."""
    if key_padding_mask is not None:
        raise NotImplementedError(
            "key_padding_mask: use attn_mask with "
            "scaled_dot_product_attention")
    if attn_mask is not None:
        raise NotImplementedError(
            "attn_mask: use scaled_dot_product_attention")
    q, k, v = amp_cast("sparse_attention", query, key, value)
    b, h, s, d = q.shape
    off = sparse_csr_offset.long()
    cols = sparse_csr_columns.long()
    entry = torch.arange(cols.shape[-1], device=q.device).expand(b, h, -1)
    # the row of entry t is r with off[r] <= t < off[r + 1]
    rows = (torch.searchsorted(off, entry.contiguous(), right=True) - 1
            ).clamp(0, s - 1)
    valid = entry < off[..., -1:]
    hits = torch.zeros((b, h, s * s), dtype=torch.int32, device=q.device)
    hits.scatter_add_(2, rows * s + cols, valid.to(torch.int32))
    mask = (hits > 0).reshape(b, h, s, s)
    logits = (q @ k.transpose(-1, -2)) * (1.0 / d ** 0.5)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    probs = torch.where(mask.any(-1, keepdim=True), probs, 0.0)
    return probs.to(q.dtype) @ v
