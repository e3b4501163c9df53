"""Sequence parallelism: ring attention over the "sep" mesh axis (port of
paddle_tpu/distributed/fleet/sequence_parallel.py).

Each rank of the sep group holds a contiguous slice of the sequence,
``(B, S_local, H, D)`` of q, k and v, and gets its slice of the output
back. K and V travel round the ring: at step i rank r holds the shard
that started on rank (r - i) mod n, as in the reference, and attends its
queries to it. The reference writes the step as a ``shard_map`` over a
``lax.scan`` whose blocks merge by an online softmax and whose backward
is JAX's transpose of the scan and ``ppermute``; the port runs one
process per rank, so the ring is written out:

- forward: per held shard j one block of flash attention (B1 through
  ``ops.attention.attention_block_fwd``), causal on the diagonal (j = r),
  full below it (j < r), skipped above it under ``is_causal`` (all its
  scores are masked, so it adds nothing); without ``is_causal`` every
  block is full. The blocks' f32 outputs merge by their LSEs; the output
  is cast to q's dtype at the end.
- backward (``_RingAttentionFn``): D = rowsum(dO * O) from the merged
  f32 O, then per block B2 and B3 under the merged LSE and D with the
  same causal flags; dQ accumulates here, and the dK and dV accumulators
  travel round the ring with K and V, so that after n steps each is home.

Sends and receives are asynchronous (``collective.Exchange``) and are
started before a step's block, so the transfer overlaps it. The ring
runs eagerly: gloo's collectives cannot be captured in a CUDA graph,
where the reference caches a compiled program per configuration;
``compiled=True`` warns, and ``stats()`` says so. On a sep axis of
degree 1 ``ring_attention`` is the port's scaled_dot_product_attention,
as in the reference.
"""
from __future__ import annotations

import math
import warnings

import torch

from ..mesh import axis_degree, get_mesh

__all__ = ["ring_attention", "split_sequence", "gather_sequence", "stats",
           "reset_stats"]

EAGER_REASON = ("the ring's sends and receives go through the process "
                "group (gloo stages them through the host), which a CUDA "
                "graph cannot capture")

_STATS = {"calls": 0, "backwards": 0, "blocks": 0, "skipped_blocks": 0,
          "p2p_bytes": 0, "p2p_wait_s": 0.0}


def stats():
    """The ring's counters since the last reset: calls, backwards,
    blocks run and skipped (forward and backward), point-to-point bytes
    this rank sent and the seconds it waited for them, and why it runs
    eagerly."""
    return {**_STATS, "compiled": False, "eager_reason": EAGER_REASON}


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0.0 if k == "p2p_wait_s" else 0


def _group(axis):
    return get_mesh().group(axis)


def _t(x):
    """(B, H, S) -> (B, S, H, 1), to scale (B, S, H, D) rows."""
    return x.transpose(1, 2).unsqueeze(-1)


def _rotate(group, tensors):
    """Send ``tensors`` to the next rank of the ring and receive the
    previous rank's, all asynchronously; returns what arrived."""
    from ..collective import Exchange
    n, r = group.nranks, group.rank
    ex = Exchange(group)
    for t in tensors:
        ex.recv(t.shape, t.dtype, t.device, (r - 1) % n)
    for t in tensors:
        ex.send(t, (r + 1) % n)
    return ex


def _finish(ex):
    got = ex.wait()
    _STATS["p2p_bytes"] += ex.bytes
    _STATS["p2p_wait_s"] += ex.wait_s
    return got


def merge_blocks(out, lse, o_i, l_i):
    """Two blocks' attention outputs (B, S, H, D) f32 over disjoint keys
    merged by their row LSEs (B, H, S): the output and LSE over both
    (``out`` None: the second alone)."""
    if out is None:
        return o_i, l_i
    new = torch.logaddexp(lse, l_i)
    return (out * _t(torch.exp(lse - new)) + o_i * _t(torch.exp(l_i - new)),
            new)


def _block_causal(causal, j, r):
    """None: skip the block; else its causal flag."""
    if not causal:
        return False
    if j > r:
        return None
    return j == r


def _ring_forward(q, k, v, causal, scale, group):
    """(out f32, lse) of this rank's queries against every shard."""
    from ...ops.attention import attention_block_fwd
    n, r = group.nranks, group.rank
    out = lse = None
    k_cur, v_cur = k, v
    for i in range(n):
        ex = _rotate(group, (k_cur, v_cur)) if i < n - 1 else None
        j = (r - i) % n
        flag = _block_causal(causal, j, r)
        if flag is None:
            _STATS["skipped_blocks"] += 1
        else:
            _STATS["blocks"] += 1
            o_i, l_i = attention_block_fwd(q, k_cur, v_cur, flag, scale)
            out, lse = merge_blocks(out, lse, o_i.float(), l_i.float())
        if ex is not None:
            k_cur, v_cur = _finish(ex)
    return out, lse


def _ring_backward(q, k, v, out, lse, dout, causal, scale, group):
    from ...ops.attention import attention_block_bwd
    from ...ops.cuda.flash_attention import bwd_delta
    n, r = group.nranks, group.rank
    delta = bwd_delta(out, dout)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    k_cur, v_cur = k, v
    for i in range(n):
        j = (r - i) % n
        flag = _block_causal(causal, j, r)
        _STATS["skipped_blocks" if flag is None else "blocks"] += 1
        if flag is not None:
            g_q, g_k, g_v = attention_block_bwd(q, k_cur, v_cur, dout, lse,
                                                delta, flag, scale)
            dq += g_q
            dk += g_k
            dv += g_v
        # the accumulators go on with their shard; K and V need no last hop
        moving = (k_cur, v_cur, dk, dv) if i < n - 1 else (dk, dv)
        got = _finish(_rotate(group, moving))
        if i < n - 1:
            k_cur, v_cur, dk, dv = got
        else:
            dk, dv = got
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, group):
        out, lse = _ring_forward(q, k, v, causal, scale, group)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.group = causal, scale, group
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        _STATS["backwards"] += 1
        dq, dk, dv = _ring_backward(q, k, v, out, lse, dout.contiguous(),
                                    ctx.causal, ctx.scale, ctx.group)
        return dq, dk, dv, None, None, None


def ring_attention(query, key, value, is_causal=True, axis="sep", scale=None,
                   compiled=None):
    """(B, S_local, H, D) shards in, the same out: this rank's slice of
    attention over the whole sequence, the sequence split in order over
    the ``axis`` ranks. On an axis of degree <= 1 the port's
    scaled_dot_product_attention. ``compiled=True`` warns: the ring runs
    eagerly (module docstring)."""
    if axis_degree(axis) <= 1:
        from ...ops.attention import scaled_dot_product_attention
        return scaled_dot_product_attention(query, key, value,
                                            is_causal=is_causal, scale=scale)
    if compiled:
        warnings.warn(f"ring_attention runs eagerly: {EAGER_REASON}",
                      UserWarning, stacklevel=2)
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    group = _group(axis)
    _STATS["calls"] += 1
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (query, key, value)):
        return _RingAttentionFn.apply(query, key, value, bool(is_causal),
                                      float(scale), group)
    out, _ = _ring_forward(query, key, value, bool(is_causal), float(scale),
                           group)
    return out.to(query.dtype)


def split_sequence(x, axis="sep", seq_dim=1):
    """This rank's contiguous slice of ``x`` along ``seq_dim`` (the
    sequence split in order over the ``axis`` ranks); ``x`` whole on an
    axis of degree <= 1."""
    n = axis_degree(axis)
    if n <= 1:
        return x
    size = x.shape[seq_dim]
    if size % n:
        raise ValueError(f"sequence length {size} not divisible by the "
                         f"{n} '{axis}' ranks")
    r = _group(axis).rank
    return x.narrow(seq_dim, r * (size // n), size // n)


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq_dim, group):
        from ..collective import all_gather
        ctx.seq_dim, ctx.group = seq_dim, group
        parts = []
        all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=seq_dim)

    @staticmethod
    def backward(ctx, grad):
        # the gathered value is one logical tensor on every rank: this
        # rank's slice of its cotangent
        n = ctx.group.nranks
        size = grad.shape[ctx.seq_dim] // n
        return grad.narrow(ctx.seq_dim, ctx.group.rank * size,
                           size).contiguous(), None, None


def gather_sequence(x, axis="sep", seq_dim=1):
    """The whole sequence from every rank's slice (all-gathered over the
    ``axis`` group, in order); ``x`` itself on an axis of degree <= 1."""
    if axis_degree(axis) <= 1:
        return x
    return _GatherSequence.apply(x, seq_dim, _group(axis))
