"""Expert-parallel token exchange (port of paddle_tpu/distributed/utils.py).

``dispatch_tokens`` puts each token into a fixed-capacity per-expert
buffer (E, C, d) at its slot in its expert's queue, and
``combine_tokens`` gathers the experts' outputs back to token order: the
GShard/Switch formulation the reference writes as one-hot einsums
(O(N·E·C·d)). The port scatters and gathers by index, which gives the
same values (each one-hot row has one nonzero): ``combine`` is each
token's slot in the flattened buffer, e·C + its position, or -1 where its
expert was full, not the reference's (N, E, C) one-hot matrix.

``expert_dispatch`` and ``expert_combine`` are the exchange of
``incubate.MoELayer`` over expert-parallel ranks: the owner of expert e
is member ``e // (E / n)`` of the group. Each rank sends each owner a
fixed-capacity block (its tokens at their global slots, zeros
elsewhere) and the owner sums the blocks over the senders, which is
exact since the ranks' slots are disjoint; the combine sends each
owner's outputs back to every rank. Each is an autograd Function whose
backward is the other's exchange. ``exchange_stats`` counts the bytes a
rank sent (an all-to-all's; gloo's ``alltoall`` gathers every member's
chunks, so it moves n times that, ``moved_bytes``) and the seconds it
waited.

``global_scatter`` and ``global_gather`` are upstream Paddle's
variable-count exchange (global_scatter_op.cc): ``local_count`` and
``global_count`` are laid out [rank][local expert]; the input of
``global_scatter`` is grouped by (destination rank, expert), and its
output by (local expert, source rank). The reference's are the identity
after the count check, which is right for its one controller; a rank of
the port has real peers, so at world size > 1 the port exchanges (ROADMAP
C-ref-26). At world size 1 both are the identity after the count check.
"""
from __future__ import annotations

import time

import torch

from .collective import ReduceOp, all_gather, all_reduce, alltoall
from .env import get_world_size

__all__ = ["global_scatter", "global_gather", "dispatch_tokens",
           "combine_tokens", "expert_dispatch", "expert_combine",
           "exchange_stats", "reset_exchange_stats"]

_STATS = {"exchanges": 0, "bytes": 0, "moved_bytes": 0, "wait_s": 0.0}


def exchange_stats():
    """The expert exchange's all-to-alls on this rank since the last
    reset: their count, the bytes this rank sent, the bytes gloo moved
    for it and the seconds it waited."""
    return dict(_STATS)


def reset_exchange_stats():
    for k in _STATS:
        _STATS[k] = 0 if k != "wait_s" else 0.0


def _slots(expert_idx, num_experts, capacity, offset=None):
    """Each token's position in its expert's queue (its order among the
    tokens routed there, after ``offset[e]`` tokens ahead of this batch)
    and whether it fits."""
    idx = expert_idx.long()
    onehot = torch.nn.functional.one_hot(idx, num_experts)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(1) - 1
    if offset is not None:
        pos = pos + offset.to(pos.device)[idx]
    keep = pos < capacity
    slot = torch.where(keep, idx * capacity + pos.clamp_max(capacity - 1),
                       torch.full_like(pos, -1))
    return slot, keep


def dispatch_tokens(x, expert_idx, num_experts, capacity, offset=None):
    """x: (N, d) tokens; expert_idx: (N,) their experts. Returns (buffer
    (num_experts, capacity, d), combine (N,) each token's slot e·C + its
    position or -1 where dropped, keep (N,)). A token past its expert's
    capacity is dropped (Switch semantics). ``offset`` (E,): the tokens
    of each expert that come before this batch in the global order (the
    ranks before this one)."""
    n, d = x.shape
    slot, keep = _slots(expert_idx, num_experts, capacity, offset)
    rows = num_experts * capacity
    # dropped tokens land in one extra row that is cut off
    target = torch.where(keep, slot, torch.full_like(slot, rows))
    buf = x.new_zeros(rows + 1, d).index_add(0, target, x)
    return buf[:rows].reshape(num_experts, capacity, d), slot, keep


def combine_tokens(expert_out, combine):
    """Expert outputs back to token order: (E, C, d) and each token's slot
    (dispatch_tokens' ``combine``) to (N, d); a dropped token gets 0."""
    e, c, d = expert_out.shape
    flat = torch.cat([expert_out.reshape(e * c, d),
                      expert_out.new_zeros(1, d)])
    rows = torch.where(combine < 0, torch.full_like(combine, e * c),
                       combine)
    return flat.index_select(0, rows)


# -- the expert-parallel exchange ---------------------------------------------

def _exchange(blocks, group):
    """Block i of this rank to member i; returns the blocks received, in
    member order (collective.alltoall)."""
    n = blocks.shape[0]
    t0 = time.perf_counter()
    got = alltoall(blocks.contiguous(), group=group)
    _STATS["wait_s"] += time.perf_counter() - t0
    nbytes = blocks.numel() * blocks.element_size()
    _STATS["exchanges"] += 1
    _STATS["bytes"] += nbytes
    _STATS["moved_bytes"] += nbytes * n
    return got


def _to_owners(buf, group):
    n = group.nranks
    e, c, d = buf.shape
    return _exchange(buf.reshape(n, e // n, c, d), group).sum(0)


def _to_everyone(local, group):
    n = group.nranks
    el, c, d = local.shape
    return _exchange(local.expand(n, el, c, d), group).reshape(n * el, c, d)


class _Dispatch(torch.autograd.Function):
    """(E, C, d) on every rank -> this owner's (E/n, C, d), summed over
    the senders; backward: the owner's gradient back to every sender."""

    @staticmethod
    def forward(ctx, buf, group):
        ctx.group = group
        return _to_owners(buf, group)

    @staticmethod
    def backward(ctx, grad):
        return _to_everyone(grad, ctx.group), None


class _Combine(torch.autograd.Function):
    """This owner's (E/n, C, d) -> every owner's, (E, C, d) on every
    rank; backward: each rank's gradient of an owner's block summed on
    the owner."""

    @staticmethod
    def forward(ctx, local, group):
        ctx.group = group
        return _to_everyone(local, group)

    @staticmethod
    def backward(ctx, grad):
        return _to_owners(grad, ctx.group), None


def expert_dispatch(buf, group):
    """The dispatch all-to-all of expert parallelism (module docstring)."""
    return _Dispatch.apply(buf, group)


def expert_combine(local, group):
    """The combine all-to-all of expert parallelism (module docstring)."""
    return _Combine.apply(local, group)


# -- upstream's variable-count exchange ---------------------------------------

def _counts(c):
    return [int(v) for v in torch.as_tensor(c).reshape(-1).tolist()]


def _check_counts(x, local_count):
    total = sum(_counts(local_count))
    if total != x.shape[0]:
        raise ValueError(
            f"global_scatter/gather: sum(local_count)={total} must equal the "
            f"token count {x.shape[0]}")


def _gather_all(x, counts, group):
    """Every member's rows (padded to the longest) and counts."""
    n_rows = all_gather([], torch.tensor([x.shape[0]], device=x.device),
                        group=group)
    longest = max(int(t) for t in n_rows)
    pad = x.new_zeros((longest - x.shape[0],) + tuple(x.shape[1:]))
    xs = all_gather([], torch.cat([x.detach(), pad]), group=group)
    cs = all_gather([], torch.tensor(counts, device=x.device), group=group)
    return xs, [_counts(c) for c in cs]


def _starts(sizes):
    out, acc = [], 0
    for s in sizes:
        out.append(acc)
        acc += s
    return out


def _scatter_rows(x, local, glob, group):
    """global_scatter_op.cc at world size n: rank j's rows for (me, expert
    i), for i in my experts, then j in ranks."""
    n, me = group.nranks, group.rank
    n_expert = len(local) // n
    xs, locals_ = _gather_all(x, local, group)
    parts = []
    for i in range(n_expert):
        for j in range(n):
            idx = me * n_expert + i
            start = _starts(locals_[j])[idx]
            rows = locals_[j][idx]
            if rows != glob[j * n_expert + i]:
                raise ValueError(
                    f"global_scatter: rank {j} sends {rows} tokens for "
                    f"expert {i} of rank {me}, global_count says "
                    f"{glob[j * n_expert + i]}")
            parts.append(xs[j][start:start + rows])
    return torch.cat(parts) if parts else x[:0]


def _gather_rows(x, local, glob, group):
    """global_gather_op.cc at world size n: the inverse of _scatter_rows."""
    n, me = group.nranks, group.rank
    n_expert = len(local) // n
    xs, globs = _gather_all(x, glob, group)
    parts = []
    for j in range(n):
        for i in range(n_expert):
            # rank j holds my rows for its expert i after the rows of its
            # experts before i (every source) and of sources before me
            order = [(ii, jj) for ii in range(n_expert) for jj in range(n)]
            sizes = [globs[j][jj * n_expert + ii] for ii, jj in order]
            k = order.index((i, me))
            start = _starts(sizes)[k]
            rows = sizes[k]
            if rows != local[j * n_expert + i]:
                raise ValueError(
                    f"global_gather: rank {j} returns {rows} tokens of its "
                    f"expert {i}, local_count says "
                    f"{local[j * n_expert + i]}")
            parts.append(xs[j][start:start + rows])
    return torch.cat(parts) if parts else x[:0]


class _GlobalExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, local, glob, group, scatter):
        ctx.args = (local, glob, group, scatter)
        fn = _scatter_rows if scatter else _gather_rows
        return fn(x, local, glob, group).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        local, glob, group, scatter = ctx.args
        fn = _gather_rows if scatter else _scatter_rows
        return fn(grad.contiguous(), local, glob, group).to(grad.device), \
            None, None, None, None


def _group(group):
    from .collective import _default_group
    return group or _default_group()


def global_scatter(x, local_count, global_count, group=None):
    """upstream distributed/utils.py:57: send each rank's tokens for
    expert (j, i), contiguous in ``x`` in that order, to rank j; receive
    ``global_count`` tokens, grouped by local expert, then source rank.
    At world size 1 the identity after the count check (module
    docstring; ROADMAP C-ref-26)."""
    g = _group(group)
    if get_world_size() <= 1 or g.nranks <= 1:
        _check_counts(x, local_count)
        return x.view_as(x)
    local, glob = _counts(local_count), _counts(global_count)
    _check_counts(x, local)
    return _GlobalExchange.apply(x, local, glob, g, True)


def global_gather(x, local_count, global_count, group=None):
    """The inverse of ``global_scatter`` (global_gather_op.cc): every
    token back to the rank it came from, in that rank's order."""
    g = _group(group)
    if get_world_size() <= 1 or g.nranks <= 1:
        _check_counts(x, local_count)
        return x.view_as(x)
    local, glob = _counts(local_count), _counts(global_count)
    if sum(glob) != x.shape[0]:
        raise ValueError(
            f"global_gather: sum(global_count)={sum(glob)} must equal the "
            f"token count {x.shape[0]}")
    return _GlobalExchange.apply(x, local, glob, g, False)


def all_reduce_sum(x, group):
    """A sum over ``group`` whose backward sums the gradients over the
    group too: each member's loss holds the sum, so the gradient of their
    total reaches every member's addend (the MoE's aux loss means)."""
    return _AllReduceSum.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.detach().clone(), op=ReduceOp.SUM, group=group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), op=ReduceOp.SUM,
                          group=ctx.group), None
