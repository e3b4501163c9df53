"""Loss functions (port of paddle_tpu/nn/functional/loss.py).

``cross_entropy`` has the reference's semantics (paddle's
softmax_with_cross_entropy): hard or soft labels, ``ignore_index``, class
``weight``, reductions, and ``use_softmax=False`` for inputs that are
already probabilities. It is written over log_softmax and gather rather
than torch.nn.functional.cross_entropy, which differs at the edge: here
the ``mean`` of hard labels divides by max(#valid, 1), so a batch whose
labels are all ignored gives 0, not NaN. The count of valid labels stays a
device tensor (no host sync, so a captured step can compute it).

The other losses follow the reference's formulas line for line, each
under the reference's op name for ``amp.auto_cast`` (cross_entropy and
softmax_with_cross_entropy are black-listed, so promoted to float32; at
O2 the others compute in the low dtype). ``margin_cross_entropy`` also
takes a class-sharded ``group``.
"""
from __future__ import annotations

import math

import torch

from ...amp.auto_cast import amp_cast

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "mse_loss", "l1_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "ctc_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "triplet_margin_loss",
    "log_loss", "square_error_cost", "sigmoid_focal_loss", "dice_loss",
    "soft_margin_loss", "multi_label_soft_margin_loss", "poisson_nll_loss",
    "triplet_margin_with_distance_loss", "margin_cross_entropy",
    "hsigmoid_loss",
]


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,  # noqa: A002
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    input, label, weight = amp_cast("cross_entropy", input, label, weight)
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(input.clamp_min(1e-30))
    if soft_label:
        return _reduce(-(label * logp).sum(dim=axis), reduction)
    li = label.long()
    li_exp = li.unsqueeze(axis) if li.dim() == logp.dim() - 1 else li
    per = -torch.gather(logp, axis, li_exp.clamp_min(0)).squeeze(axis)
    li = li_exp.squeeze(axis)
    valid = li != ignore_index
    per = torch.where(valid, per, 0.0)
    if weight is not None:
        wsel = torch.where(valid, weight[li.clamp_min(0)], 0.0)
        per = per * wsel
        if reduction == "mean":
            return per.sum() / wsel.sum().clamp_min(1e-12)
    if reduction == "mean":
        return per.sum() / valid.to(per.dtype).sum().clamp_min(1.0)
    return _reduce(per, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    logits, label = amp_cast("softmax_with_cross_entropy", logits, label)
    sm = torch.softmax(logits, dim=axis)
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        li = label.long()
        li_exp = li if li.dim() == logp.dim() else li.unsqueeze(axis)
        loss = -torch.gather(logp, axis, li_exp.clamp_min(0))
        loss = torch.where(li_exp != ignore_index, loss, 0.0)
    if return_softmax:
        return loss, sm
    return loss


def binary_cross_entropy(input, label, weight=None, reduction="mean",  # noqa: A002
                         name=None):
    p, y, w = amp_cast("bce", input, label, weight)
    eps = 1e-12
    per = -(y * torch.log(p.clamp_min(eps))
            + (1 - y) * torch.log((1 - p).clamp_min(eps)))
    if w is not None:
        per = per * w
    return _reduce(per, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    x, y, w, pw = amp_cast("bce_with_logits", logit, label, weight,
                           pos_weight)
    max_val = (-x).clamp_min(0)
    softplus = torch.log1p(torch.exp(-x.abs()))
    if pw is not None:
        log_w = (pw - 1) * y + 1
        per = (1 - y) * x + log_w * (softplus + max_val)
    else:
        per = (1 - y) * x + softplus + max_val
    if w is not None:
        per = per * w
    return _reduce(per, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,  # noqa: A002
             reduction="mean", name=None):
    logp, lab, w = amp_cast("nll_loss", input, label, weight)
    li = lab.long()
    per = -torch.gather(logp, 1, li.clamp_min(0)[:, None])[:, 0]
    valid = li != ignore_index
    per = torch.where(valid, per, 0.0)
    if w is not None:
        wsel = torch.where(valid, w[li.clamp_min(0)], 0.0)
        per = per * wsel
        if reduction == "mean":
            return per.sum() / wsel.sum().clamp_min(1e-12)
    if reduction == "mean":
        return per.sum() / valid.to(per.dtype).sum().clamp_min(1.0)
    return _reduce(per, reduction)


def mse_loss(input, label, reduction="mean", name=None):  # noqa: A002
    a, b = amp_cast("mse_loss", input, label)
    return _reduce(torch.square(a - b), reduction)


def square_error_cost(input, label):  # noqa: A002
    a, b = amp_cast("square_error_cost", input, label)
    return torch.square(a - b)


def l1_loss(input, label, reduction="mean", name=None):  # noqa: A002
    a, b = amp_cast("l1_loss", input, label)
    return _reduce((a - b).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):  # noqa: A002
    a, b = amp_cast("smooth_l1_loss", input, label)
    diff = (a - b).abs()
    per = torch.where(diff < delta, 0.5 * diff * diff / delta,
                      diff - 0.5 * delta)
    return _reduce(per, reduction)


def kl_div(input, label, reduction="mean", name=None):  # noqa: A002
    logp, y = amp_cast("kl_div", input, label)
    per = y * (torch.log(y.clamp_min(1e-12)) - logp)
    if reduction == "batchmean":
        return per.sum() / logp.shape[0]
    return _reduce(per, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",  # noqa: A002
                        name=None):
    a, b, y = amp_cast("margin_ranking_loss", input, other, label)
    return _reduce((-y * (a - b) + margin).clamp_min(0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",  # noqa: A002
                         name=None):
    x, y = amp_cast("hinge_embedding_loss", input, label)
    per = torch.where(y == 1, x, (margin - x).clamp_min(0.0))
    return _reduce(per, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean",
                          name=None):
    a, b, y = amp_cast("cosine_embedding_loss", input1, input2, label)
    cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                             * torch.linalg.vector_norm(b, dim=-1)
                             ).clamp_min(1e-12)
    per = torch.where(y == 1, 1 - cos, (cos - margin).clamp_min(0.0))
    return _reduce(per, reduction)


def _p_dist(a, b, p):
    return ((a - b).abs() ** p).sum(-1) ** (1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,  # noqa: A002
                        epsilon=1e-6, swap=False, reduction="mean", name=None):
    a, pos, neg = amp_cast("triplet_margin_loss", input, positive, negative)
    dp = _p_dist(a, pos, p)
    dn = _p_dist(a, neg, p)
    if swap:
        dn = torch.minimum(dn, _p_dist(pos, neg, p))
    return _reduce((dp - dn + margin).clamp_min(0.0), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):  # noqa: A002
    p, y = amp_cast("log_loss", input, label)
    return -(y * torch.log(p + epsilon) + (1 - y) * torch.log(1 - p + epsilon))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    x, y, norm = amp_cast("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(x)
    ce = x.clamp_min(0) - x * y + torch.log1p(torch.exp(-x.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    per = a_t * ((1 - p_t) ** gamma) * ce
    if norm is not None:
        per = per / norm
    return _reduce(per, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):  # noqa: A002
    p, y = amp_cast("dice_loss", input, label)
    y1 = torch.nn.functional.one_hot(y.long().squeeze(-1),
                                     p.shape[-1]).to(p.dtype)
    dims = tuple(range(1, p.dim()))
    inter = (p * y1).sum(dims)
    union = p.sum(dims) + y1.sum(dims)
    return (1 - (2 * inter + epsilon) / (union + epsilon)).mean()


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the alpha recursion in log space, one time step after
    another (the reference's lax.scan). ``log_probs`` is time-major
    (T, N, C)."""
    lp, = amp_cast("ctc_loss", log_probs)
    T, N, _ = lp.shape
    lab = labels.long()
    L = lab.shape[1]
    S = 2 * L + 1
    dev = lp.device
    ext = torch.full((N, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lab
    neg_inf = -1e30
    lab_len = label_lengths.to(dev)
    first = lp[0].gather(1, ext[:, :2])
    alpha = torch.cat(
        [first[:, :1],
         torch.where(lab_len > 0, first[:, 1], neg_inf)[:, None],
         torch.full((N, S - 2), neg_inf, dtype=lp.dtype, device=dev)], 1)
    same_as_prev2 = torch.cat(
        [torch.ones((N, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], 1)
    pad1 = torch.full((N, 1), neg_inf, dtype=lp.dtype, device=dev)
    pad2 = torch.full((N, 2), neg_inf, dtype=lp.dtype, device=dev)
    alphas = [alpha]
    for t in range(1, T):
        a_shift1 = torch.cat([pad1, alpha[:, :-1]], 1)
        a_shift2 = torch.where(same_as_prev2, neg_inf,
                               torch.cat([pad2, alpha[:, :-2]], 1))
        m = torch.maximum(torch.maximum(alpha, a_shift1), a_shift2)
        m = m.clamp_min(neg_inf)
        summed = (torch.exp(alpha - m) + torch.exp(a_shift1 - m)
                  + torch.exp(a_shift2 - m))
        alpha = m + torch.log(summed.clamp_min(1e-30)) \
            + lp[t].gather(1, ext)
        alphas.append(alpha)
    all_alpha = torch.stack(alphas)                   # (T, N, S)
    t_idx = (input_lengths.to(dev).long() - 1).clamp_min(0)
    final = all_alpha[t_idx, torch.arange(N, device=dev)]
    s_last = 2 * lab_len.long()
    a1 = final.gather(1, s_last[:, None])[:, 0]
    a2 = final.gather(1, (s_last - 1).clamp_min(0)[:, None])[:, 0]
    m = torch.maximum(a1, a2)
    loss = -(m + torch.log(torch.exp(a1 - m) + torch.exp(a2 - m)))
    if reduction == "mean":
        return (loss / lab_len.to(loss.dtype).clamp_min(1.0)).mean()
    return _reduce(loss, reduction)


def soft_margin_loss(input, label, reduction="mean", name=None):  # noqa: A002
    """log(1 + exp(-label * input)), label in {-1, 1}."""
    x, y = amp_cast("soft_margin_loss", input, label)
    return _reduce(-torch.nn.functional.logsigmoid(y.to(x.dtype) * x),
                   reduction)


def multi_label_soft_margin_loss(input, label, weight=None, reduction="mean",  # noqa: A002
                                 name=None):
    """Per-class sigmoid BCE averaged over the classes; label in {0, 1}."""
    x, y, w = amp_cast("multi_label_soft_margin_loss", input, label, weight)
    y = y.to(x.dtype)
    logsig = torch.nn.functional.logsigmoid
    term = y * logsig(x) + (1 - y) * logsig(-x)
    if w is not None:
        term = term * w
    return _reduce(-term.mean(-1), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,  # noqa: A002
                     reduction="mean", name=None):
    x, y = amp_cast("poisson_nll_loss", input, label)
    y = y.to(x.dtype)
    if log_input:
        v = torch.exp(x) - y * x
    else:
        v = x - y * torch.log(x + epsilon)
    if full:
        # Stirling's approximation of log(y!) where y > 1
        stir = y * torch.log(y) - y + 0.5 * torch.log(2 * math.pi * y)
        v = v + torch.where(y > 1, stir, torch.zeros_like(y))
    return _reduce(v, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,  # noqa: A002
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean", name=None):
    """Triplet loss with a distance callable (default: the L2 norm of the
    difference over the last axis)."""
    if distance_function is None:
        def distance_function(a, b):
            return torch.linalg.vector_norm(a - b, ord=2, dim=-1)
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, distance_function(positive, negative))
    return _reduce((d_pos - d_neg + margin).clamp_min(0.0), reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5, margin3=0.0,
                         scale=64.0, group=None, return_softmax=False,
                         reduction="mean", name=None):
    """ArcFace-family margin softmax: the target class's cosine theta
    becomes cos(margin1 * theta + margin2) - margin3, then a scaled
    softmax cross entropy, in float32.

    ``group`` (a ``distributed.Group``): the classes are sharded over the
    group, member r holding classes [r * C, (r + 1) * C) of the logits'
    last axis and every member the global labels, as in the reference's
    class-sharded branch: the row max goes through a max all-reduce, the
    softmax denominator and the target's logit through sum all-reduces
    whose backward is the identity (each member's copy of the loss
    differentiates its own shard), and every member's loss is
    -(target logit - max - log(denominator)). A mesh axis name (the
    reference's SPMD form) is this rank's group on that axis of the
    global mesh (``distributed.mesh``), whose member r holds the r-th
    shard of the classes."""
    if isinstance(group, str):
        from ...distributed.mesh import get_mesh
        mesh = get_mesh()
        if group not in mesh.axis_names:
            raise ValueError(
                f"margin_cross_entropy(group={group!r}): the global mesh has "
                f"no axis {group!r} (its axes: {mesh.axis_names})")
        group = mesh.group(group)
    x = logits.float()
    n_cls = x.shape[-1]
    lb = label.long()
    if group is not None:
        # global class ids: one_hot hits only the shard that owns the class
        lb = lb - max(group.rank, 0) * n_cls
    theta = torch.arccos(x.clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    cos_m = torch.cos(margin1 * theta + margin2) - margin3
    onehot = lb[..., None] == torch.arange(n_cls, device=x.device)
    logits_m = torch.where(onehot, cos_m, x) * scale
    owned = onehot.any(-1)
    rows = logits_m.reshape(-1, n_cls)
    loss, softmax = _ShardedSoftmaxCE.apply(
        rows, torch.where(owned, lb, -1).reshape(-1),
        torch.ones(rows.shape[0], dtype=torch.bool, device=x.device), group)
    loss = _reduce(loss.reshape(x.shape[:-1]), reduction)
    if return_softmax:
        return loss, softmax.reshape(x.shape)
    return loss


class _ShardedSoftmaxCE(torch.autograd.Function):
    """Softmax cross-entropy of f32 logits ``x`` (N, C) whose classes are
    sharded over ``group`` (None: all here). ``local`` (N,) is the label's
    index in this shard, -1 where another member owns it; ``valid`` (N,)
    False gives a row loss 0 and no gradient. The row max goes through a
    MAX all-reduce, the softmax denominator and the target's logit
    through one SUM all-reduce. Returns the row losses and this shard's
    softmax; the backward of the loss is softmax - one-hot on the local
    shard (the softmax's own backward sums over the group)."""

    @staticmethod
    def forward(ctx, x, local, valid, group):
        from ...distributed.collective import ReduceOp, all_reduce
        mx = x.amax(-1, keepdim=True)
        if group is not None:
            mx = all_reduce(mx, op=ReduceOp.MAX, group=group)
        ex = torch.exp(x - mx)
        owned = local >= 0
        tgt = torch.where(owned, x.gather(-1, local.clamp_min(0)[:, None])
                          [:, 0], 0.0)
        sums = torch.stack([ex.sum(-1), tgt], dim=-1)
        if group is not None:
            sums = all_reduce(sums, group=group)
        loss = torch.where(valid, mx[:, 0] + torch.log(sums[:, 0])
                           - sums[:, 1], 0.0)
        softmax = ex / sums[:, :1]
        ctx.group = group
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(softmax, local, valid)
        return loss, softmax

    @staticmethod
    def backward(ctx, g_loss, g_softmax):
        from ...distributed.collective import all_reduce
        softmax, local, valid = ctx.saved_tensors
        grad = torch.zeros_like(softmax)
        if g_loss is not None:
            g = torch.where(valid, g_loss, 0.0)
            grad = softmax * g[:, None]
            grad.scatter_add_(-1, local.clamp_min(0)[:, None],
                              torch.where(local >= 0, -g, 0.0)[:, None])
        if g_softmax is not None:
            dot = (g_softmax * softmax).sum(-1, keepdim=True)
            if ctx.group is not None:
                dot = all_reduce(dot, group=ctx.group)
            grad = grad + softmax * (g_softmax - dot)
        return grad, None, None, None


def hsigmoid_loss(input, label, num_classes, weight, bias=None,  # noqa: A002
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss over the default tree, a complete binary
    tree over the classes: class c's path is the binary digits of
    c + num_classes walked from the root. Returns [N, 1]."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom-tree hsigmoid (path_table/path_code) is not implemented; "
            "the default complete-binary-tree layout is supported")
    depth = max(1, int(math.ceil(math.log2(max(2, num_classes)))))
    lbl = label.reshape(-1).long()
    node = lbl + num_classes  # the leaf's place in the implicit heap
    losses = torch.zeros(lbl.shape, dtype=torch.float32, device=input.device)
    for _ in range(depth):
        bit = node % 2
        parent = node // 2
        nidx = (parent - 1).clamp(0, num_classes - 1)
        logit = (input * weight[nidx]).sum(-1)
        if bias is not None:
            logit = logit + bias.reshape(-1)[nidx]
        # sigmoid cross entropy against the path bit; above the root, 0
        active = (parent >= 1).to(torch.float32)
        tgt = bit.to(torch.float32)
        losses = losses + active * (logit.clamp_min(0) - logit * tgt
                                    + torch.log1p(torch.exp(-logit.abs())))
        node = parent
    return losses.reshape(-1, 1)
