"""cross_entropy (port of paddle_tpu/nn/functional/loss.py).

The reference's semantics (paddle's softmax_with_cross_entropy): hard or
soft labels, ``ignore_index``, class ``weight``, reductions, and
``use_softmax=False`` for inputs that are already probabilities. Written
over log_softmax and gather rather than torch.nn.functional.cross_entropy,
which differs at the edge: here the ``mean`` of hard labels divides by
max(#valid, 1), so a batch whose labels are all ignored gives 0, not NaN.
The count of valid labels stays a device tensor (no host sync, so a
captured step can compute it). Under ``amp.auto_cast`` the inputs are
promoted to float32 (black list).
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["cross_entropy"]


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
