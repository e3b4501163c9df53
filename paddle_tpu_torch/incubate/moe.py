"""Mixture-of-Experts layer (port of paddle_tpu/incubate/moe.py).

Top-k gating, a fixed-capacity dispatch, the experts' MLPs batched over
the expert dim and a weighted combine, with the reference's arithmetic:
the capacity ``max(1, int(k·N/E·cf))`` floors (its docstring says ceil:
ROADMAP C-ref-25, mirrored); each of the k rounds has its own queues;
the k-th choice is the k-th of a stable descending sort, so a tie goes to
the lower index as ``lax.top_k``'s does; the experts' activation is the
tanh gelu; a token leaves as ``x · clip(1 − Σ w_k·keep_k, 0, 1)`` plus its
experts' weighted outputs; the auxiliary load-balancing loss is
``E · Σ_e mean_e(p) · mean_e(onehot(argmax p))``. The dispatch and the
combine go by index (distributed/utils.py).

Expert parallelism: where ``expert_axis`` names an axis of the mesh of
degree n > 1 (distributed/mesh.py), member r of that axis's group holds
experts ``[r·E/n, (r+1)·E/n)`` (``w1``, ``b1``, ``w2``, ``b2`` keep that
slice, marked ``p.ep_split``; each rank draws the whole tensors and keeps
its slice, so the weights are the serial layer's) and the layer computes
what the serial layer computes on the group's whole batch, the ranks'
tokens in rank order:

- the capacity comes from the group's token count, and a token's
  position in its expert's queue from the tokens routed there by the
  ranks before it (an all-gather of the per-expert counts);
- the dispatch and combine are all-to-alls (``expert_dispatch``,
  ``expert_combine``);
- the aux loss's means are over the group's tokens (their sums
  all-reduced);
- an owner's expert gradients hold every rank's contribution: they are
  scaled by 1/n, so that they are the gradient of the ranks' mean loss,
  as the replicated parameters' are once DataParallel's Reducer (or the
  caller) averages theirs over the ranks. The Reducer leaves the expert
  slices alone, except to average them over ``p.ep_replicas`` (the
  "data" axis's group, where the mesh has one).

The reference catches every error of its sharding constraint, so an
``expert_axis`` that names no mesh axis runs the experts whole; the port
does so at world size 1 and raises at world size > 1 (ROADMAP C-ref-25).
Gate noise draws from the layer's generator (None: torch's default one
of its device), in training only.
"""
from __future__ import annotations

import functools

import torch

from .. import nn
from ..amp.auto_cast import amp_cast
from ..core.random import normal
from ..distributed.utils import (all_reduce_sum, combine_tokens,
                                 dispatch_tokens, expert_combine,
                                 expert_dispatch)

__all__ = ["MoELayer"]


def _expert_group(expert_axis, num_experts):
    """The group the experts split over, or None (module docstring)."""
    from ..distributed.env import get_world_size
    from ..distributed.mesh import get_mesh
    if expert_axis is None or get_world_size() <= 1:
        return None
    mesh = get_mesh()
    if expert_axis not in mesh.axis_names:
        raise ValueError(
            f"MoELayer: expert_axis {expert_axis!r} is not an axis of the "
            f"mesh {mesh.shape} (ROADMAP C-ref-25: the reference would run "
            f"the experts whole on every rank); build the mesh with it, "
            f"e.g. distributed.mesh.build_mesh({{{expert_axis!r}: n}})")
    n = mesh.shape[expert_axis]
    if n <= 1:
        return None
    if num_experts % n:
        raise ValueError(f"MoELayer: {num_experts} experts do not split "
                         f"over the {n} ranks of axis {expert_axis!r}")
    return mesh.group(expert_axis)


class MoELayer(nn.Layer):
    """Top-k gated MoE over d_model -> d_hidden -> d_model expert MLPs
    (module docstring)."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, gate_noise=0.0, expert_axis=None,
                 **factory):
        super().__init__(**factory)
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.top_k = min(top_k, num_experts)
        self.capacity_factor = capacity_factor
        if gate_noise < 0:
            from ..framework.errors import InvalidArgumentError
            raise InvalidArgumentError(
                f"gate_noise must be >= 0, got {gate_noise}")
        self.gate_noise = gate_noise
        self.expert_axis = expert_axis
        I = nn.initializer
        self.gate = nn.Linear(d_model, num_experts, bias_attr=False,
                              **self.factory_kwargs())
        self.w1 = self.create_parameter(
            [num_experts, d_model, d_hidden],
            default_initializer=I.KaimingNormal(fan_in=d_model))
        self.b1 = self.create_parameter([num_experts, 1, d_hidden],
                                        is_bias=True)
        self.w2 = self.create_parameter(
            [num_experts, d_hidden, d_model],
            default_initializer=I.KaimingNormal(fan_in=d_hidden))
        self.b2 = self.create_parameter([num_experts, 1, d_model],
                                        is_bias=True)
        self.aux_loss = None
        self.dropped_tokens = None
        self._group = _expert_group(expert_axis, num_experts)
        if self._group is not None:
            self._split_experts()

    def _split_experts(self):
        from ..distributed.fleet.meta_parallel import TPSplit
        from ..distributed.mesh import get_mesh
        g = self._group
        r, n = g.rank, g.nranks
        mesh = get_mesh()
        replicas = mesh.group("data") if \
            mesh.shape.get("data", 1) > 1 else None
        scale = 1.0 / n
        with torch.no_grad():
            for p in (self.w1, self.b1, self.w2, self.b2):
                p.data = p.detach().chunk(n, 0)[r].clone()
                p.ep_split = TPSplit(0, 1, r, n, g)
                p.ep_replicas = replicas
                p.register_hook(lambda grad: grad * scale)

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"num_experts={self.num_experts}, top_k={self.top_k}")

    def _routing_counts(self, top, argmax):
        """(N over the group, the argmax counts over the group, each
        round's per-expert counts of the ranks before this one, and of
        the whole group), from one all-gather of this rank's. At one rank
        no collective and no host copy: a captured step may call it."""
        E, K = self.num_experts, self.top_k

        def counts(idx):
            return torch.nn.functional.one_hot(idx, E).sum(0)
        rounds = torch.stack([counts(top[:, k]) for k in range(K)])
        if self._group is None:
            return top.shape[0], counts(argmax), None, rounds
        from ..distributed.collective import all_gather
        mine = torch.cat([rounds.new_full((1,), top.shape[0]),
                          counts(argmax), rounds.reshape(-1)])
        every = torch.stack(all_gather([], mine, group=self._group))
        before = every[:self._group.rank, 1 + E:].sum(0).reshape(K, E)
        return (int(every[:, 0].sum()), every[:, 1:1 + E].sum(0), before,
                every[:, 1 + E:].sum(0).reshape(K, E))

    def forward(self, x):
        shape = list(x.shape)
        xf = x.reshape(-1, self.d_model)
        E, K = self.num_experts, self.top_k
        logits = self.gate(xf)
        if self.gate_noise > 0 and self.training:
            logits = logits + self.gate_noise * normal(
                tuple(logits.shape), self._generator, logits.device,
                logits.dtype)
        probs = nn.functional.softmax(logits, axis=-1)
        # the k-th choice: lax.top_k's order, the lower index first on ties
        top = torch.sort(probs.detach(), dim=1, descending=True,
                         stable=True).indices[:, :K]
        argmax = top[:, 0]
        # the reference's arithmetic on the group's token count (a host
        # int, the same on every rank of the group)
        n_global, argmax_counts, before, total = self._routing_counts(
            top, argmax)
        capacity = max(1, int(self.top_k * n_global / E
                              * self.capacity_factor))
        me = probs.sum(0)
        if self._group is not None:
            me = all_reduce_sum(me, self._group)
        me = me / n_global
        ce = (argmax_counts.to(probs.dtype) / n_global)
        self.aux_loss = (me * ce).sum() * E
        self.dropped_tokens = (total - capacity).clamp_min(0).sum(1)

        combined, residual_w = None, None
        for k in range(K):
            idx_k = top[:, k]
            buf, slots, keep = dispatch_tokens(
                *amp_cast("moe_dispatch", xf), idx_k, E, capacity,
                offset=None if before is None else before[k])
            out_k = combine_tokens(self._experts(buf), slots)
            w_k = (probs.gather(1, idx_k[:, None])
                   * keep.to(probs.dtype)[:, None])
            term = out_k * w_k
            combined = term if combined is None else combined + term
            residual_w = w_k if residual_w is None else residual_w + w_k
        combined = combined + xf * torch.clamp(1.0 - residual_w, 0.0, 1.0)
        return combined.reshape(shape)

    def _experts(self, buf):
        """Each expert's MLP on its (C, d) slots, batched over the experts
        this rank holds (all of them, or its slice under expert
        parallelism: the exchange brings the slots and takes them back)."""
        if self._group is not None:
            buf = expert_dispatch(buf, self._group)
        args = amp_cast("moe_experts", buf, self.w1, self.b1, self.w2,
                        self.b2)
        # mixed dtypes compute in their promoted one, as jnp.einsum does
        dtype = functools.reduce(torch.promote_types,
                                 [t.dtype for t in args])
        buf, w1, b1, w2, b2 = (t.to(dtype) for t in args)
        h = torch.matmul(buf, w1) + b1
        h = torch.nn.functional.gelu(h, approximate="tanh")
        out = torch.matmul(h, w2) + b2
        if self._group is not None:
            out = expert_combine(out, self._group)
        return out
