"""The SPMD circular pipeline: ``PipelineStageStack`` (port of
paddle_tpu/distributed/fleet/spmd_pipeline.py).

A stack of ``num_stages`` stages of one structure (groups of transformer
blocks, say), one a rank of the "pipe" mesh axis. As in the reference,
each state entry of the stage is one stacked parameter named after it
with "." replaced by "__", of shape (num_stages, ...), and the stack
keeps the first stage it builds as ``template`` (whose own parameters
the forward replaces by a stage's). Every rank builds every stage, so
the weights come from the same draws as the reference's; rank s keeps
slice [s] of each stacked parameter (``p.stage_split``), so the gathered
state dict (``full_state_dict``, the hybrid checkpoint) has the stacked
shapes and a stacked state dict loads, each rank taking its slice.

The reference runs the schedule as one ``lax.scan`` over m + n - 1 ticks
in which every device applies its stage to what it holds, bubble ticks
on zeros whose outputs it throws away, and its backward is JAX's
transpose of the scan. The port writes the schedule out per rank
(``_Schedule``) and skips the bubble ticks; the values are the same:

- forward: stage 0 takes micro-batch t of the whole batch (which every
  rank holds, the reference's replicated input), rank s > 0 receives it
  from rank s - 1; each rank applies its stage (the template with its
  slice substituted, ``torch.func.functional_call``) and sends the
  result on to rank s + 1, asynchronously. The last stage's outputs
  reach every rank (a broadcast over the pipe group, where the reference
  all-gathers).
- backward: the same sends in reverse, micro-batch by micro-batch from
  the last: the last stage takes its cotangent from the output, each
  rank the gradient of its stage's input and parameters by
  ``torch.autograd.grad`` over the graph its forward kept, and sends the
  input's gradient to rank s - 1. Stage 0's input gradient is broadcast
  over the pipe group, so that a replicated layer in front of the stack
  (an embedding) sees the same gradient on every rank.

On a pipe axis of degree 1 the stages run in turn on the whole batch, as
the reference's do. The schedule runs eagerly (its sends go through the
process group); ``stats()`` counts ticks run and skipped and the bytes
sent.
"""
from __future__ import annotations

import torch

from ...framework.param_attr import Parameter
from ...nn.layer.layers import Layer
from ..mesh import axis_degree, get_mesh

__all__ = ["PipelineStageStack"]


def _stage_call(template, names, leaves, x):
    from torch.func import functional_call
    return functional_call(template, dict(zip(names, leaves)), (x,))


class _Schedule(torch.autograd.Function):
    """The pipelined forward and backward of one rank (module
    docstring)."""

    @staticmethod
    def forward(ctx, stack, x, *params):
        out, records = stack._run(x, params, keep=True)
        ctx.stack, ctx.records = stack, records
        ctx.x_grad = x.requires_grad
        return out

    @staticmethod
    def backward(ctx, grad):
        gx, gps = ctx.stack._backward(ctx.records, grad, ctx.x_grad)
        ctx.records = None
        return (None, gx, *gps)


class PipelineStageStack(Layer):
    """``num_stages`` structurally identical stages built by
    ``layer_factory()`` (input and output of one shape), pipelined over
    the ``axis`` mesh axis in ``num_microbatches`` micro-batches."""

    def __init__(self, layer_factory, num_stages, num_microbatches,
                 axis="pipe"):
        super().__init__()
        from ...framework.io_utils import local_state_dict
        from .meta_parallel import TPSplit
        deg = axis_degree(axis)
        if deg > 1 and num_stages != deg:
            raise ValueError(
                f"num_stages ({num_stages}) must equal the '{axis}' mesh "
                f"axis degree ({deg}): each rank holds and runs exactly one "
                f"stage of the circular schedule")
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.axis = axis
        self.template = layer_factory()
        self._param_names = list(local_state_dict(self.template))
        stages = [self.template] + [layer_factory()
                                    for _ in range(num_stages - 1)]
        group = get_mesh().group(axis) if deg > 1 else None
        states = [local_state_dict(st) for st in stages]
        with torch.no_grad():
            for k in self._param_names:
                if group is None:
                    arr = torch.stack([sd[k].detach() for sd in states])
                else:
                    arr = states[group.rank][k].detach().clone().unsqueeze(0)
                p = Parameter(arr)
                p.name = k
                if group is not None:
                    p.stage_split = TPSplit(0, 1, group.rank, deg, group)
                self.add_parameter(k.replace(".", "__"), p)
        del stages[1:]
        self._stats = {"ticks": 0, "bubble_ticks_skipped": 0,
                       "p2p_bytes": 0, "p2p_wait_s": 0.0}

    def stats(self):
        """Ticks this rank ran and bubble ticks it skipped, the bytes it
        sent to its neighbours and the seconds it waited for them."""
        return {**self._stats, "compiled": False}

    def _stacked(self):
        return [self._parameters[k.replace(".", "__")]
                for k in self._param_names]

    def forward(self, x):
        """x: the whole batch (num_microbatches * mb, ...) -> the output
        of the last stage, of the same shape, on every rank."""
        params = self._stacked()
        if axis_degree(self.axis) <= 1:
            out = x
            for s in range(self.num_stages):
                out = _stage_call(self.template, self._param_names,
                                  [p[s] for p in params], out)
            return out
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in params)):
            return _Schedule.apply(self, x, *params)
        return self._run(x, params, keep=False)[0]

    # -- the schedule of this rank --------------------------------------

    def _group(self):
        return get_mesh().group(self.axis)

    def _tally(self, ex):
        self._stats["p2p_bytes"] += ex.bytes
        self._stats["p2p_wait_s"] += ex.wait_s

    def _run(self, x, params, keep):
        """This rank's forward ticks; returns the last stage's output
        (every rank) and, when ``keep``, each micro-batch's (input,
        output, leaves) for the backward."""
        from ..collective import Exchange, broadcast
        g = self._group()
        n, s, m = g.nranks, g.rank, self.num_microbatches
        if x.shape[0] % m:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"num_microbatches {m}")
        micro = x.detach().chunk(m)
        leaves = [p.detach()[0].detach().requires_grad_(p.requires_grad)
                  for p in params]
        send = Exchange(g)
        records, outs = [], []
        for t in range(m):
            if s == 0:
                inp = micro[t]
            else:
                ex = Exchange(g)
                ex.recv(micro[t].shape, x.dtype, x.device, s - 1)
                inp = ex.wait()[0]
                self._tally(ex)
            if keep:
                inp = inp.detach().requires_grad_(s > 0 or x.requires_grad)
            with torch.set_grad_enabled(keep):
                out = _stage_call(self.template, self._param_names, leaves,
                                  inp)
            self._stats["ticks"] += 1
            if keep:
                records.append((inp, out))
            if s < n - 1:
                send.send(out.detach(), s + 1)
            else:
                outs.append(out.detach())
        send.wait()
        self._tally(send)
        self._stats["bubble_ticks_skipped"] += n - 1
        y = torch.cat(outs) if s == n - 1 else torch.empty_like(x)
        broadcast(y, src=g.global_rank(n - 1), group=g)
        return y, (records, leaves) if keep else None

    def _backward(self, saved, grad, x_grad):
        """The reverse sends: (the input's gradient, each stacked
        parameter's)."""
        from ..collective import Exchange, broadcast
        records, leaves = saved
        g = self._group()
        n, s, m = g.nranks, g.rank, self.num_microbatches
        gys = grad.chunk(m)
        sums = [None] * len(leaves)
        gx = [None] * m
        send = Exchange(g)
        for t in reversed(range(m)):
            inp, out = records[t]
            if s == n - 1:
                g_out = gys[t]
            else:
                ex = Exchange(g)
                ex.recv(out.shape, out.dtype, out.device, s + 1)
                g_out = ex.wait()[0]
                self._tally(ex)
            wrt = [inp] if inp.requires_grad else []
            wrt += [lf for lf in leaves if lf.requires_grad]
            got = list(torch.autograd.grad(out, wrt, g_out,
                                           allow_unused=True))
            g_in = got.pop(0) if inp.requires_grad else None
            it = iter(got)
            for i, lf in enumerate(leaves):
                if lf.requires_grad:
                    gl = next(it)
                    if gl is not None:
                        sums[i] = gl if sums[i] is None else sums[i] + gl
            if s > 0:
                send.send(g_in if g_in is not None
                          else torch.zeros_like(inp), s - 1)
            elif x_grad:
                gx[t] = g_in
        send.wait()
        self._tally(send)
        gx_all = None
        if x_grad:
            gx_all = torch.cat(gx) if s == 0 else torch.empty_like(grad)
            broadcast(gx_all, src=g.global_rank(0), group=g)
        return gx_all, [None if sm is None else sm.unsqueeze(0)
                        for sm in sums]
