"""SpecLayout: declarative placements over the mesh's named axes, and
ZeRO-3 (port of paddle_tpu/distributed/spec_layout.py).

A ``SpecLayout`` names the mesh axes of data parallelism (``data``),
parameter sharding (``fsdp``, mesh axis "sharding"), tensor parallelism
(``tp``, "model"), the pipeline (``pipe``) and sequence parallelism
(``sep``), and derives from them the placement of a batch, a run_steps
group, a parameter, an activation and a ring-attention operand. A spec is
the port's own: a tuple with one entry a dim, an axis name or None, the
empty tuple for "replicated" (the reference's ``PartitionSpec``). An axis
absent from the mesh, or of degree 1, drops out of every spec, so one
layout describes the serial run, the data-parallel run and the ZeRO run.

The reference hands these specs to GSPMD, which partitions one program
over every device. The port runs one process per rank, so the appliers
do the partition themselves:

- ``shard_batch`` / ``shard_stacked_batch``: this data rank's slice of
  dim 0 (dim 1 of a stacked run_steps group). The batch splits over the
  data axis only, as the reference's ``batch_spec`` does: the ranks of
  one fsdp group hold the same batch.
- ``shard_params`` (ZeRO-3): each parameter that ``param_spec`` shards
  keeps only this rank's slice along that dim (``p.fsdp_split``, the
  spec in ``p.sharding_spec``). Optimizer moments and f32 masters are
  made from the parameter at their first use, so they are born sharded:
  sharding the parameters is the optimizer-state partition, as in the
  reference. While a module whose parameters include shards runs its
  forward (the outermost such call), every shard is all-gathered over
  its fsdp group, one flat buffer a (group, dtype, device), and the
  whole tensor stands in the module for the parameter
  (``_GatheredParam``); its gradient is averaged over the fsdp group and
  this rank keeps its slice (an all-reduce and a slice: gloo has no
  reduce-scatter). The mean, not the sum: the fsdp ranks of one data
  rank hold the same batch and compute the same gradient. Under fleet's
  ZeRO-1 layout, where the sharding ranks split the batch, the mean
  over them is what the data-parallel mean asks for too. The
  data-parallel Reducer then averages a shard's gradient over the data
  group only (``p.fsdp_replicas``).
- A gathered weight is not kept from the forward to the backward: while
  the forward runs, a ``saved_tensors_hooks`` pair stores, for every
  tensor autograd saves that lies in a gathered weight's memory, only
  the parameter and the view, and the backward gathers the weight again
  when it needs it. So a rank holds its shards, its optimizer state, the
  weights of one forward while it runs and one weight at a time in the
  backward.
- ``unshard`` gathers every parameter back to its whole shape (the
  optimizer's state stays sharded: it is for export and parity, as in
  the reference). The state dict of a still-sharded module gathers each
  shard to the reference's shape under its name, a collective every
  member of the fsdp group makes; the port's own loaders and the hybrid
  checkpoint read the local shards (``framework.io_utils``'s
  ``local_state_dict``) and take or give the whole through
  ``param_split``, as for tensor-parallel shards.

A sharded step runs eagerly: its collectives go through the process
group, which a CUDA graph cannot capture. A parameter that already is a
tensor-parallel shard (``tp_split``) is not sharded again. Recompute
inside a sharded module is not supported: its backward reruns a forward
outside the gathering call.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass

import torch

from .mesh import get_mesh

__all__ = ["SpecLayout", "shard_params", "shard_batch",
           "shard_stacked_batch", "unshard", "stats", "reset_stats"]


@dataclass(frozen=True)
class SpecLayout:
    """Canonical specs for parameters and batches on the hybrid mesh.
    data_axis, fsdp_axis, tp_axis, pipe_axis and sep_axis name mesh
    axes; ``shard_params=True`` turns on ZeRO-3 along ``fsdp_axis``."""

    data_axis: str = "data"
    fsdp_axis: str = "sharding"
    tp_axis: str = "model"
    pipe_axis: str = "pipe"
    sep_axis: str = "sep"
    shard_params: bool = False

    def _degree(self, axis, mesh=None):
        mesh = mesh if mesh is not None else get_mesh()
        return mesh.shape.get(axis, 1)

    def batch_spec(self, ndim, mesh=None):
        """Inputs split their leading (batch) dim over the data axis."""
        if ndim == 0 or self._degree(self.data_axis, mesh) <= 1:
            return ()
        return (self.data_axis,) + (None,) * (ndim - 1)

    def stacked_batch_spec(self, ndim, mesh=None):
        """run_steps inputs carry a leading steps axis; the batch dim is
        dim 1."""
        if ndim <= 1 or self._degree(self.data_axis, mesh) <= 1:
            return ()
        return (None, self.data_axis) + (None,) * (ndim - 2)

    def param_spec(self, shape, name="", mesh=None):
        """ZeRO-3 placement of one parameter: its largest dim that the
        fsdp degree divides, sharded over fsdp_axis; replicated
        otherwise, and always with ``shard_params=False``."""
        deg = self._degree(self.fsdp_axis, mesh)
        if not self.shard_params or deg <= 1 or not shape:
            return ()
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if shape[i] >= deg and shape[i] % deg == 0:
                spec = [None] * len(shape)
                spec[i] = self.fsdp_axis
                return tuple(spec)
        return ()

    def activation_spec(self, ndim, mesh=None):
        """A pipeline stage's activation: the batch dim over the data
        axis, as ``batch_spec``."""
        return self.batch_spec(ndim, mesh=mesh)

    def sequence_spec(self, ndim, seq_dim=1, mesh=None):
        """A ring-attention operand: the sequence dim over the sep axis."""
        if ndim <= seq_dim or self._degree(self.sep_axis, mesh) <= 1:
            return ()
        spec = [None] * ndim
        spec[seq_dim] = self.sep_axis
        return tuple(spec)


# -- the appliers ----------------------------------------------------------

def _split_dim(tensors, spec_of, layout, mesh, name):
    mesh = mesh if mesh is not None else get_mesh()
    out = []
    for t in tensors:
        spec = spec_of(t.dim(), mesh=mesh)
        if not spec:
            out.append(t)
            continue
        dim = spec.index(layout.data_axis)
        n = mesh.shape[layout.data_axis]
        if t.shape[dim] % n:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does "
                             f"not split over the {n} data ranks")
        r = mesh.group(layout.data_axis).rank
        out.append(t.chunk(n, dim)[r])
    return out[0] if len(out) == 1 else out


def shard_batch(layout, *tensors, mesh=None):
    """This data rank's slice of each tensor's batch dim; a tensor passes
    through where the data axis has degree 1. One tensor in, one out;
    else a list."""
    return _split_dim(tensors, layout.batch_spec, layout, mesh,
                      "shard_batch")


def shard_stacked_batch(layout, *tensors, mesh=None):
    """shard_batch for run_steps groups: the leading axis is the step,
    dim 1 the batch."""
    return _split_dim(tensors, layout.stacked_batch_spec, layout, mesh,
                      "shard_stacked_batch")


# -- ZeRO-3: the shards and their gathering --------------------------------

# the live shards by id (a tensor's == is elementwise, so no WeakSet),
# and a count bumped whenever one is made or unmade
_SHARDS = weakref.WeakValueDictionary()
_STATE = {"generation": 0, "hooks": None}
_LOCAL = threading.local()
_STATS = {"gathers": 0, "gathered_bytes": 0, "regathers": 0,
          "regathered_bytes": 0, "reduce_scatters": 0,
          "reduce_scattered_bytes": 0}


def stats():
    """ZeRO-3's collectives since the last reset, on this rank: forward
    gathers (one a flat bucket) and the bytes of the whole weights they
    made, the backward's gathers again of one weight each, and the
    gradient reductions with the bytes of the whole gradients."""
    return dict(_STATS)


def reset_stats():
    for k in _STATS:
        _STATS[k] = 0


def _nbytes(t):
    return t.numel() * t.element_size()


def _gather_flat(tensors, group):
    """Every member's flat concatenation of ``tensors`` (all of one dtype
    and device), in member order."""
    from .collective import all_gather
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    parts = []
    all_gather(parts, flat, group=group)
    return parts


def _whole(parts, ofs, shard, split):
    """A parameter's whole tensor from the members' flat buffers: its
    slice ``[ofs, ofs + numel)`` of each, laid along the split dim."""
    n = shard.numel()
    return torch.cat([part[ofs:ofs + n].view(shard.shape) for part in parts],
                     dim=split.axis)


def _gather_one(p):
    split = p.fsdp_split
    with torch.no_grad():
        return _whole(_gather_flat([p], split.group), 0, p, split)


class _GatheredParam(torch.autograd.Function):
    """Forward: the parameter's whole tensor from the gathered buffers;
    backward: the gradient averaged over the fsdp group, this rank's
    slice."""

    @staticmethod
    def forward(ctx, p, parts, ofs, split):
        ctx.split, ctx.dtype = split, p.dtype
        return _whole(parts, ofs, p, split)

    @staticmethod
    def backward(ctx, grad):
        from .collective import ReduceOp, _all_reduce_start, _watched
        split = ctx.split
        buf = grad.to(ctx.dtype).clone(memory_format=torch.contiguous_format)
        with _watched("reduce_scatter", split.group, buf):
            _all_reduce_start(buf, ReduceOp.AVG, split.group).wait()
        _STATS["reduce_scatters"] += 1
        _STATS["reduce_scattered_bytes"] += _nbytes(buf)
        size = buf.shape[split.axis] // split.nranks
        return (buf.narrow(split.axis, split.rank * size, size).contiguous(),
                None, None, None)


class _Regather:
    """What the forward saved of a gathered weight: the parameter and
    the view; the backward gathers the weight again."""

    __slots__ = ("param", "size", "stride", "offset")

    def __init__(self, param, t):
        self.param = param
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()

    def materialize(self):
        full = _gather_one(self.param)
        _STATS["regathers"] += 1
        _STATS["regathered_bytes"] += _nbytes(full)
        return full.as_strided(self.size, self.stride, self.offset)


class _Region:
    """One outermost forward of a module holding shards: the whole
    weights stand in the modules for their parameters, and the
    saved-tensor hooks keep them out of the backward's saved state."""

    def __init__(self, module, entries):
        self.module, self.depth = module, 1
        self.entries = entries
        self.storages = {}
        params = list({id(p): p for _, _, p in entries}.values())
        fulls = {}
        buckets = {}
        for p in params:
            split = p.fsdp_split
            buckets.setdefault((id(split.group), p.dtype, p.device),
                               (split.group, []))[1].append(p)
        for group, ps in buckets.values():
            with torch.no_grad():
                parts = _gather_flat(ps, group)
            _STATS["gathers"] += 1
            ofs = 0
            for p in ps:
                full = _GatheredParam.apply(p, parts, ofs, p.fsdp_split)
                ofs += p.numel()
                fulls[id(p)] = full
                _STATS["gathered_bytes"] += _nbytes(full)
                self.storages[full.untyped_storage().data_ptr()] = (p, full)
        for owner, name, p in entries:
            owner._parameters[name] = fulls[id(p)]
        self.hooks = torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                              _unpack)
        self.hooks.__enter__()

    def _pack(self, t):
        if t.layout != torch.strided or t.device.type == "meta":
            return t
        hit = self.storages.get(t.untyped_storage().data_ptr())
        if hit is None or hit[1].dtype != t.dtype:
            return t
        return _Regather(hit[0], t)

    def close(self):
        self.hooks.__exit__(None, None, None)
        for owner, name, p in self.entries:
            owner._parameters[name] = p
        self.storages.clear()


def _unpack(obj):
    if isinstance(obj, _Regather):
        with torch.no_grad():
            return obj.materialize()
    return obj


def _entries(module):
    """(owner, name, shard) of every shard in ``module``'s subtree,
    cached on the module until a shard is made or unmade."""
    cached = module.__dict__.get("_pt_fsdp_entries")
    if cached is not None and cached[0] == _STATE["generation"]:
        return cached[1]
    entries = []
    for owner in module.modules():
        for name, p in owner._parameters.items():
            if p is not None and getattr(p, "fsdp_split", None) is not None:
                entries.append((owner, name, p))
                _hook_state_dict(owner)
    module.__dict__["_pt_fsdp_entries"] = (_STATE["generation"], entries)
    return entries


def _pre_forward(module, args):
    region = getattr(_LOCAL, "region", None)
    if region is not None:
        if region.module is module:
            region.depth += 1
        return
    if not _SHARDS:
        _remove_hooks()
        return
    entries = _entries(module)
    if entries:
        _LOCAL.region = _Region(module, entries)


def _post_forward(module, args, output):
    region = getattr(_LOCAL, "region", None)
    if region is not None and region.module is module:
        region.depth -= 1
        if region.depth == 0:
            _LOCAL.region = None
            region.close()


def _install_hooks():
    if _STATE["hooks"] is None:
        from torch.nn.modules import module as _m
        _STATE["hooks"] = (
            _m.register_module_forward_pre_hook(_pre_forward),
            _m.register_module_forward_hook(_post_forward, always_call=True))


def _remove_hooks():
    if _STATE["hooks"] is not None:
        for h in _STATE["hooks"]:
            h.remove()
        _STATE["hooks"] = None


def _state_hook(module, state, prefix, local_metadata):
    """A module's state dict holds each shard gathered to its whole
    shape, except for the port's own readers of the local shards."""
    from ..framework.io_utils import reading_local_state
    if reading_local_state():
        return
    for name, p in module._parameters.items():
        if p is not None and getattr(p, "fsdp_split", None) is not None \
                and prefix + name in state:
            state[prefix + name] = _gather_one(p)


def _hook_state_dict(owner):
    if "_pt_fsdp_state_hook" not in owner.__dict__:
        owner.__dict__["_pt_fsdp_state_hook"] = \
            owner._register_state_dict_hook(_state_hook)


def _replicas(mesh, data_axis):
    """The group over which the ranks holding one shard split the batch:
    the data axis's (None where it has degree 1)."""
    return mesh.group(data_axis) if mesh.shape.get(data_axis, 1) > 1 \
        else None


def shard_parameters(items, group, replicas=None):
    """ZeRO-3 on ``items`` [(parameter, dim)]: each keeps this member's
    slice of ``dim`` over ``group`` (module docstring). ``replicas``:
    the group the Reducer averages the shards' gradients over."""
    from .fleet.meta_parallel import TPSplit
    from .reducer import rearm_reducers
    if not items:
        return
    r, n = group.rank, group.nranks
    with torch.no_grad():
        for p, dim in items:
            p.data = p.detach().chunk(n, dim)[r].clone(
                memory_format=torch.contiguous_format)
            p.grad = None
            p.fsdp_split = TPSplit(dim, 1, r, n, group)
            p.fsdp_replicas = replicas
            _SHARDS[id(p)] = p
    _STATE["generation"] += 1
    _install_hooks()
    rearm_reducers()


def shard_params(network, layout, mesh=None):
    """Shard every parameter of ``network`` that ``layout.param_spec``
    shards, along that dim over the fsdp group (ZeRO-3; module
    docstring), and record each parameter's spec on
    ``p.sharding_spec``. Returns the number of parameters sharded (0:
    all replicated). A parameter sharded already counts and stays as it
    is."""
    mesh = mesh if mesh is not None else get_mesh()
    items, count = [], 0
    for name, p in network.named_parameters():
        if getattr(p, "fsdp_split", None) is not None:
            count += 1
            continue
        spec = () if getattr(p, "tp_split", None) is not None else \
            layout.param_spec(tuple(p.shape), name=name, mesh=mesh)
        p.sharding_spec = spec
        if spec:
            items.append((p, spec.index(layout.fsdp_axis)))
    if items:
        shard_parameters(items, mesh.group(layout.fsdp_axis),
                         _replicas(mesh, layout.data_axis))
        _entries(network)
    return count + len(items)


def unshard(network):
    """Gather every parameter of ``network`` back to its whole shape on
    every rank: the inverse of ``shard_params`` (the optimizer's state
    stays sharded). Every member of each fsdp group calls it."""
    from .reducer import rearm_reducers
    changed = False
    for _, p in network.named_parameters():
        if getattr(p, "fsdp_split", None) is not None:
            full = _gather_one(p)
            with torch.no_grad():
                p.data = full
            p.grad = None
            del p.fsdp_split, p.fsdp_replicas
            _SHARDS.pop(id(p), None)
            changed = True
        p.sharding_spec = None
    if changed:
        _STATE["generation"] += 1
        rearm_reducers()
