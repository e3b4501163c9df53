"""Semi-automatic parallelism (port of
paddle_tpu/distributed/auto_parallel/__init__.py): ``ProcessMesh``, the
annotations (``shard_tensor``, ``reshard``, ``shard_op``,
``dtensor_from_fn``), ``Strategy`` and ``Engine``, and the analytic cost
model.

The reference hands an annotation to GSPMD: ``shard_tensor(x)`` equals x
in value, and the compiler moves the bytes and partitions one program
over every device. The port runs one process per rank, which has no
sharding propagation, so:

- ``shard_tensor``, ``reshard`` and ``shard_op`` return a tensor equal to
  their input, carrying its ``dist_attr`` (a ``DistAttr``); the gradient
  flows through. A parameter given to ``shard_tensor`` is annotated in
  place and returned, so that ``Engine.prepare`` sees its placement.
- ``dtensor_from_fn`` returns the whole value too: its promise that a
  tensor larger than one card never exists whole is not kept. The
  creation function runs once, eagerly, so its side effects on framework
  state (the generators it draws from) are the ones a plain call has.
- ``Engine.prepare`` places the model through the appliers of
  ``spec_layout.py`` and fleet: ``strategy.sharding`` at stage 1 or 2
  wraps the optimizer in ZeRO-1 over the data axis
  (fleet/sharding_optimizer.py), at stage 3 shards the parameters over it
  (ZeRO-3, ``shard_parameters``); at world size > 1 a ``DataParallel``
  averages the gradients over the data axis. A parameter annotated over
  another mesh axis raises NotImplementedError: the port's tensor
  parallelism is fleet's layers (ROADMAP, "Differences by design").

A ``ProcessMesh`` is a logical view over the job's ranks: its ids must lie
in [0, world size). ``mesh_groups`` builds, on first use, the port's
``distributed.mesh.Mesh`` over those ids with one ``collective.Group`` per
axis for this rank (every rank must ask, in one order).

The Engine's data axis is the mesh's first dim; a batch is split over it
on dim 0, and one whose dim 0 does not divide (or a scalar) is handed
whole to every rank. ``fit`` reports the loss averaged over the data
ranks (the reference's one logical loss); ``predict`` gathers the ranks'
outputs back to the whole batch. Gradient merge divides the loss by k
under ``avg``, steps every k-th call and zeroes the gradients in place;
the data-parallel Reducer waits for the k-th. At world size 1 the step
runs through ``jit.to_static`` (a CUDA graph on the card); at world size
> 1 it runs eagerly, since its collectives go through the process group.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ...framework.errors import PreconditionNotMetError
from ..env import get_world_size

__all__ = [
    "ProcessMesh", "shard_tensor", "shard_op", "reshard", "dtensor_from_fn",
    "DistAttr", "Strategy", "Engine", "get_default_process_mesh",
    "set_default_process_mesh", "estimate_cost",
]

_DEFAULT_MESH = [None]


class ProcessMesh:
    """An N-D logical view over process ids with named dims (module
    docstring)."""

    def __init__(self, mesh, dim_names=None, process_ids=None):
        arr = np.asarray(mesh)
        if arr.dtype.kind not in "iu":
            raise TypeError("ProcessMesh expects an array of process ids")
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(
                f"{arr.ndim}-D mesh needs {arr.ndim} dim_names, got "
                f"{dim_names}")
        if process_ids is not None:
            # remap logical ranks in `mesh` to the given process ids
            arr = np.asarray(process_ids).ravel()[arr]
        n = max(get_world_size(), 1)
        if arr.size and (int(arr.max()) >= n or int(arr.min()) < 0):
            raise ValueError(
                f"mesh references process ids in "
                f"[{int(arr.min())}, {int(arr.max())}] but valid ids are "
                f"[0, {n - 1}]")
        self._ids = arr
        self._dim_names = tuple(dim_names)
        self._mesh = None
        self._prev_stack = []

    @property
    def mesh(self):
        return self._ids

    @property
    def shape(self):
        return list(self._ids.shape)

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return [int(i) for i in self._ids.flatten()]

    @property
    def ndim(self):
        return self._ids.ndim

    @property
    def mesh_groups(self):
        """The port's ``distributed.mesh.Mesh`` over these ids: one group
        of ranks per dim for this rank (built on first use; every rank
        asks, in one order). The ids must be the whole job's ranks."""
        if self._mesh is None:
            from ..mesh import Mesh
            n = max(get_world_size(), 1)
            if sorted(self.process_ids) != list(range(n)):
                raise ValueError(
                    f"{self!r} holds ranks {self.process_ids}; the port "
                    f"places a mesh over all {n} ranks of the job")
            mesh = Mesh(self._ids, self._dim_names)
            mesh._make_groups()
            self._mesh = mesh
        return self._mesh

    def get_dim_size(self, name):
        return self._ids.shape[self._dim_names.index(name)]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and np.array_equal(self._ids, other._ids)
                and self._dim_names == other._dim_names)

    def __hash__(self):
        return hash((self._ids.astype(np.int64).tobytes(), self._dim_names))

    def __repr__(self):
        return (f"ProcessMesh(shape={self.shape}, "
                f"dim_names={list(self._dim_names)})")

    def __enter__(self):
        self._prev_stack.append(_DEFAULT_MESH[0])
        _DEFAULT_MESH[0] = self
        return self

    def __exit__(self, *exc):
        _DEFAULT_MESH[0] = self._prev_stack.pop()
        return False


def get_default_process_mesh():
    return _DEFAULT_MESH[0]


def set_default_process_mesh(mesh):
    _DEFAULT_MESH[0] = mesh


class DistAttr:
    """A tensor's distributed attribute: (process_mesh, shard_spec), the
    spec's entries mesh dim names or None (replicated)."""

    def __init__(self, process_mesh, shard_spec):
        self.process_mesh = process_mesh
        self.shard_spec = list(shard_spec)

    def partition_spec(self):
        """The spec as the port writes one (spec_layout.py): a tuple."""
        return tuple(self.shard_spec)

    def __repr__(self):
        return (f"DistAttr(mesh={self.process_mesh}, "
                f"spec={self.shard_spec})")


def _resolve(process_mesh, shard_spec, ndim):
    pm = process_mesh or get_default_process_mesh()
    if pm is None:
        raise PreconditionNotMetError(
            "no ProcessMesh: pass process_mesh= or enter a `with "
            "ProcessMesh(...)` scope")
    spec = list(shard_spec) if shard_spec is not None else [None] * ndim
    if len(spec) < ndim:
        spec = spec + [None] * (ndim - len(spec))
    unknown = [s for s in spec if s is not None and s not in pm.dim_names]
    if unknown or len(spec) > ndim:
        raise ValueError(f"shard_spec {spec} does not fit a {ndim}-D tensor "
                         f"on {pm!r}")
    return DistAttr(pm, spec)


def _as_tensor(x, device=None):
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    from ...tensor.creation import to_tensor
    return to_tensor(np.asarray(x), place=device)


def shard_tensor(x, process_mesh=None, shard_spec=None, dist_attr=None,
                 stop_gradient=None):
    """Annotate ``x`` with a placement: a tensor equal to ``x`` (its
    gradient flows to ``x``) carrying ``dist_attr``; a parameter is
    annotated in place and returned (module docstring)."""
    if isinstance(x, torch.nn.Parameter):
        x.dist_attr = dist_attr or _resolve(process_mesh, shard_spec,
                                            x.dim())
        return x
    t = _as_tensor(x)
    if not isinstance(x, torch.Tensor) and stop_gradient is False:
        t.requires_grad_(True)
    da = dist_attr or _resolve(process_mesh, shard_spec, t.dim())
    out = t.view_as(t)
    if stop_gradient:
        out = out.detach()
    elif stop_gradient is False and not out.requires_grad:
        out = out.detach().requires_grad_(True)
    out.dist_attr = da
    return out


def reshard(x, process_mesh=None, shard_spec=None, dist_attr=None):
    """Re-annotate ``x`` with another placement (the value stays)."""
    return shard_tensor(x, process_mesh, shard_spec, dist_attr)


def dtensor_from_fn(fn, process_mesh, shard_spec, *args, **kwargs):
    """``fn(*args, **kwargs)`` annotated with the placement: the whole
    value, made once and eagerly (module docstring)."""
    out = _as_tensor(fn(*args, **kwargs))
    out.dist_attr = _resolve(process_mesh, shard_spec, out.dim())
    return out


def shard_op(fn, process_mesh=None, in_shard_specs=None,
             out_shard_specs=None):
    """``fn`` with its tensor inputs and outputs annotated."""

    def wrapped(*args, **kwargs):
        pm = process_mesh or get_default_process_mesh()
        xs = list(args)
        if in_shard_specs is not None:
            for i, (a, sp) in enumerate(zip(xs, in_shard_specs)):
                if isinstance(a, torch.Tensor) and sp is not None:
                    xs[i] = shard_tensor(a, pm, sp)
        out = fn(*xs, **kwargs)
        if out_shard_specs is not None:
            if isinstance(out, (tuple, list)):
                if len(out_shard_specs) != len(out):
                    raise ValueError(
                        f"out_shard_specs has {len(out_shard_specs)} entries "
                        f"but the op returned {len(out)} outputs")
                out = type(out)(
                    shard_tensor(o, pm, sp) if sp is not None else o
                    for o, sp in zip(out, out_shard_specs))
            elif out_shard_specs[0] is not None:
                out = shard_tensor(out, pm, out_shard_specs[0])
        return out

    return wrapped


# -- Strategy and Engine ------------------------------------------------------

class _Section(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


class Strategy:
    """The Engine's configuration sections: amp, recompute, sharding,
    gradient_merge, pipeline."""

    def __init__(self):
        self.auto_mode = "semi"
        self.amp = _Section(enable=False, dtype="bfloat16", level="O1")
        self.recompute = _Section(enable=False)
        self.sharding = _Section(enable=False, degree=1, stage=1)
        self.gradient_merge = _Section(enable=False, k_steps=1, avg=True)
        self.pipeline = _Section(enable=False, schedule_mode="1F1B")


class Engine:
    """A serial model, its loss and optimizer run data-parallel over the
    mesh's first dim, the parameters or the optimizer's state optionally
    ZeRO-sharded (module docstring)."""

    def __init__(self, model, loss=None, optimizer=None, metrics=None,
                 strategy=None, process_mesh=None):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics or []
        self.strategy = strategy or Strategy()
        self._pm = process_mesh
        self._network = None    # the model, or its DataParallel
        self._step_fn = None
        self._eval_fn = None
        self._prepared = False
        self.history = []

    def _mesh(self):
        pm = self._pm or get_default_process_mesh()
        if pm is None:
            pm = ProcessMesh(np.arange(max(get_world_size(), 1)),
                             dim_names=["x"])
        return pm

    def _data_axis(self, pm):
        return pm.dim_names[0]

    def _data_group(self, pm):
        """The group the batch splits over (None: every rank sees it
        whole)."""
        axis = self._data_axis(pm)
        if get_world_size() <= 1 or pm.get_dim_size(axis) <= 1:
            return None
        return pm.mesh_groups.group(axis)

    def _device(self):
        p = next(iter(self.model.parameters()), None)
        return p.device if p is not None else None

    def _split(self, pm, t):
        """Whether ``t`` splits over the data ranks: not at one rank, nor
        a partial final batch or a scalar, which every rank takes whole
        (the reference keeps them replicated)."""
        group = self._data_group(pm)
        deg = pm.get_dim_size(self._data_axis(pm))
        return group is not None and t.dim() > 0 and t.shape[0] % deg == 0

    def _shard_batch(self, pm, *tensors):
        deg = pm.get_dim_size(self._data_axis(pm))
        return tuple(t.chunk(deg, 0)[self._data_group(pm).rank]
                     if self._split(pm, t) else t for t in tensors)

    @staticmethod
    def _xy(batch, who):
        if isinstance(batch, (tuple, list)) and len(batch) == 2:
            return batch[0], batch[1]
        raise ValueError(
            f"Engine.{who} needs (x, y) batches; got a "
            f"{type(batch).__name__} — pass (inputs, labels) or a loader "
            f"yielding pairs (bare arrays are only valid for predict())")

    def _check_annotations(self, pm):
        axis = self._data_axis(pm)
        for name, p in self.model.named_parameters():
            da = getattr(p, "dist_attr", None)
            other = [s for s in (da.shard_spec if da is not None else ())
                     if s is not None and s != axis]
            if other:
                raise NotImplementedError(
                    f"Engine: parameter {name!r} is annotated over mesh "
                    f"axis {other[0]!r}, which is not the data axis "
                    f"{axis!r}; the port has no sharding propagation, so "
                    f"split a layer over ranks with fleet's tensor-parallel "
                    f"layers (distributed.fleet.meta_parallel: "
                    f"ColumnParallelLinear, RowParallelLinear, "
                    f"VocabParallelEmbedding)")

    def prepare(self, *args, **kwargs):
        """Apply the strategy before the first step: sharding (ZeRO-1 at
        stage 1 or 2, ZeRO-3 at stage 3, over the data axis), the
        data-parallel wrapper at world size > 1. Knobs with no wiring
        raise rather than silently do nothing. Idempotent."""
        if self._prepared:
            return self
        s = self.strategy
        if s.pipeline.enable:
            raise NotImplementedError(
                "Engine pipeline scheduling is provided by "
                "fleet.meta_parallel (spmd_pipeline); Engine-level 1F1B is "
                "not wired yet")
        if s.recompute.enable:
            raise NotImplementedError(
                "enable recompute at the model level with "
                "paddle.distributed.fleet.utils.recompute(layer_fn, ...) — "
                "Engine cannot rewrite a constructed Layer")
        pm = self._mesh()
        axis = self._data_axis(pm)
        self._check_annotations(pm)
        if s.sharding.enable and self.optimizer is not None:
            from ..fleet.sharding_optimizer import ShardingOptimizerWrapper
            if pm.get_dim_size(axis) <= 1:
                raise ValueError(
                    f"strategy.sharding.enable needs a mesh axis with degree "
                    f">1 to shard over; '{axis}' has degree "
                    f"{pm.get_dim_size(axis)}")
            self.optimizer = ShardingOptimizerWrapper(
                self.optimizer, axis=axis, group=self._data_group(pm),
                shard_params=int(s.sharding.stage) >= 3)
        group = self._data_group(pm)
        self._network = self.model
        if group is not None:
            from ..parallel import DataParallel
            self._network = DataParallel(self.model, group=group)
        self._prepared = True
        return self

    def _global_loss(self, pm, loss):
        """The loss averaged over the data ranks."""
        group = self._data_group(pm)
        if group is None:
            return loss
        from ..collective import ReduceOp, all_reduce
        return all_reduce(loss.detach().clone(), op=ReduceOp.AVG,
                          group=group)

    def _build_step(self):
        from ... import amp
        from ...jit import to_static
        from ..parallel import DataParallel
        s = self.strategy
        amp_on, amp_dtype = bool(s.amp.enable), s.amp.dtype
        amp_level = s.amp.level
        merge_k = int(s.gradient_merge.k_steps) \
            if s.gradient_merge.enable else 1
        avg = bool(s.gradient_merge.avg)
        self._merge_ct = 0
        if merge_k > 1:
            # the accumulating and the stepping calls are two programs over
            # the same gradient tensors
            for p in self.model.parameters():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        network, engine = self._network, self

        def body(x, y, do_step):
            sync = network.no_sync() if isinstance(network, DataParallel) \
                and not do_step else contextlib.nullcontext()
            with sync:
                with amp.auto_cast(enable=amp_on, dtype=amp_dtype,
                                   level=amp_level):
                    loss = engine.loss(network(x), y)
                (loss / merge_k if merge_k > 1 and avg else loss).backward()
            if do_step:
                engine.optimizer.step()
                engine.optimizer.clear_grad(set_to_zero=merge_k > 1)
            return loss
        step = to_static(body) if get_world_size() <= 1 else body

        def run_step(x, y):
            self._merge_ct += 1
            return step(x, y, self._merge_ct % merge_k == 0)
        return run_step

    def fit(self, train_data, epochs=1, batch_size=None, steps_per_epoch=None,
            log_freq=10, verbose=0):
        pm = self._mesh()
        self.prepare()
        if self._step_fn is None:
            self._step_fn = self._build_step()
        device = self._device()
        losses = []
        for _ in range(epochs):
            for i, batch in enumerate(_iter_batches(train_data, batch_size)):
                x, y = self._xy(batch, "fit")
                x, y = self._shard_batch(pm, _as_tensor(x, device),
                                         _as_tensor(y, device))
                loss = self._global_loss(pm, self._step_fn(x, y))
                losses.append(float(loss.item()))
                if steps_per_epoch and i + 1 >= steps_per_epoch:
                    break
            self.history.append(losses[-1] if losses else None)
        return {"loss": losses}

    def evaluate(self, eval_data, batch_size=None, steps=None):
        from ...jit import to_static
        pm = self._mesh()
        self.prepare()
        network, engine = self._network, self
        if self._eval_fn is None:
            def estep(x, y):
                return engine.loss(network(x), y)
            self._eval_fn = to_static(estep) if get_world_size() <= 1 \
                else estep
        device = self._device()
        total, n = 0.0, 0
        was_training = self.model.training
        self.model.eval()
        try:
            for i, batch in enumerate(_iter_batches(eval_data, batch_size)):
                bx, by = self._xy(batch, "evaluate")
                x, y = self._shard_batch(pm, _as_tensor(bx, device),
                                         _as_tensor(by, device))
                with torch.no_grad():
                    loss = self._global_loss(pm, self._eval_fn(x, y))
                total += float(loss.item())
                n += 1
                if steps and i + 1 >= steps:
                    break
        finally:
            if was_training:
                self.model.train()
        return {"eval_loss": total / max(n, 1)}

    def predict(self, data, batch_size=None, steps=None):
        pm = self._mesh()
        self.prepare()
        device = self._device()
        group = self._data_group(pm)
        outs = []
        was_training = self.model.training
        self.model.eval()
        try:
            for i, batch in enumerate(_iter_batches(data, batch_size)):
                x = _as_tensor(batch[0] if isinstance(batch, (tuple, list))
                               else batch, device)
                split = self._split(pm, x)
                (x,) = self._shard_batch(pm, x)
                with torch.no_grad():
                    out = self._network(x)
                if split:
                    # the ranks' outputs back to the whole batch, as the
                    # reference's output holds it
                    from ..collective import all_gather
                    out = torch.cat(all_gather([], out.contiguous(),
                                               group=group))
                outs.append(out)
                if steps and i + 1 >= steps:
                    break
        finally:
            if was_training:
                self.model.train()
        return outs

    def cost(self, mode="train"):
        return estimate_cost(self.model, self._mesh())


def _iter_batches(data, batch_size):
    """A DataLoader-like iterable, a single array (x only), an (x, y)
    TUPLE pair, or a list of prepared batches. A bare array is one
    dataset sliced by batch_size (never iterated row by row); only a
    2-TUPLE of equal-length arrays is an (x, y) pair; a list is always a
    list of batches."""
    if hasattr(data, "shape"):
        x = np.asarray(data)
        bs = batch_size or len(x)
        for i in range(0, len(x), bs):
            yield x[i:i + bs]
        return
    if (isinstance(data, tuple) and len(data) == 2
            and hasattr(data[0], "shape") and hasattr(data[1], "shape")):
        x, y = np.asarray(data[0]), np.asarray(data[1])
        if x.ndim == 0 or y.ndim == 0 or len(x) != len(y):
            raise ValueError(
                f"(x, y) pair with mismatched lengths: {x.shape} vs "
                f"{y.shape}")
        bs = batch_size or len(x)
        for i in range(0, len(x), bs):
            yield x[i:i + bs], y[i:i + bs]
        return
    yield from data


def estimate_cost(model, process_mesh=None):
    """The analytic cost model: parameters, their bytes, the bytes per
    device under the mesh and a FLOPs estimate for one forward."""
    n_params = sum(p.numel() for p in model.parameters())
    bytes_total = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    n_dev = (int(np.prod(process_mesh.shape))
             if process_mesh is not None else 1)
    return {
        "params": n_params,
        "param_bytes": bytes_total,
        "param_bytes_per_device": bytes_total // max(n_dev, 1),
        "flops_forward_approx": 2 * n_params,
        "devices": n_dev,
    }
