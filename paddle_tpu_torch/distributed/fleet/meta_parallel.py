"""Tensor-parallel layers and the hybrid-parallel wrappers (port of
paddle_tpu/distributed/fleet/meta_parallel.py).

The reference's tensor-parallel (TP) layers hold their full parameters
with a ``PartitionSpec`` over the "model" axis and let GSPMD insert the
collectives. The port runs one process per rank, so each rank holds its
shard and calls the collectives itself, as upstream Paddle's
``mp_layers.py`` and Megatron do:

- ``VocabParallelEmbedding``: rows [r·V/m, (r+1)·V/m) on model rank r of
  m; an id outside them reads a zero row, and the ranks' rows are summed
  (``_mp_allreduce``).
- ``ColumnParallelLinear``: output columns [r·N/m, (r+1)·N/m) and their
  bias; the input goes through ``_c_identity`` (its gradient summed over
  the ranks); ``gather_output`` all-gathers the last axis.
- ``RowParallelLinear``: input rows [r·K/m, (r+1)·K/m); the partial
  products are summed (``_mp_allreduce``) and the full bias is added
  once, after the sum.
- ``ParallelCrossEntropy``: the softmax cross-entropy of this rank's
  vocabulary shard of the logits (nn/functional/loss.py
  ``_ShardedSoftmaxCE``, shared with ``margin_cross_entropy``). The
  reference's layer takes the gathered logits (ROADMAP C-ref-22).

Each distributed parameter carries ``tp_split`` (the reference's
``is_distributed``; torch's tensors have a method of that name): the
axis it is split on, the number of blocks the axis holds, this
rank, the ranks and the group. ``load_numpy_state_dict`` gives a
distributed parameter its shard of a full array, and
``full_state_dict`` gathers the shards back into the reference's full
layouts (framework/io_utils.py). A fused projection whose axis holds
several blocks (GPT's qkv: q, k and v) is split block by block
(``mark_blocks``), so a rank takes its heads of each.

Without a "model" axis on the mesh (no ``fleet.init`` with mp_degree >
1) the layers hold everything and communicate nothing.

The wrappers: ``TensorParallel`` and ``ShardingParallel`` broadcast at
wrap time every parameter that is not distributed from the first rank of
the model and sharding groups (and every parameter over the data group),
and reduce the gradients over the data and sharding ranks with the
ported ``Reducer``. ``HybridParallelOptimizer`` makes a
``ClipGradByGlobalNorm`` take the global norm: squares of the shards
summed over the model group, replicated parameters counted once, over
the sharding group where ZeRO-1 splits the parameters and over the pipe
group, each shared (tied) parameter counted on its first stage only; a
``ClipGradByNorm`` takes each parameter's full norm, a shard's squares
summed over the model group.

``PipelineLayer`` under ``fleet.init`` with ``pp_degree == num_stages >
1`` builds only this rank's segment of the layer list (its stage: the
rank's pipe coordinate), each layer named by its index in the whole list
(``run_function.{i}``), so a stage's state carries the names of a
one-stage ``PipelineLayer`` of the same descriptions. ``PipelineParallel``
runs it with the 1F1B engine (pipeline_engine.py); a whole
``PipelineLayer`` trains by micro-batch accumulation, as before.
"""
from __future__ import annotations

import contextlib
from collections import namedtuple

import torch

from ...nn import functional as F
from ...nn import initializer as I
from ...nn.clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                        _f32_norms)
from ...nn.functional.loss import _ShardedSoftmaxCE
from ...nn.layer.layers import Layer
from ..collective import (_c_identity, _mp_allreduce, all_gather,
                          all_reduce, broadcast, get_group)
from ..env import get_world_size
from ..mesh import get_mesh

__all__ = [
    "VocabParallelEmbedding", "ColumnParallelLinear", "RowParallelLinear",
    "ParallelCrossEntropy", "TensorParallel", "PipelineParallel",
    "ShardingParallel", "HybridParallelOptimizer", "LayerDesc",
    "SharedLayerDesc", "PipelineLayer", "get_rng_state_tracker",
    "RNGStatesTracker", "model_parallel_random_seed", "mark_blocks",
]

# how a distributed parameter is split: along ``axis``, which holds
# ``blocks`` equal blocks, each cut in ``nranks`` pieces, ``rank``'s kept
TPSplit = namedtuple("TPSplit", "axis blocks rank nranks group")


def _model_group(mp_group=None):
    """The group a TP layer splits over: the one given, else the mesh's
    "model" axis (None without one: the layer is whole)."""
    if mp_group is not None:
        return mp_group
    mesh = get_mesh()
    return mesh.group("model") if "model" in mesh.axis_names else None


def _degree(group):
    return 1 if group is None else group.nranks


def _mark(param, axis, group):
    param.tp_split = TPSplit(axis, 1, max(group.rank, 0), group.nranks,
                             group) if _degree(group) > 1 else None
    return param


def mark_blocks(layer, blocks):
    """Record that the split axis of ``layer``'s distributed weight and
    bias holds ``blocks`` equal blocks (GPT's fused qkv: 3): a rank's
    shard is its piece of each block."""
    for p in (layer.weight, getattr(layer, "bias", None)):
        if p is not None and getattr(p, "tp_split", None) is not None:
            p.tp_split = p.tp_split._replace(blocks=blocks)


class _GatherLast(torch.autograd.Function):
    """Forward: the ranks' pieces concatenated on the last axis; backward:
    this rank's piece of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = []
        all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return grad.chunk(g.nranks, dim=-1)[g.rank].contiguous(), None


class _SplitLast(torch.autograd.Function):
    """Forward: this rank's piece of the last axis; backward: the ranks'
    gradient pieces concatenated."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.chunk(group.nranks, dim=-1)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        parts = []
        all_gather(parts, grad.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=-1), None


class RNGStatesTracker:
    """Named random states (``torch.Generator``s), so that dropout inside a
    TP region draws distinct masks on each model rank and dropout on the
    replicated stream the same mask on every rank. Inside
    ``rng_state(name)`` a draw that names no generator (dropout's default)
    comes from the named state, as the reference's swap of its default
    generator makes it."""

    def __init__(self):
        self.states = {}

    def add(self, name, seed, device="cpu"):
        if name in self.states:
            raise ValueError(f"state {name!r} already exists")
        self.states[name] = torch.Generator(device=device).manual_seed(
            int(seed))

    def reset(self):
        self.states = {}

    def generator(self, name="model_parallel_rng", default=None):
        """The named generator; ``default`` where it was never added."""
        return self.states.get(name, default)

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        """Torch's default generator of the named state's device draws
        from the named state inside the block (Megatron's swap of states):
        on exit the named state has advanced by the block's draws and the
        default one is where it was. Yields that default generator, so a
        draw given it explicitly takes the same stream."""
        if name not in self.states:
            raise ValueError(f"state {name!r} does not exist")
        gen = self.states[name]
        dev = gen.device
        default = torch.cuda.default_generators[
            dev.index if dev.index is not None
            else torch.cuda.current_device()] \
            if dev.type == "cuda" else torch.default_generator
        saved = default.get_state()
        default.set_state(gen.get_state())
        try:
            yield default
        finally:
            gen.set_state(default.get_state())
            default.set_state(saved)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_TRACKER


def model_parallel_random_seed(seed=None, device=None):
    """Seed the tracker: "global_seed" the same on every rank,
    "model_parallel_rng" offset by this rank's model coordinate (the
    reference draws one mask over a whole sharded tensor, so each shard
    sees another part of it; here each rank draws its own)."""
    import random

    from ...core.device import resolve_device
    base = int(seed) if seed is not None else random.randint(0, 2 ** 31)
    group = _model_group()
    rank = max(group.rank, 0) if group is not None else 0
    device = resolve_device(device)
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("global_seed", base, device)
    _RNG_TRACKER.add("model_parallel_rng", base + 1024 + rank, device)


def _local(n, group, what):
    m = _degree(group)
    if n % m:
        raise ValueError(f"{what} ({n}) is not divisible by the {m} model "
                         f"ranks")
    return n // m


class VocabParallelEmbedding(Layer):
    """The table's rows split over the model ranks (module docstring)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, **factory):
        super().__init__(**factory)
        self.group = _model_group(mp_group)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.per_rank = _local(num_embeddings, self.group, "num_embeddings")
        self.vocab_start = max(self.group.rank, 0) * self.per_rank \
            if self.group is not None else 0
        self.weight = _mark(self.create_parameter(
            shape=[self.per_rank, embedding_dim], attr=weight_attr,
            default_initializer=I.XavierNormal(num_embeddings,
                                               embedding_dim)),
            0, self.group)

    def forward(self, x):
        if _degree(self.group) == 1:
            return F.embedding(x, self.weight)
        local = x - self.vocab_start
        mine = (local >= 0) & (local < self.per_rank)
        out = F.embedding(torch.where(mine, local, 0), self.weight)
        out = out.masked_fill(~mine.unsqueeze(-1), 0.0)
        return _mp_allreduce(out, self.group)


class ColumnParallelLinear(Layer):
    """Weight (in, out / m) and bias (out / m): this rank's output
    columns (module docstring)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, mp_group=None, name=None,
                 fuse_matmul_bias=False, **factory):
        super().__init__(**factory)
        self.group = _model_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        local = _local(out_features, self.group, "out_features")
        self.weight = _mark(self.create_parameter(
            shape=[in_features, local], attr=weight_attr,
            default_initializer=I.XavierNormal(in_features, out_features)),
            1, self.group)
        self.bias = _mark(self.create_parameter(
            shape=[local], attr=None, is_bias=True), 0, self.group) \
            if has_bias else None

    def forward(self, x):
        if _degree(self.group) == 1:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(_c_identity(x, self.group), self.weight, self.bias)
        return _GatherLast.apply(out, self.group) if self.gather_output \
            else out


class RowParallelLinear(Layer):
    """Weight (in / m, out): this rank's input rows; the bias is full,
    added once after the ranks' products are summed (module
    docstring)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False, mp_group=None,
                 name=None, fuse_matmul_bias=False, **factory):
        super().__init__(**factory)
        self.group = _model_group(mp_group)
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        local = _local(in_features, self.group, "in_features")
        self.weight = _mark(self.create_parameter(
            shape=[local, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal(in_features, out_features)),
            0, self.group)
        self.bias = self.create_parameter(
            shape=[out_features], attr=None, is_bias=True) if has_bias \
            else None

    def forward(self, x):
        if _degree(self.group) == 1:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = _SplitLast.apply(x, self.group)
        out = _mp_allreduce(F.linear(x, self.weight), self.group)
        return out if self.bias is None else out + self.bias


class ParallelCrossEntropy(Layer):
    """Softmax cross-entropy (f32, no reduction) of this rank's shard of
    the logits' last axis (classes [r·C, (r+1)·C)) against the global
    labels; ``ignore_index`` positions give 0. Upstream Paddle's
    ``c_softmax_with_cross_entropy``; the reference's layer takes the
    gathered logits (ROADMAP C-ref-22)."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.group = _model_group(mp_group)
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        x = input.float()
        n_cls = x.shape[-1]
        rows = x.reshape(-1, n_cls)
        lb = label.reshape(-1).long()
        valid = lb != self.ignore_index
        local = lb - max(self.group.rank, 0) * n_cls \
            if self.group is not None else lb
        owned = valid & (local >= 0) & (local < n_cls)
        group = self.group if _degree(self.group) > 1 else None
        loss, _ = _ShardedSoftmaxCE.apply(
            rows, torch.where(owned, local, -1), valid, group)
        return loss.reshape(x.shape[:-1])


# -- the wrappers --------------------------------------------------------------

def _broadcast_params(params, src, group):
    """``src``'s values of ``params`` into every member's, one broadcast
    of a flat buffer per (device, dtype)."""
    by_kind = {}
    for p in params:
        by_kind.setdefault((p.device, p.dtype), []).append(p)
    with torch.no_grad():
        for ps in by_kind.values():
            flat = torch.cat([p.detach().reshape(-1) for p in ps])
            broadcast(flat, src=src, group=group)
            ofs = 0
            for p in ps:
                n = p.numel()
                p.copy_(flat[ofs:ofs + n].view(p.shape))
                ofs += n


def _is_distributed(p):
    """Whether ``p`` is a shard (torch's own ``Tensor.is_distributed`` is
    a method, so the port marks shards by ``tp_split`` alone)."""
    return getattr(p, "tp_split", None) is not None


class _ParallelWrapper(Layer):
    def __init__(self, layers, hcg, strategy=None, reducer=True):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        self._reducer = None
        if hcg is None:
            return
        params = list(layers.parameters())
        for group, which in (
                (hcg.get_model_parallel_group(), "replicated"),
                (hcg.get_sharding_parallel_group(), "replicated"),
                (hcg.get_data_parallel_group(), "all")):
            if group.nranks > 1:
                _broadcast_params(
                    [p for p in params
                     if which == "all" or not _is_distributed(p)],
                    group.global_rank(0), group)
        group = hcg.get_dp_sharding_parallel_group()
        if reducer and group.nranks > 1:
            from ..reducer import Reducer
            mb = getattr(strategy, "fuse_grad_size_in_MB", 25) \
                if strategy is not None else 25
            self._reducer = Reducer(params, comm_buffer_size=mb, group=group)

    @property
    def captures(self):
        """A step with collectives cannot be captured in a CUDA graph."""
        return self._hcg is None or self._hcg.topology().world_size() == 1

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.set_state_dict(sd, *a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)


class TensorParallel(_ParallelWrapper):
    """A model of TP layers: replicated parameters broadcast over the
    model group at wrap time, gradients reduced over the data ranks."""


class ShardingParallel(_ParallelWrapper):
    """A model under ZeRO-1 (sharding_optimizer.py): parameters broadcast
    over the sharding group at wrap time, gradients reduced over the
    sharding and data ranks."""


class LayerDesc:
    """A layer to build: ``layer_func(*inputs, **kwargs)``."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """A layer built once and used wherever its ``key`` appears (a tied
    embedding and head); ``forward_func(layer, x)``, when given, is how a
    later appearance calls it."""

    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _GlobalLayers(Layer):
    """A PipelineLayer's layers, each under its index in the whole list:
    ``layers[i]`` is the layer of description i (a shared layer under the
    index of its key's first description)."""

    def __getitem__(self, i):
        return self._modules[str(i)]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)


def _pipe_stage(num_stages):
    """(this rank's stage, the pipe group) where the mesh's pipe axis has
    ``num_stages`` ranks (> 1), else (None, None): the layer is built
    whole."""
    if num_stages <= 1:
        return None, None
    mesh = get_mesh()
    if mesh.shape.get("pipe", 1) != num_stages:
        return None, None
    group = mesh.group("pipe")
    return group.rank, group


def _stage_groups(stages):
    """For every other coordinate of the mesh, the group of the ranks of
    ``stages`` on the pipe axis; every rank creates all of them, in one
    order. Returns this rank's (None where it holds none of the
    stages)."""
    import numpy as np

    from ..collective import new_group
    from ..env import get_rank
    mesh = get_mesh()
    axis = mesh.axis_names.index("pipe")
    rows = np.moveaxis(mesh.ranks, axis, -1).reshape(-1,
                                                     mesh.shape["pipe"])
    mine = None
    for row in rows:
        g = new_group([int(row[s]) for s in stages], axis="pipe_shared")
        if get_rank() in g.ranks:
            mine = g
    return mine


class PipelineLayer(Layer):
    """A model declared as a list of layers, descriptions and callables.
    Built whole where the mesh's pipe axis does not have ``num_stages``
    ranks (then ``num_stages > 1`` is refused by ``PipelineParallel``'s
    engine); under ``fleet.init`` with ``pp_degree == num_stages > 1``,
    only this rank's segment (``seg_method`` "uniform" cuts the
    description list; "layer:param" builds every layer once to count its
    parameters, as the reference cuts the built list, and keeps its
    segment's). A ``SharedLayerDesc`` is built once a stage; a later
    appearance calls ``forward_func(layer, x)`` where given. The shared
    parameter (``shared_weight_attr``) of a key used on several stages is
    listed in ``_shared`` as (key, parameter, the group of the ranks that
    hold it)."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0, **kwargs):
        super().__init__()
        from .pipeline_engine import _segment_by_params, _segment_uniform
        self.descs = list(layers)
        self.loss_fn = loss_fn
        self.num_stages = int(num_stages or 1)
        self.seg_method = seg_method
        n = len(self.descs)
        if self.num_stages > n:
            raise ValueError(f"num_stages ({self.num_stages}) exceeds layer "
                             f"count ({n})")
        first = {}
        for i, d in enumerate(self.descs):
            if isinstance(d, SharedLayerDesc):
                first.setdefault(d.layer_name, i)
        self.stage_id, group = _pipe_stage(self.num_stages)
        built = None
        if group is None:
            bounds = [(0, n)]
        else:
            if str(seg_method).endswith("param"):
                built = self._build_all()
                segs = _segment_by_params(built, self.num_stages)
                lengths = [len(seg) for seg in segs]
            else:
                lengths = [len(seg) for seg in _segment_uniform(
                    list(range(n)), self.num_stages)]
            starts = [sum(lengths[:s]) for s in range(self.num_stages)]
            bounds = [(a, a + b) for a, b in zip(starts, lengths)]
        lo, hi = bounds[self.stage_id or 0]
        self.segment = (lo, hi)
        self.run_function = _GlobalLayers()
        self._calls, shared = [], {}
        for i in range(lo, hi):
            d = self.descs[i]
            if isinstance(d, SharedLayerDesc):
                key = d.layer_name
                layer = shared.get(key)
                if layer is None:
                    layer = built[i] if built else d.build_layer()
                    shared[key] = layer
                    self.run_function.add_module(str(first[key]), layer)
                fn = d.forward_func
                self._calls.append(
                    (lambda x, m=layer, f=fn: f(m, x))
                    if fn is not None and i != first[key] else layer)
                continue
            layer = (built[i] if built else d.build_layer()) \
                if isinstance(d, LayerDesc) else d
            if isinstance(layer, torch.nn.Module):
                self.run_function.add_module(str(i), layer)
            self._calls.append(layer)
        self._shared = []
        if group is not None:
            self._share(first, bounds, shared)

    def _build_all(self):
        """Every description built once, a shared key's later appearances
        the same layer (the reference's built list)."""
        built, by_key = [], {}
        for d in self.descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in by_key:
                    by_key[d.layer_name] = d.build_layer()
                built.append(by_key[d.layer_name])
            else:
                built.append(d.build_layer() if isinstance(d, LayerDesc)
                             else d)
        return built

    def _share(self, first, bounds, shared):
        """The groups of the ranks that hold each key used on several
        stages, and this stage's shared parameters among them."""
        import functools
        stage_of = [s for s, (a, b) in enumerate(bounds)
                    for _ in range(a, b)]
        uses = {}
        for i, d in enumerate(self.descs):
            if isinstance(d, SharedLayerDesc):
                uses.setdefault(d.layer_name, set()).add(stage_of[i])
        for key in sorted(uses, key=first.get):
            stages = sorted(uses[key])
            if len(stages) < 2:
                continue
            group = _stage_groups(stages)
            if key in shared:
                attr = self.descs[first[key]].shared_weight_attr
                param = functools.reduce(getattr, attr.split("."),
                                         shared[key])
                # counted once by the global-norm clip: on its first stage
                param.pp_shared_copy = self.stage_id != stages[0]
                self._shared.append((key, param, group))

    def forward(self, x):
        for call in self._calls:
            x = call(x)
        return x


class PipelineParallel(_ParallelWrapper):
    """``train_batch``/``eval_batch``: a ``PipelineLayer`` of several
    stages through the 1F1B engine (pipeline_engine.py), each rank its
    stage; a model built whole with the batch cut into
    ``pipeline_configs["accumulate_steps"]`` micro-batches whose gradients
    accumulate before one optimizer step. ``pp_degree > 1`` needs a
    ``PipelineLayer`` of as many stages."""

    def __init__(self, layers, hcg, strategy=None):
        pp = hcg.get_pipe_parallel_world_size() if hcg is not None else 1
        staged = isinstance(layers, PipelineLayer) and layers.num_stages > 1
        if pp > 1 and not staged:
            raise ValueError(
                f"pp_degree {pp} needs a PipelineLayer with num_stages="
                f"{pp}: each rank runs its stage")
        super().__init__(layers, hcg, strategy, reducer=not staged)
        cfgs = getattr(strategy, "pipeline_configs", {}) or {}
        self.accumulate_steps = cfgs.get("accumulate_steps", 1)
        self._engine = None
        if staged:
            from .pipeline_engine import PipelineEngine
            self._engine = PipelineEngine(
                layers, num_microbatches=max(self.accumulate_steps, 1),
                seg_method=layers.seg_method, hcg=hcg)

    def _loss(self, x, y):
        out = self._layers(x)
        loss_fn = getattr(self._layers, "loss_fn", None)
        loss = loss_fn(out, y) if loss_fn is not None else out
        return loss.mean() if loss.ndim > 0 else loss

    def _step(self, optimizer, lr_scheduler, scaler):
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One optimizer step over the batch; returns the mean of the
        micro-batches' losses. Through the engine a GradScaler's scale
        seeds the backward (its ``step`` then unscales), as in the
        reference."""
        inputs, labels = data
        if self._engine is not None:
            scale = scaler._scale if scaler is not None and \
                scaler.is_enable() else None
            loss = self._engine.train_batch(inputs, labels, scale=scale)
            self._step(optimizer, lr_scheduler, scaler)
            return loss
        micro = self.accumulate_steps
        xs = inputs.chunk(micro) if micro > 1 else [inputs]
        ys = labels.chunk(micro) if micro > 1 else [labels]
        total = None
        for xm, ym in zip(xs, ys):
            loss = self._loss(xm, ym)
            scaled = loss if micro == 1 else loss / micro
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            total = loss.detach() if total is None else total + loss.detach()
        self._step(optimizer, lr_scheduler, scaler)
        return total / micro

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        inputs, labels = data
        if self._engine is not None:
            return self._engine.eval_batch(inputs, labels,
                                           compute_loss=compute_loss)
        if compute_loss and getattr(self._layers, "loss_fn", None):
            return self._loss(inputs, labels)
        return self._layers(inputs)


class _HybridGlobalNormClip(ClipGradBase):
    """A ``ClipGradByGlobalNorm`` over shards and stages: the squares of
    distributed parameters' grads summed over the model group, the
    replicated ones counted once, and the sum over the sharding group
    (each rank updates only its own parameters) and over the pipe group
    (each stage holds its own), a shared parameter counted on its first
    stage only."""

    def __init__(self, clip, model_group, sharding_group=None,
                 pipe_group=None):
        self.clip_norm = clip.clip_norm
        self.inner = clip
        self.model_group = model_group
        self.sharding_group = sharding_group
        self.pipe_group = pipe_group

    def _clip(self, params_grads):
        picked = [(p, g) for p, g in params_grads
                  if g is not None and getattr(p, "need_clip", True)]
        dev = picked[0][1].device if picked else torch.device("cpu")
        sq = torch.zeros(2, dtype=torch.float32, device=dev)
        for p, g in picked:
            if not getattr(p, "pp_shared_copy", False):
                sq[int(_is_distributed(p))] += g.float().pow(2).sum()
        if _degree(self.model_group) > 1:
            dist_sq = all_reduce(sq[1:].clone(), group=self.model_group)
            sq = torch.cat([sq[:1], dist_sq])
        total = sq.sum().reshape(1)
        for group in (self.sharding_group, self.pipe_group):
            if _degree(group) > 1:
                total = all_reduce(total, group=group)
        scale = self.clip_norm / torch.clamp(total[0].sqrt(),
                                             min=self.clip_norm)
        return [(p, g * scale.to(g.dtype)
                 if g is not None and getattr(p, "need_clip", True) else g)
                for p, g in params_grads]


class _HybridNormClip(ClipGradBase):
    """A ``ClipGradByNorm`` over shards: each parameter clipped by its
    full norm, a distributed parameter's squares summed over the model
    group (one all-reduce of all of them)."""

    def __init__(self, clip, model_group):
        self.clip_norm = clip.clip_norm
        self.inner = clip
        self.model_group = model_group

    def _clip(self, params_grads):
        picked = [(p, g) for p, g in params_grads
                  if g is not None and getattr(p, "need_clip", True)]
        if not picked:
            return params_grads
        norms = list(_f32_norms([g for _, g in picked]))
        split = [i for i, (p, _) in enumerate(picked) if _is_distributed(p)]
        if split:
            sq = torch.stack([norms[i] for i in split]).pow(2)
            all_reduce(sq, group=self.model_group)
            for j, i in enumerate(split):
                norms[i] = sq[j].sqrt()
        scales = {id(p): torch.clamp(self.clip_norm / n.clamp_min(1e-12),
                                     max=1.0)
                  for (p, _), n in zip(picked, norms)}
        return [(p, g * scales[id(p)].to(g.dtype) if id(p) in scales else g)
                for p, g in params_grads]


def _innermost(opt):
    while hasattr(opt, "_inner"):
        opt = opt._inner
    return opt


class HybridParallelOptimizer:
    """Wraps the (ZeRO / gradient-merge wrapped) optimizer; its global-norm
    clip takes the norm over every shard and stage
    (``_HybridGlobalNormClip``), its per-parameter clip each parameter's
    full norm (``_HybridNormClip``). A GradScaler reduces its
    ``found_inf`` over every rank of the job (``_found_inf_group``,
    amp/grad_scaler.py), since each rank checks only its shards."""

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._found_inf_group = get_group(0) if get_world_size() > 1 \
            else getattr(optimizer, "_found_inf_group", None)
        base = _innermost(optimizer)
        clip = getattr(base, "_grad_clip", None)
        mp = hcg.get_model_parallel_group() if hcg is not None else None
        pipe = hcg.get_pipe_parallel_group() if hcg is not None else None
        sharded = getattr(optimizer, "_sharding_group", None)
        if isinstance(clip, ClipGradByGlobalNorm) and any(
                _degree(g) > 1 for g in (mp, sharded, pipe)):
            base._grad_clip = _HybridGlobalNormClip(clip, mp, sharded, pipe)
        elif isinstance(clip, ClipGradByNorm) and _degree(mp) > 1:
            base._grad_clip = _HybridNormClip(clip, mp)

    def __getattr__(self, name):
        # step, minimize, clear_grad and the rest: the wrapped optimizer's
        return getattr(self._inner, name)
