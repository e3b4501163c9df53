"""The 1F1B pipeline engine (port of paddle_tpu/distributed/fleet/
pipeline_engine.py).

The reference has one controller: a host loop issues every (stage,
micro-batch, F|B) unit, each stage's parameters sit on a sub-mesh and
activations hop between sub-meshes by ``device_put``. The port runs one
process per rank, as upstream Paddle's ``pipeline_parallel.py`` does:
each rank holds only its stage (``PipelineLayer`` builds this rank's
segment, fleet/meta_parallel.py) and walks its own queue of the
reference's unit order (``unit_order``: warm-up forwards, then one
forward and one backward in turn, then the cool-down backwards). It
sends activations forward and cotangents backward to the ranks of its
pipe group (the rank of the next or previous stage with the same data,
sharding and model coordinates) with ``torch.distributed`` point-to-point
calls: sends are asynchronous and waited for at the end of the batch, a
receive blocks, so two neighbours never wait on each other's send.

- **Messages.** An activation is a tensor or a tuple of tensors (GPT's
  blocks pass ``(x, pending)``) whose entries may be None. Each hop sends
  an 8-byte control word, then the tensors: the word is the index of the
  value's signature (shapes and dtypes) in the link's table, or, the
  first time a signature crosses the link, the length of the header that
  describes it, sent next. A stage whose signature changes mid-run sends
  the header of the new one. On gloo a CUDA tensor is staged through the
  host, as the collectives do.
- **The backward** is the reference's full recompute: the forward runs
  without autograd and stashes only the stage's input (at most S - s
  stashed inputs on stage s); the backward reruns the forward under
  autograd and takes ``torch.autograd.grad`` of the outputs against the
  received cotangent (on the last stage the loss against the seed
  ``scale / M``, so that a GradScaler behaves as in the reference). The
  parameters' gradients add into per-parameter accumulators that become
  ``.grad`` after the batch (added to a ``.grad`` that is there).
- **Buffers** (BatchNorm's running statistics) move once a micro-batch:
  the rerun reads the values the forward read, and its own updates are
  undone.
- **Random draws.** The rerun draws the forward's dropout masks: the
  stage's generators (``fleet.utils``'s choice, the layers' own or the
  device's default) are put back to their states at the forward around
  the rerun, as ``recompute`` does eagerly. Each direction runs as a call
  of its own, also when captured, so no rerun happens inside a capture
  and the capture's ``RerunPlan`` (core/random.py) is not needed.
- **Shared (tied) parameters** (``SharedLayerDesc`` used on several
  stages): every stage that holds one starts from the first stage's copy
  (a broadcast over the ranks that share it), and after the backward the
  gradient is summed over them (upstream Paddle's
  ``allreduce_shared_weight_gradients``), so the copies stay bitwise
  equal.
- **Data parallelism and ZeRO-1 under the pipeline**: the gradients are
  averaged over the data and sharding ranks after the batch, in one
  all-reduce a (device, dtype) bucket.
- **Compiled stages** (``compiled=None`` follows ``FLAGS_compiled_step``,
  as the reference): each direction is a ``CompiledStageProgram``
  (jit/compiled_step.py), a CUDA graph per signature on the card. A stage
  whose body calls a collective (any stage under mp > 1: the
  tensor-parallel layers' all-reduces over gloo) cannot be captured; it
  runs eagerly, ``stats()["compiled_stages"]`` lists the stages that were
  captured and ``stats()["eager_reason"]`` says why the others were not,
  and a ``compiled=True`` that cannot be honoured warns.
- **The generation fence**: a hop whose collective generation
  (``resilience.recovery.current_generation``) moved since the batch
  began raises ``StaleGeneration``.
- A queue that cannot advance raises ``FatalError``.

The loss of a batch (the mean of the micro-batches' losses on the last
stage) is broadcast over the pipe group, so every stage returns it.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from collections import deque

import torch

from ...amp.auto_cast import snapshot as _amp_snapshot
from ...framework.errors import FatalError
from ...ops import autotune
from ..collective import ReduceOp, all_gather, all_reduce, broadcast
from .utils import _as_in_forward, _generators

__all__ = ["PipelineEngine", "unit_order"]

# the dtypes a header can name, by index
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)


def _segment_uniform(items, k):
    n = len(items)
    base, rem = divmod(n, k)
    out, i = [], 0
    for s in range(k):
        size = base + (1 if s < rem else 0)
        out.append(items[i:i + size])
        i += size
    return out


def _segment_by_params(layers, k):
    """Greedy contiguous split balancing parameter counts (the
    reference's, cut for cut)."""
    costs = []
    for ly in layers:
        n = sum(int(p.numel()) for p in ly.parameters()) \
            if hasattr(ly, "parameters") else 0
        costs.append(max(n, 1))
    total = sum(costs)
    target = total / k
    out, cur, acc, remaining_stages = [], [], 0.0, k
    for i, (ly, c) in enumerate(zip(layers, costs)):
        cur.append(ly)
        acc += c
        # must leave at least one layer per remaining stage
        remaining_layers = len(layers) - i - 1
        if (acc >= target and remaining_stages > 1
                and remaining_layers >= remaining_stages - 1):
            out.append(cur)
            cur, acc = [], 0.0
            remaining_stages -= 1
    out.append(cur)
    assert len(out) == k, (len(out), k)  # guard above reserves 1 layer/stage
    return out


def unit_order(num_stages, num_microbatches):
    """Per-stage unit queues in non-interleaved 1F1B order: warm-up
    forwards, one forward and one backward in turn, cool-down backwards
    (the reference's ``_unit_order``)."""
    S, M = num_stages, num_microbatches
    qs = []
    for s in range(S):
        warm = min(S - 1 - s, M)
        units = ["F"] * warm
        for _ in range(M - warm):
            units += ["F", "B"]
        units += ["B"] * warm
        qs.append(deque(units))
    return qs


def _is_float(t):
    return isinstance(t, torch.Tensor) and t.is_floating_point()


def _entries(value):
    return list(value) if isinstance(value, tuple) else [value]


def _rebuild(value, entries):
    return tuple(entries) if isinstance(value, tuple) else entries[0]


def _signature(value):
    return (isinstance(value, tuple),) + tuple(
        None if t is None else (str(t.dtype), tuple(t.shape))
        for t in _entries(value))


def _encode(value):
    """The header of ``value``: [is_tuple, n, then per entry the dtype's
    index (-1 for None), ndim and dims]."""
    ents = _entries(value)
    out = [int(isinstance(value, tuple)), len(ents)]
    for t in ents:
        if t is None:
            out.append(-1)
            continue
        out += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
    return out


def _decode(header):
    """[(dtype, shape) or None, ...] and whether the value is a tuple."""
    it = iter(header)
    is_tuple, n = bool(next(it)), next(it)
    specs = []
    for _ in range(n):
        code = next(it)
        if code < 0:
            specs.append(None)
            continue
        ndim = next(it)
        specs.append((_DTYPES[code], tuple(next(it) for _ in range(ndim))))
    return is_tuple, specs


class _Link:
    """One direction of a stage boundary with ``peer`` (a global rank):
    the signatures sent or received so far, the sends not yet waited for,
    and what the hops cost."""

    def __init__(self, peer, group, device):
        self.peer = peer
        self.pg = group.pg
        self.device = device
        self.sent = {}      # signature -> index
        self.got = []       # index -> (is_tuple, specs)
        self.pending = []   # (work, host tensor kept alive until sent)
        self.wait_s = 0.0
        self.bytes = 0
        self.headers_sent = 0
        self.headers_got = 0

    def _host(self, t):
        """The tensor a send or receive of this backend takes."""
        dist = torch.distributed
        if t.is_cuda and dist.get_backend(self.pg) == "gloo":
            return t.detach().cpu()
        return t.detach().contiguous()

    def _isend(self, t):
        buf = self._host(t)
        self.pending.append((torch.distributed.isend(buf, self.peer,
                                                     group=self.pg), buf))
        self.bytes += buf.numel() * buf.element_size()

    def _recv(self, shape, dtype):
        dist = torch.distributed
        on_host = self.device.type == "cuda" and \
            dist.get_backend(self.pg) == "gloo"
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if on_host else self.device)
        t0 = time.perf_counter()
        dist.irecv(buf, self.peer, group=self.pg).wait()
        self.wait_s += time.perf_counter() - t0
        return buf.to(self.device) if on_host else buf

    def send(self, value):
        sig = _signature(value)
        idx = self.sent.get(sig)
        if idx is None:
            header = _encode(value)
            self.sent[sig] = len(self.sent)
            self._isend(torch.tensor([-len(header)], dtype=torch.int64,
                                     device=self.device))
            self._isend(torch.tensor(header, dtype=torch.int64,
                                     device=self.device))
            self.headers_sent += 1
        else:
            self._isend(torch.tensor([idx], dtype=torch.int64,
                                     device=self.device))
        for t in _entries(value):
            if t is not None:
                self._isend(t)

    def recv(self):
        word = int(self._recv((1,), torch.int64)[0])
        if word < 0:
            self.got.append(_decode(
                self._recv((-word,), torch.int64).tolist()))
            self.headers_got += 1
            word = len(self.got) - 1
        is_tuple, specs = self.got[word]
        ents = [None if s is None else self._recv(s[1], s[0])
                for s in specs]
        return tuple(ents) if is_tuple else ents[0]

    def flush(self):
        t0 = time.perf_counter()
        for work, _ in self.pending:
            work.wait()
        self.pending.clear()
        self.wait_s += time.perf_counter() - t0


def _bucketed_all_reduce(tensors, group, op):
    """All-reduce ``tensors`` over ``group`` in place, one flat buffer a
    (device, dtype)."""
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.device, t.dtype), []).append(t)
    for ts in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce(flat, op=op, group=group)
        ofs = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[ofs:ofs + n].view(t.shape))
            ofs += n


class _Stage:
    """This rank's stage: its calls, trainable parameters and buffers, and
    the three directions' bodies (forward, forward with the loss, and the
    recompute backward of each)."""

    def __init__(self, pl, is_last):
        self.pl = pl
        self.calls = pl._calls
        self.loss_fn = pl.loss_fn if is_last else None
        self.is_last = is_last
        seen, self.params = set(), []
        for p in pl.parameters():
            if p.requires_grad and id(p) not in seen:
                seen.add(id(p))
                self.params.append(p)
        self.buffers = [b for b in pl.buffers() if b is not None]
        self.acc = [None] * len(self.params)

    def run(self, x):
        for call in self.calls:
            x = call(x)
        return x

    def forward_loss(self, x, y):
        loss = self.loss_fn(self.run(x), y)
        return loss.mean() if loss.dim() > 0 else loss

    def _grads(self, x, roots, seeds):
        """Autograd of ``roots`` against ``seeds`` into the parameters'
        accumulators; returns the input's gradients in its structure."""
        ents = _entries(x)
        wrt = [t for t in ents if _is_float(t)]
        got = torch.autograd.grad(roots(x), self.params + wrt, seeds,
                                  allow_unused=True)
        for i, g in enumerate(got[:len(self.params)]):
            if g is None:
                continue
            if self.acc[i] is None:
                self.acc[i] = g
            else:
                self.acc[i].add_(g)
        dx = iter(got[len(self.params):])
        return _rebuild(x, [next(dx) if _is_float(t) else None
                            for t in ents])

    @staticmethod
    def _leaves(x):
        return _rebuild(x, [t.detach().requires_grad_() if _is_float(t)
                            else t for t in _entries(x)])

    def backward(self, x, g):
        with torch.enable_grad():
            x = self._leaves(x)
            out = self.run(x)
            pairs = [(o, go) for o, go in zip(_entries(out), _entries(g))
                     if _is_float(o) and o.requires_grad and go is not None]
            return self._grads(x, lambda _: [o for o, _ in pairs],
                               [go for _, go in pairs])

    def backward_loss(self, x, y, seed):
        with torch.enable_grad():
            x = self._leaves(x)
            loss = self.forward_loss(x, y)
            return self._grads(x, lambda _: [loss], [seed.to(loss.dtype)])


@contextlib.contextmanager
def _training_forms():
    """The fused ops take their training forms (ops/autotune.py) in the
    forward too, so that the forward and its rerun compute alike."""
    prev = autotune._FORCE_DIRECTION[0]
    autotune._FORCE_DIRECTION[0] = "fwd_bwd"
    try:
        yield
    finally:
        autotune._FORCE_DIRECTION[0] = prev


class PipelineEngine:
    """1F1B over this rank's stage of ``pipeline_layer`` (module
    docstring). ``hcg`` (fleet's HybridCommunicateGroup) gives the data
    and sharding ranks the gradients are averaged over; without it, the
    mesh's data ranks."""

    def __init__(self, pipeline_layer, num_microbatches, axis="pipe",
                 seg_method="uniform", compiled=None, hcg=None):
        from ...jit.compiled_step import compiled_step_enabled
        from ..mesh import get_mesh
        pl = pipeline_layer
        self.pl = pl
        self.M = max(int(num_microbatches), 1)
        S = pl.num_stages
        mesh = get_mesh()
        deg = mesh.shape.get(axis, 1)
        if deg != S:
            raise ValueError(
                f"num_stages ({S}) must equal the '{axis}' mesh axis degree "
                f"({deg}) — one stage per pipe-axis coordinate (one process "
                f"a stage)")
        self.S = S
        self.stage = pl.stage_id
        self.group = mesh.group(axis)
        self.is_first, self.is_last = self.stage == 0, self.stage == S - 1
        self.st = _Stage(pl, self.is_last)
        first = next(iter(self.st.params), None)
        self.device = first.device if first is not None else None
        if hcg is not None:
            self._dp_group = hcg.get_dp_sharding_parallel_group()
        else:
            self._dp_group = mesh.group("data") \
                if "data" in mesh.axis_names else None
        mp = mesh.shape.get("model", 1)
        self._links = {}
        self._shared = pl._shared
        self._sync_shared_params()
        want = compiled_step_enabled() if compiled is None else bool(compiled)
        self.eager_reason = None
        if want and mp > 1:
            self.eager_reason = (
                f"mp_degree {mp}: the tensor-parallel layers' collectives "
                f"cannot be captured in a CUDA graph")
        self.compiled = want and self.eager_reason is None
        if compiled and not self.compiled:
            warnings.warn(f"pipeline stage {self.stage} runs eagerly: "
                          f"{self.eager_reason}", RuntimeWarning,
                          stacklevel=2)
        self._build_programs()
        flag = torch.tensor([int(self.compiled)], dtype=torch.int64,
                            device=self.device)
        flags = []
        all_gather(flags, flag, group=self.group)
        self.compiled_stages = [s for s, f in enumerate(flags) if int(f[0])]
        self._gen0 = self._generation()
        self._stats = {"batches": 0, "units": 0, "max_stashed": 0}

    # -- set-up ----------------------------------------------------------------
    def _sync_shared_params(self):
        """Every stage holding a shared parameter takes the first stage's
        copy."""
        with torch.no_grad():
            for _, param, group in self._shared:
                if group is not None and group.nranks > 1:
                    broadcast(param.data, src=group.global_rank(0),
                              group=group)

    def _build_programs(self):
        st = self.st
        dirs = {"fwd": st.forward_loss if self.is_last else st.run,
                "fwd_out": st.run,
                "bwd": st.backward_loss if self.is_last else st.backward}
        if self.compiled:
            from ...jit.compiled_step import CompiledStageProgram
            # captured replays add into the accumulators by address
            st.acc = [torch.zeros_like(p) for p in st.params]
            dirs = {k: CompiledStageProgram(fn, label=f"pp.s{self.stage}.{k}")
                    for k, fn in dirs.items()}
        self._fwd, self._fwd_out, self._bwd = (dirs["fwd"], dirs["fwd_out"],
                                               dirs["bwd"])

    @staticmethod
    def _generation():
        from ...resilience.recovery import current_generation
        return current_generation()

    def _fence(self, where):
        """A hop that straddles a change of the collective generation
        fails typed instead of feeding a stale activation onward."""
        gen = self._generation()
        if gen != self._gen0:
            from ...resilience.watchdog import StaleGeneration
            raise StaleGeneration(self._gen0, gen, section=where)

    def _link(self, direction, device):
        """The link to the next stage ("next") or the previous ("prev")."""
        link = self._links.get(direction)
        if link is None:
            peer = self.group.global_rank(
                self.stage + (1 if direction == "next" else -1))
            link = self._links[direction] = _Link(peer, self.group, device)
        return link

    def _send(self, direction, value, m):
        self._fence(f"pp.p2p.s{self.stage}.{direction}.m{m}")
        self._link(direction, self.device).send(value)

    def _recv(self, direction, m):
        self._fence(f"pp.p2p.s{self.stage}.{direction}.m{m}")
        return self._link(direction, self.device).recv()

    def _flush(self):
        for link in self._links.values():
            link.flush()

    # -- the schedule ------------------------------------------------------------
    def _chunks(self, value, M):
        if value is None:
            return [None] * M
        if isinstance(value, (tuple, list)):
            parts = [self._chunks(v, M) for v in value]
            return [type(value)(p[m] for p in parts) for m in range(M)]
        return list(value.chunk(M)) if M > 1 else [value]

    def _start(self, inputs):
        self._gen0 = self._generation()
        if self.device is None:
            lead = inputs[0] if isinstance(inputs, (tuple, list)) \
                else inputs
            self.device = lead.device if isinstance(lead, torch.Tensor) \
                else torch.device("cpu")

    @contextlib.contextmanager
    def _buffers_as(self, values):
        """The stage's buffers hold ``values`` inside the block; on exit
        they are back as they were before it."""
        bufs = self.st.buffers
        if not bufs or values is None:
            yield
            return
        live = [b.detach().clone() for b in bufs]
        with torch.no_grad():
            for b, v in zip(bufs, values):
                b.copy_(v)
        try:
            yield
        finally:
            with torch.no_grad():
                for b, v in zip(bufs, live):
                    b.copy_(v)

    def train_batch(self, inputs, labels, scale=None):
        """One 1F1B batch on this rank's stage: the micro-batches'
        gradients in the stage parameters' ``.grad`` (averaged over the
        data and sharding ranks, shared ones summed over their stages);
        returns the mean loss, the same on every stage. ``scale`` (a
        GradScaler's scale, a tensor or a number) multiplies the seed
        cotangent."""
        M, st = self.M, self.st
        n = (inputs[0] if isinstance(inputs, (tuple, list))
             else inputs).shape[0]
        if n % M:
            raise ValueError(
                f"batch size {n} not divisible by accumulate_steps ({M})")
        self._start(inputs)
        xs = self._chunks(inputs, M) if self.is_first else None
        ys = self._chunks(labels, M) if self.is_last else None
        if scale is None:
            scale = 1.0
        seed = (torch.as_tensor(scale, dtype=torch.float32,
                                device=self.device) / M).reshape(())
        if self.compiled:
            torch._foreach_zero_(st.acc)
        else:
            st.acc = [None] * len(st.params)
        gens = _generators(self.pl, [t for t in _entries(
            xs[0] if xs else torch.empty(0, device=self.device))])
        stash, losses = {}, []
        fwd_m = bwd_m = 0
        queue = unit_order(self.S, M)[self.stage]
        while queue:
            kind = queue.popleft()
            if kind == "F":
                m = fwd_m
                x = xs[m] if self.is_first else self._recv("prev", m)
                saved = {"x": x, "amp": _amp_snapshot(),
                         "rng": [g.get_state() for g in gens],
                         "bufs": [b.detach().clone() for b in st.buffers]
                         or None}
                with torch.no_grad(), _training_forms():
                    out = self._fwd(x, ys[m]) if self.is_last \
                        else self._fwd(x)
                if self.is_last:
                    losses.append(out.detach())
                else:
                    self._send("next", out, m)
                stash[m] = saved
                fwd_m += 1
                self._stats["max_stashed"] = max(self._stats["max_stashed"],
                                                  len(stash))
            else:
                m = bwd_m
                if m not in stash:
                    raise FatalError(
                        "1F1B schedule deadlocked (internal error): stage "
                        f"{self.stage} backward of micro-batch {m} before "
                        f"its forward; queue={list(queue)}")
                saved = stash.pop(m)
                g = None if self.is_last else self._recv("next", m)
                with torch.no_grad(), self._buffers_as(saved["bufs"]), \
                        _as_in_forward(saved["amp"], gens, saved["rng"]):
                    dx = self._bwd(saved["x"], ys[m], seed) if self.is_last \
                        else self._bwd(saved["x"], g)
                if not self.is_first:
                    self._send("prev", dx, m)
                bwd_m += 1
            self._stats["units"] += 1
        self._flush()
        self._finish_grads()
        self._stats["batches"] += 1
        return self._batch_loss(losses)

    def _finish_grads(self):
        """The accumulators into ``.grad``; then the average over the data
        and sharding ranks and the sum of shared parameters' gradients
        over the stages that hold them."""
        st = self.st
        with torch.no_grad():
            for p, acc in zip(st.params, st.acc):
                if acc is None:
                    continue
                if p.grad is not None:
                    p.grad.add_(acc)
                else:
                    # a captured program keeps adding into its accumulator
                    p.grad = acc.clone() if self.compiled else acc
            if not self.compiled:
                st.acc = [None] * len(st.params)
            grads = [p.grad for p in st.params if p.grad is not None]
            if grads and self._dp_group is not None and \
                    self._dp_group.nranks > 1:
                _bucketed_all_reduce(grads, self._dp_group, ReduceOp.AVG)
            for _, param, group in self._shared:
                if group is not None and group.nranks > 1:
                    if param.grad is None:
                        param.grad = torch.zeros_like(param)
                    all_reduce(param.grad, group=group)

    def _batch_loss(self, losses):
        """The mean of the last stage's losses, broadcast over the pipe
        group."""
        if self.is_last:
            loss = torch.stack(losses).float().mean().reshape(1)
        else:
            loss = torch.zeros(1, dtype=torch.float32, device=self.device)
        broadcast(loss, src=self.group.global_rank(self.S - 1),
                  group=self.group)
        return loss[0]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None, compute_loss=True):
        """The forward of every micro-batch (one whole-batch micro-batch
        where ``accumulate_steps`` does not divide it), buffers left as
        they were. With a loss: its mean, the same on every stage;
        without: the last stage's outputs concatenated (None on the other
        stages)."""
        n = (inputs[0] if isinstance(inputs, (tuple, list))
             else inputs).shape[0]
        M = self.M if n % self.M == 0 else 1
        self._start(inputs)
        with_loss = compute_loss and labels is not None and \
            self.pl.loss_fn is not None
        xs = self._chunks(inputs, M) if self.is_first else None
        ys = self._chunks(labels, M) if self.is_last else None
        outs = []
        keep = [b.detach().clone() for b in self.st.buffers] or None
        with self._buffers_as(keep):
            for m in range(M):
                x = xs[m] if self.is_first else self._recv("prev", m)
                if self.is_last and with_loss:
                    outs.append(self._fwd(x, ys[m]))
                else:
                    out = self._fwd_out(x)
                    if self.is_last:
                        outs.append(out)
                    else:
                        self._send("next", out, m)
        self._flush()
        if with_loss:
            return self._batch_loss(outs)
        if not self.is_last:
            return None
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(parts) for parts in zip(*outs))
        return torch.cat(outs)

    def stats(self):
        """This rank's stage, which stages were captured and why not,
        units run, the most stashed inputs, and the point-to-point hops:
        seconds waited, bytes sent, and by link ("next", "prev") the
        headers [sent, received]."""
        links = self._links.values()
        progs = {}
        if self.compiled:
            for k, prog in (("fwd", self._fwd), ("fwd_out", self._fwd_out),
                            ("bwd", self._bwd)):
                progs[k] = prog.stats()
        return {"stage": self.stage, "num_stages": self.S,
                "micro_batches": self.M, "compiled": self.compiled,
                "compiled_stages": list(self.compiled_stages),
                "eager_reason": self.eager_reason,
                "p2p_wait_s": sum(lk.wait_s for lk in links),
                "p2p_bytes_sent": sum(lk.bytes for lk in links),
                "headers": {d: [lk.headers_sent, lk.headers_got]
                            for d, lk in self._links.items()},
                "programs": progs, **self._stats}

    def reset_stats(self):
        for link in self._links.values():
            link.wait_s, link.bytes = 0.0, 0
        self._stats.update(units=0, max_stashed=0)
