"""The collectives (port of paddle_tpu/distributed/collective.py).

Each is one ``torch.distributed`` call on the group's process group, in
place where the reference's is. The reference lowers a collective to an
XLA collective inside a traced SPMD region and runs it eagerly across
processes otherwise; the port runs one process per rank, so every call
is the eager one. Without a process group and at world size 1 a
collective is a no-op, as in the reference's eager path; a process group
of any size (one rank on NCCL, say) runs it.

Gloo takes CUDA tensors for ``all_reduce`` and ``broadcast`` only. On a
gloo group the other collectives stage a CUDA tensor through the host: a
copy to the CPU, the collective there, and a copy back. ``AVG`` is a sum
divided by the group's size, which every backend takes.

A rank outside a subgroup is left untouched by the group's collectives,
as in the reference (its ``_eager_subgroup_call``). Each eager call runs
inside ``_watched``: the ``step/collective_wait`` phase of the step
timer, a watchdog deadline (``watch_section``) and a flight-recorder
entry. The backend's own failures get the reference's types: a timeout
(the group's, ``FLAGS_collective_timeout``) is a ``TimeoutError``, which
the section reports as ``DistributedTimeout``, and a lost connection a
``ConnectionError``. On this rank's own failure (not a ``PeerAbort`` or a
``StaleGeneration``) the recorder is dumped and an abort broadcast to
the peers over the p2p channel (``p2p.py``), as in the reference. Gloo
has no abort call, and a peer blocked in the same collective cannot be
woken from its reader thread; so the failed rank then leaves its process
group (``env.teardown``), which closes its sockets, and the blocked peer
fails at once with a lost connection, which it reports as the
``PeerAbort`` that arrived on its channel.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from ..resilience.faults import maybe_inject
from .env import get_rank, get_world_size

__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "reduce", "broadcast", "scatter", "reduce_scatter",
           "alltoall", "send", "recv", "barrier", "split"]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def _dist():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def _torch_op(op):
    dist = _dist()
    return {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
            ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.PROD: dist.ReduceOp.PRODUCT}[op]


class Group:
    """A set of ranks and its process group (the reference's Group names a
    mesh axis; ``axis`` keeps that name). ``ranks`` None is every rank."""

    _next_id = [1]

    def __init__(self, ranks=None, pg=None, axis="data", gid=None):
        self.ranks = None if ranks is None else [int(r) for r in ranks]
        self.pg = pg
        self.axis = axis
        self.id = gid if gid is not None else Group._next_id[0]
        Group._next_id[0] += 1

    @property
    def nranks(self):
        return get_world_size() if self.ranks is None else len(self.ranks)

    @property
    def rank(self):
        """This process's rank in the group, -1 outside it."""
        r = get_rank()
        if self.ranks is None:
            return r
        return self.ranks.index(r) if r in self.ranks else -1

    def is_member(self):
        return self.rank >= 0

    def global_rank(self, member):
        """The global rank of the group's ``member``-th rank."""
        return member if self.ranks is None else self.ranks[member]

    def __repr__(self):
        return f"Group(axis={self.axis}, ranks={self.ranks})"


_GROUPS = {0: Group(gid=0)}


def _default_group():
    return _GROUPS[0]


def new_group(ranks=None, backend=None, axis="data"):
    """A group of ``ranks`` (every rank when None). With a process group
    initialised, every rank must call this, in one order, as
    ``torch.distributed.new_group`` requires."""
    dist = _dist()
    pg = None
    if dist is not None and ranks is not None:
        pg = dist.new_group(ranks=sorted(int(r) for r in ranks),
                            backend=backend)
    g = Group(ranks=ranks, pg=pg, axis=axis)
    _GROUPS[g.id] = g
    return g


def get_group(gid=0):
    return _GROUPS.get(gid)


def _active(g):
    """Whether a collective on ``g`` communicates: a process group exists
    and this rank is in ``g``. Raises where the world is larger than one
    with no process group (a script that forgot init_parallel_env)."""
    if _dist() is None:
        if get_world_size() > 1:
            raise RuntimeError(
                f"a collective at world size {get_world_size()} needs the "
                f"process group: call paddle.distributed.init_parallel_env() "
                f"first")
        return False
    return g.is_member()


def _gloo(g):
    dist = _dist()
    return dist.get_backend(g.pg) == "gloo"


@contextmanager
def _staged(g, *tensors):
    """The tensors a gloo group can take: CPU copies of CUDA tensors
    (copied back into the originals on exit), the tensors themselves
    otherwise."""
    if not (_gloo(g) and any(t.is_cuda for t in tensors)):
        yield tensors
        return
    host = tuple(t.cpu() for t in tensors)
    yield host
    for t, h in zip(tensors, host):
        t.copy_(h)


# seconds a collective whose transport failed waits for the abort of
# the peer that failed (it is sent just before that peer's sockets close)
_ABORT_GRACE = 2.0
_CLOSED = ("closed by peer", "connection reset", "connection refused",
           "broken pipe", "connection closed", "socket closed")


def _backend_error(err):
    """The reference's type for a backend failure of torch.distributed:
    TimeoutError for the group's timeout, ConnectionError for a lost
    peer; None for anything else (this package's own errors included)."""
    from ..resilience.faults import FaultInjected
    if not isinstance(err, RuntimeError) or isinstance(err, FaultInjected):
        return None
    msg = str(err)
    low = msg.lower()
    if "timed out" in low or "timeout" in low:
        return TimeoutError(msg)
    if any(k in low for k in _CLOSED) or \
            type(err).__name__ == "DistBackendError":
        return ConnectionError(msg)
    return None


@contextmanager
def _watched(op, g, value=None):
    """Step-phase attribution, a watchdog deadline and a flight-recorder
    entry around an eager collective; a failure is handled as the module
    docstring says."""
    from ..profiler.steptimer import get_steptimer
    from ..resilience.recorder import describe, get_recorder
    from ..resilience.watchdog import (PeerAbort, StaleGeneration,
                                       watch_section)
    from . import p2p
    from .env import teardown
    rec = get_recorder()
    shapes, dtypes = describe(value)
    try:
        with get_steptimer().phase("step/collective_wait"):
            with watch_section(f"collective.{op}"):
                with rec.record(op, group=g.axis, shapes=shapes,
                                dtypes=dtypes):
                    try:
                        yield
                    except RuntimeError as err:
                        typed = _backend_error(err)
                        if typed is None:
                            raise
                        raise typed from err
    except BaseException as err:
        if isinstance(err, StaleGeneration):
            raise  # the group moved on without us: not ours to abort
        peer = err if isinstance(err, PeerAbort) else None
        if peer is None and isinstance(err, ConnectionError):
            peer = p2p.peer_abort(wait=_ABORT_GRACE)
        if peer is None:
            # our own failure: tell the peers
            try:
                rec.dump(reason=f"failure:collective.{op}")
                p2p.broadcast_abort(f"collective.{op}", reason=repr(err))
            except Exception:
                pass  # diagnostics must not mask the real error
        teardown()
        if peer is not None and peer is not err:
            raise peer from err
        raise


class _Pending:
    """An asynchronous all_reduce: ``wait()`` completes it (and divides
    an AVG by the group's size)."""

    def __init__(self, work, tensor, divide):
        self.work, self.tensor, self.divide = work, tensor, divide

    def wait(self):
        if self.work is not None:
            self.work.wait()
        if self.divide > 1:
            self.tensor.div_(self.divide)
        return self.tensor


def _all_reduce_start(tensor, op=ReduceOp.SUM, group=None):
    """Start an all_reduce of ``tensor`` in place; returns a handle whose
    ``wait()`` finishes it (the Reducer's overlap)."""
    g = group or _default_group()
    if not _active(g):
        return _Pending(None, tensor, 1)
    dist = _dist()
    work = dist.all_reduce(tensor, op=_torch_op(op), group=g.pg,
                           async_op=True)
    return _Pending(work, tensor, g.nranks if op == ReduceOp.AVG else 1)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """c_allreduce_{sum,max,min,prod,avg}, in place; returns the tensor."""
    g = group or _default_group()
    if not _active(g):
        maybe_inject("collective.all_reduce")
        return tensor
    with _watched("all_reduce", g, tensor):
        # inside the watch: an injected failure is this rank's own
        maybe_inject("collective.all_reduce")
        _all_reduce_start(tensor, op, g).wait()
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Fill ``tensor_list`` with every member's ``tensor``, in group
    order (non-members: left as they are)."""
    maybe_inject("collective.all_gather")
    g = group or _default_group()
    if not _active(g):
        if _dist() is None:
            tensor_list.clear()
            tensor_list.append(tensor.clone())
        return tensor_list
    with _watched("all_gather", g, tensor), _staged(g, tensor) as (t,):
        parts = [torch.empty_like(t) for _ in range(g.nranks)]
        _dist().all_gather(parts, t.contiguous(), group=g.pg)
        tensor_list.clear()
        tensor_list.extend(p.to(tensor.device) for p in parts)
    return tensor_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """As in the reference, every member holds the result (its SPMD
    reduce is an all-reduce seen from ``dst``)."""
    maybe_inject("collective.reduce")
    return all_reduce(tensor, op=op, group=group)


def broadcast(tensor, src=0, group=None, sync_op=True):
    """``src``'s tensor into every member's, in place; ``src`` is a global
    rank."""
    maybe_inject("collective.broadcast")
    g = group or _default_group()
    if not _active(g):
        return tensor
    with _watched("broadcast", g, tensor):
        _dist().broadcast(tensor, src=src, group=g.pg)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Member i of the group receives ``tensor_list[i]`` of ``src`` (a
    global rank) into ``tensor``; other ranks' lists are not read. At
    world size 1, ``tensor_list[0]``."""
    maybe_inject("collective.scatter")
    g = group or _default_group()
    if not _active(g):
        if _dist() is None and tensor_list is not None:
            tensor.copy_(tensor_list[0])
        return tensor
    with _watched("scatter", g, tensor):
        lst = list(tensor_list) if get_rank() == src else None
        with _staged(g, tensor, *(lst or ())) as staged:
            _dist().scatter(staged[0], list(staged[1:]) or None, src=src,
                            group=g.pg)
    return tensor


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Reduce the concatenation of ``tensor_list`` (or ``tensor``) over the
    group and keep this member's chunk of dim 0 in ``tensor``. Gloo has
    no reduce_scatter: there it is an all-reduce and a slice."""
    maybe_inject("collective.reduce_scatter")
    g = group or _default_group()
    src = torch.cat(list(tensor_list)) if tensor_list is not None else tensor
    if not _active(g):
        if _dist() is None and tensor_list is not None:
            tensor.copy_(src)
        return tensor
    n = g.nranks
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({src.shape[0]}) not "
                         f"divisible by the group's {n} ranks")
    chunk = src.shape[0] // n
    with _watched("reduce_scatter", g, src):
        full = src.clone()
        _all_reduce_start(full, op, g).wait()
        mine = full[g.rank * chunk:(g.rank + 1) * chunk]
        # in place, as the reference replaces its tensor's value
        tensor.resize_(mine.shape).copy_(mine)
    return tensor


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Chunk i of member j goes to member i: member r receives chunk r of
    every member, in member order. Returns the stacked result, or fills
    ``out_tensor_list``."""
    maybe_inject("collective.alltoall")
    g = group or _default_group()
    x = torch.stack(list(in_tensor_list)) if isinstance(
        in_tensor_list, (list, tuple)) else in_tensor_list
    if not _active(g):
        out = x
    else:
        n = g.nranks
        if x.shape[0] != n:
            raise ValueError(f"alltoall needs {n} chunks, got leading dim "
                             f"{x.shape[0]}")
        with _watched("alltoall", g, x), _staged(g, x) as (t,):
            t = t.contiguous()
            if _gloo(g):
                # gloo's all_to_all takes no list of tensors on every
                # build: gather every member's chunks and keep column r
                every = [torch.empty_like(t) for _ in range(n)]
                _dist().all_gather(every, t, group=g.pg)
                got = torch.stack([e[g.rank] for e in every])
            else:
                got = torch.empty_like(t)
                _dist().all_to_all_single(got, t, group=g.pg)
            out = got.to(x.device)
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(out.unbind(0))
        return out_tensor_list
    return out


def send(tensor, dst=0, group=None, sync_op=True):
    """send_v2: ``tensor`` to global rank ``dst``."""
    maybe_inject("collective.send")
    g = group or _default_group()
    if not _active(g):
        return tensor
    with _watched("send", g, tensor), _staged(g, tensor) as (t,):
        _dist().send(t.contiguous(), dst=dst, group=g.pg)
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    """recv_v2: into ``tensor`` (its shape and dtype), from global rank
    ``src``."""
    maybe_inject("collective.recv")
    g = group or _default_group()
    if not _active(g):
        return tensor
    with _watched("recv", g, tensor), _staged(g, tensor) as (t,):
        _dist().recv(t, src=src, group=g.pg)
    return tensor


class Exchange:
    """Point-to-point transfers over ``group`` started together and
    waited for together: a ring step's sends and receives
    (fleet/sequence_parallel.py) or a pipeline tick's
    (fleet/spmd_pipeline.py). Every send and receive is asynchronous
    (``isend``/``irecv``), so a ring of them cannot deadlock as a ring of
    blocking sends does; ``wait()`` returns the received tensors, in the
    order they were asked for, on their devices. On gloo a CUDA tensor
    goes through the host. ``peer`` is a member index of ``group``.
    ``bytes`` counts what this rank sent, ``wait_s`` the seconds
    ``wait()`` blocked."""

    def __init__(self, group):
        self.group = group
        dist = _dist()
        self._host = dist is not None and \
            dist.get_backend(group.pg) == "gloo"
        self._works, self._recvs = [], []
        self.bytes, self.wait_s = 0, 0.0

    def _buf(self, t):
        return t.detach().cpu() if self._host and t.is_cuda \
            else t.detach().contiguous()

    def send(self, tensor, peer):
        buf = self._buf(tensor)
        self._works.append((_dist().isend(
            buf, self.group.global_rank(peer), group=self.group.pg), buf))
        self.bytes += buf.numel() * buf.element_size()

    def recv(self, shape, dtype, device, peer):
        on_host = self._host and torch.device(device).type == "cuda"
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if on_host else device)
        self._works.append((_dist().irecv(
            buf, self.group.global_rank(peer), group=self.group.pg), buf))
        self._recvs.append((buf, device))

    def wait(self):
        t0 = time.perf_counter()
        with _watched("p2p", self.group):
            for work, _ in self._works:
                work.wait()
        self.wait_s += time.perf_counter() - t0
        got = [buf.to(device) for buf, device in self._recvs]
        self._works, self._recvs = [], []
        return got


def barrier(group=None):
    maybe_inject("collective.barrier")
    g = group or _default_group()
    if not _active(g):
        return
    with _watched("barrier", g):
        _dist().barrier(group=g.pg)


def split(x, num_or_sections, axis=0, group=None):
    """paddle.distributed.split, as the reference's: the tensor split.
    The layers split over the model ranks are fleet.meta_parallel's
    (``ColumnParallelLinear``, ``RowParallelLinear``,
    ``VocabParallelEmbedding``)."""
    from ..tensor.manipulation import split as _split
    return _split(x, num_or_sections, axis=axis)


# -- the tensor-parallel helpers (mp_ops: _c_identity, _mp_allreduce) -------

class _CIdentity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(), group=ctx.group), None


class _MpAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _c_identity(x, group=None):
    """Forward identity, backward sum over the group: every member's
    gradient is the sum of the members' (ROADMAP C-ref-1: the reference's
    backward does not sum inside its SPMD region; the port's does)."""
    return _CIdentity.apply(x, group or _default_group())


def _mp_allreduce(x, group=None):
    """Forward sum over the group, backward identity (the row-parallel
    output's combine)."""
    return _MpAllReduce.apply(x, group or _default_group())
