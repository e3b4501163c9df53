"""The bucketed gradient Reducer of data parallelism (port of
paddle_tpu/distributed/reducer.py).

The parameters are grouped into buckets over the reversed registration
order (the backward produces the last layers' gradients first), by
device and dtype, each at most ``FLAGS_reducer_bucket_mb`` (the first,
filled first, at most ``last_comm_buffer_size``). A hook on each
parameter (``register_post_accumulate_grad_hook``) marks it ready once
its gradient is accumulated; when a bucket's last parameter is ready,
the bucket's gradients are copied into one flat buffer and one
asynchronous ``all_reduce`` of it starts, overlapping the rest of the
backward. ``finalize()`` waits for them, writes the averaged buffers back
into the parameters' gradients, reduces what an incomplete bucket holds
(a parameter that took no gradient) one parameter at a time, and
re-reduces any gradient that arrived after its bucket had flushed (a
leaf accumulated again late: only that delta, which is what the others
missed). The order is a function of the registration order, shapes,
dtypes and caps alone, so it is the same on every rank, and the
collectives pair up without a coordination round.

The first hook of a backward pass queues ``finalize`` to run when the
pass ends (``torch.autograd``'s engine callback), so the plain
backward / step / clear_grad loop needs no explicit call; the reference
runs it from its engine's post-backward callbacks. ``pause``/``resume``
turn the hooks off and on (``DataParallel.no_sync``); ``detach`` removes
them.

A ZeRO-3 shard (distributed/spec_layout.py) has its gradient averaged
over its fsdp group already; the Reducer averages it over the group its
shard is replicated on (``p.fsdp_replicas``, the data ranks), or not at
all where that is None, so its buckets group parameters by reduction
group too. An expert slice of ``incubate.MoELayer`` likewise
(``p.ep_replicas``): the exchange gave it every rank's contribution.
Sharding parameters re-arms every live Reducer (``rearm_reducers``):
their shapes and groups changed.
"""
from __future__ import annotations

import weakref

import torch

from ..resilience.faults import maybe_inject
from .collective import ReduceOp, _all_reduce_start, _watched

__all__ = ["Reducer", "reducer_bucket_bytes", "rearm_reducers"]

_LIVE = weakref.WeakSet()
# a shard whose replicas group is None is reduced by nobody
_NOBODY = object()


def rearm_reducers():
    """Rebuild every live Reducer's buckets over its parameters (their
    shapes or reduction groups changed: ZeRO-3 sharded them)."""
    for r in list(_LIVE):
        if r._hooks:
            r._arm(r._params)


def reducer_bucket_bytes():
    """FLAGS_reducer_bucket_mb in bytes: the cap of one fused bucket."""
    from ..framework.flags import get_flag
    return int(get_flag("FLAGS_reducer_bucket_mb", 25)) * (1 << 20)


class _Bucket:
    def __init__(self, params, group=None):
        self.params = params
        self.group = group
        self.ready = set()
        self.flushed = False


def _dense(g):
    return g.to_dense() if g.is_sparse else g


class Reducer:
    def __init__(self, parameters, comm_buffer_size=25,
                 last_comm_buffer_size=1, group=None, op=ReduceOp.AVG,
                 comm_dtype=None):
        """comm_buffer_size and last_comm_buffer_size in MB (the
        reference's DataParallel arguments); comm_dtype: the dtype the
        buckets are reduced in (default: the gradients')."""
        self.group = group
        self.op = op
        self.comm_dtype = comm_dtype
        self._paused = False
        self._cap_bytes = int(comm_buffer_size * (1 << 20))
        self._last_cap_bytes = int(last_comm_buffer_size * (1 << 20))
        self._hooks = []
        self.flushes = 0   # fused all_reduces started (chip_smoke reads it)
        self._arm([p for p in parameters if p.requires_grad])
        _LIVE.add(self)

    def _group_of(self, p):
        """The group ``p``'s gradient is averaged over: the Reducer's,
        or for a ZeRO-3 shard or an expert slice its replicas' (_NOBODY:
        none)."""
        if getattr(p, "fsdp_split", None) is not None:
            replicas = p.fsdp_replicas
        elif getattr(p, "ep_split", None) is not None:
            replicas = p.ep_replicas
        else:
            return self.group
        return _NOBODY if replicas is None else replicas

    def _arm(self, params):
        """(Re)build the buckets over ``params`` and hook them."""
        for h in self._hooks:
            h.remove()
        self._params = params
        reduced = [p for p in params if self._group_of(p) is not _NOBODY]
        self.buckets = self._build_buckets(reduced, self._cap_bytes,
                                           self._last_cap_bytes,
                                           self._group_of)
        self._bucket_of = {id(p): b for b in self.buckets for p in b.params}
        self._pending = []   # (bucket, flat buffer, handle), in fire order
        self._extras = {}    # id(p) -> (p, local gradient after the flush)
        self._queued = False
        self._hooks = [h for p in reduced
                       for h in (p.register_hook(self._incoming(p)),
                                 p.register_post_accumulate_grad_hook(
                                     self._hook))]

    @staticmethod
    def _build_buckets(params, cap_bytes, last_cap_bytes, group_of=None):
        """Reversed order, grouped by (device, dtype, reduction group),
        size-capped; the first bucket at the smaller cap."""
        def group(p):
            return None if group_of is None else group_of(p)

        def kind(p):
            return p.device, p.dtype, id(group(p))
        buckets, cur, cur_bytes = [], [], 0
        cap = last_cap_bytes
        for p in reversed(params):
            nbytes = p.numel() * p.element_size()
            if cur and (cur_bytes + nbytes > cap or kind(p) != kind(cur[0])):
                buckets.append(_Bucket(cur, group(cur[0])))
                cur, cur_bytes, cap = [], 0, cap_bytes
            cur.append(p)
            cur_bytes += nbytes
        if cur:
            buckets.append(_Bucket(cur, group(cur[0])))
        return buckets

    def _incoming(self, p):
        """The hook on a gradient arriving at ``p``: one that arrives
        after p's bucket started its reduce is a late delta, kept for
        finalize (the buffer already holds what came before)."""
        def hook(grad):
            if not self._paused and self._bucket_of[id(p)].flushed:
                prev = self._extras.get(id(p), (p, 0))[1]
                self._extras[id(p)] = (p, prev + _dense(grad).detach())
        return hook

    def _hook(self, p):
        """After ``p``'s gradient is accumulated: mark it ready, and start
        its bucket's reduce when the bucket is complete."""
        if self._paused:
            return
        if not self._queued:
            # finalize when this backward pass ends
            torch.autograd.Variable._execution_engine.queue_callback(
                self.finalize)
            self._queued = True
        b = self._bucket_of[id(p)]
        if b.flushed:
            return   # a late delta (_incoming kept it)
        b.ready.add(id(p))
        if len(b.ready) == len(b.params):
            self._flush(b)

    def _flush(self, b):
        """One asynchronous all_reduce of the bucket's gradients, copied
        into a flat buffer; the scatter back waits for finalize()."""
        maybe_inject("reducer.flush")
        b.flushed = True
        flat = torch.cat([_dense(p.grad).reshape(-1) for p in b.params])
        if self.comm_dtype is not None:
            flat = flat.to(self.comm_dtype)
        self._pending.append((b, flat, _all_reduce_start(flat, self.op,
                                                         b.group)))
        self.flushes += 1

    def _reduce(self, t, group):
        """A synchronous all_reduce of one gradient (in comm_dtype)."""
        buf = t.to(self.comm_dtype) if self.comm_dtype is not None \
            else t.clone()
        _all_reduce_start(buf, self.op, group).wait()
        return buf.to(t.dtype)

    def finalize(self):
        """The backward's end: wait for the started reductions and write
        them back, reduce what incomplete buckets hold, one parameter at a
        time in bucket order, and the deltas that arrived after a flush;
        then reset. Idempotent: without gradient activity since the last
        call it does nothing."""
        if self._paused or not (self._queued or self._pending):
            return
        from .collective import _default_group
        with _watched("reducer.finalize", self.group or _default_group()):
            for b, flat, handle in self._pending:
                out = handle.wait()
                ofs = 0
                for p in b.params:
                    n = p.numel()
                    piece = out[ofs:ofs + n].view(p.shape).to(p.dtype)
                    ofs += n
                    extra = self._extras.pop(id(p), None)
                    if extra is not None:
                        # the local gradient holds the pre-flush value
                        # and the late delta: each averaged on its own
                        piece = piece + self._reduce(
                            extra[1], b.group).to(p.dtype)
                    p.grad = piece if p.grad is None or p.grad.is_sparse \
                        else p.grad.copy_(piece)
            for b in self.buckets:
                if not b.flushed and b.ready:
                    for p in b.params:
                        if p.grad is not None:
                            p.grad = self._reduce(_dense(p.grad), b.group)
                    b.flushed = True
        self.reset()

    def reset(self):
        for b in self.buckets:
            b.ready.clear()
            b.flushed = False
        self._pending = []
        self._extras.clear()
        self._queued = False

    def pause(self):
        self._paused = True

    def resume(self, parameters=None):
        """Hooks on again; with ``parameters``, re-armed over that list
        when the membership changed while paused."""
        if parameters is not None:
            params = [p for p in parameters if p.requires_grad]
            if [id(p) for p in params] != [id(p) for p in self._params]:
                self._arm(params)
        self._paused = False

    def detach(self):
        """Remove every hook (a model wrapped again must not stack
        reducers that each reduce its gradients)."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
