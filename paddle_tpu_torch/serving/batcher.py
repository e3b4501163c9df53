"""Dynamic batching: bounded queue, shape buckets, padding (port of
paddle_tpu/serving/batcher.py).

Every new input shape costs the predictor a new program: an XLA
compilation in the reference, a CUDA graph capture (and its memory pool) on
the card here. A naive batcher that assembles whatever happens to be queued
produces an unbounded stream of batch sizes → unbounded captures. So
batching is *shape-bucketed* (Clipper-style adaptive batching constrained
to a fixed bucket set):

- requests are grouped per **signature** — the per-row shapes/dtypes of their
  inputs (the batch row dim stripped);
- an assembled batch is padded up to the smallest configured **bucket**
  (default: powers of two up to ``max_batch_size``) that fits its rows;
- :class:`BucketedExecutor` caches the compiled executable per
  (signature, bucket) and carries a ``compile_count`` — the bounded-compile
  test drives randomized row counts through it and asserts the counter never
  exceeds ``len(buckets)`` per signature.

Admission is deadline-aware (Clipper's SLO-aware admission): a full queue or
an already-unmeetable deadline raises :class:`ServerOverloaded` immediately —
load is shed at the door, never by silently dropping an accepted request.
Accepted requests always terminate with a result or an error.

The chaos seam: :meth:`BatchQueue.put` is a fault-injection site
(``serving.enqueue``), and every clock is injectable so the chaos suite runs
with a fake clock and zero real sleeps.
"""
from __future__ import annotations

import itertools
import threading

import numpy as np

from ..framework.errors import ResourceExhaustedError
from ..resilience.faults import maybe_inject

__all__ = ["ServerOverloaded", "DeadlineExceeded", "Request", "Batch",
           "BatchQueue", "BucketedExecutor", "bucket_for", "pow2_buckets",
           "pad_rows", "signature_of"]


class ServerOverloaded(ResourceExhaustedError):
    """Load shed at admission: queue full, admission limit hit, no healthy
    replica, or the request's deadline cannot be met. Clients should back
    off and retry; ``retry_after`` (seconds, may be None) is the server's
    hint for how long — it rides the wire codec to ``InferenceClient``,
    whose deadline-aware backoff honors it."""

    def __init__(self, message="", retry_after=None):
        super().__init__(message)
        self.retry_after = retry_after


class DeadlineExceeded(TimeoutError):
    """An *accepted* request missed its deadline (queueing or execution took
    too long). Set as the request's error — never silently dropped."""


def pow2_buckets(max_batch_size):
    """[1, 2, 4, ..., max_batch_size] (max included even if not a pow2)."""
    if max_batch_size < 1:
        raise ValueError(f"max_batch_size must be >= 1: {max_batch_size}")
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(int(max_batch_size))
    return out


def bucket_for(rows, buckets):
    """Smallest bucket that fits ``rows``; rows beyond the largest bucket are
    the assembler's job to split (it never builds a batch that large)."""
    for b in buckets:
        if rows <= b:
            return b
    return buckets[-1]


def signature_of(arrays):
    """Per-row (shape-without-batch-dim, dtype) tuple — the batching key."""
    sig = []
    for a in arrays:
        a = np.asarray(a)
        if a.ndim < 1:
            raise ValueError(
                "serving inputs need a leading batch/row dimension; got a "
                f"0-d array of dtype {a.dtype}")
        sig.append((tuple(a.shape[1:]), str(a.dtype)))
    return tuple(sig)


def pad_rows(arrays, rows, bucket):
    """Pad each stacked array's leading dim from ``rows`` up to ``bucket``
    with zeros (the predictor sees only bucket shapes → bounded compiles)."""
    if rows == bucket:
        return list(arrays)
    out = []
    for a in arrays:
        pad = np.zeros((bucket - rows,) + a.shape[1:], dtype=a.dtype)
        out.append(np.concatenate([a, pad], axis=0))
    return out


_req_ids = itertools.count(1)
_batch_ids = itertools.count(1)


class Request:
    """One admitted inference request. ``inputs`` is a list of arrays whose
    leading dim is the row count (all inputs must agree). Terminates in
    exactly one of: ``result`` set, ``error`` set. ``priority`` is the
    admission class (0 = highest; lower classes are shed first under
    overload); ``on_done`` (set by the server) fires exactly once at
    termination so the admission controller's in-system count stays exact."""

    __slots__ = ("id", "inputs", "rows", "signature", "deadline",
                 "enqueued_at", "result", "error", "_done", "priority",
                 "on_done", "version", "trace")

    def __init__(self, inputs, deadline=None, now=0.0, request_id=None,
                 priority=0):
        self.inputs = [np.asarray(a) for a in inputs]
        if not self.inputs:
            raise ValueError("empty request: no input arrays")
        self.signature = signature_of(self.inputs)
        rows = {int(a.shape[0]) for a in self.inputs}
        if len(rows) != 1:
            raise ValueError(
                f"request inputs disagree on row count: {sorted(rows)}")
        self.rows = rows.pop()
        if self.rows < 1:
            raise ValueError("request has zero rows")
        self.id = request_id if request_id is not None else next(_req_ids)
        self.deadline = deadline          # absolute, server-clock seconds
        self.enqueued_at = now
        self.priority = int(priority)
        self.result = None
        self.error = None
        self.on_done = None
        # model version of the replica that produced the result (set by
        # the server before scatter; None until then / for failures) —
        # rides the wire frame so a client A/B is attributable
        self.version = None
        # request-level Trace (profiler.tracing), attached by the server at
        # admission; None when tracing is off or the ring is full
        self.trace = None
        self._done = threading.Event()

    def done(self):
        return self._done.is_set()

    def wait(self, timeout=None):
        """Block until the request terminates (threaded servers). Pump-mode
        tests never call this — results are set synchronously."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id} not done in {timeout}s")
        return self

    def set_result(self, outputs):
        first = not self._done.is_set()
        self.result = outputs
        self._done.set()
        if first and self.on_done is not None:
            self.on_done(self)

    def set_error(self, exc):
        first = not self._done.is_set()
        self.error = exc
        self._done.set()
        if first and self.on_done is not None:
            self.on_done(self)


class Batch:
    """Requests of one signature stacked and padded to one bucket."""

    __slots__ = ("id", "signature", "requests", "rows", "bucket", "arrays",
                 "tried_replicas", "dispatch_info")

    def __init__(self, requests, buckets):
        self.id = next(_batch_ids)
        self.signature = requests[0].signature
        self.requests = list(requests)
        self.rows = sum(r.rows for r in requests)
        self.bucket = bucket_for(self.rows, buckets)
        stacked = [
            np.concatenate([r.inputs[i] for r in requests], axis=0)
            for i in range(len(requests[0].inputs))]
        self.arrays = pad_rows(stacked, self.rows, self.bucket)
        self.tried_replicas = set()
        # last dispatch attempt's placement facts (replica idx, hedge role,
        # version, exec t0/t1) — stashed by Scheduler._attempt (two clock
        # reads + one dict, hot-path cheap) and turned into retroactive
        # scheduler.dispatch / replica.exec trace spans by the server,
        # outside the hot path
        self.dispatch_info = None

    def scatter_outputs(self, outputs):
        """Slice the (bucket-row) outputs back to per-request results and
        complete every request. Output row dim must equal the bucket."""
        off = 0
        for req in self.requests:
            req.set_result([np.asarray(o)[off:off + req.rows]
                            for o in outputs])
            off += req.rows

    def fail(self, exc):
        for req in self.requests:
            if not req.done():
                req.set_error(exc)

    def describe(self):
        return {"batch": self.id, "rows": self.rows, "bucket": self.bucket,
                "requests": [r.id for r in self.requests],
                "signature": [list(s) + [d] for s, d in self.signature]}


class BatchQueue:
    """Bounded FIFO of admitted requests with deadline-aware admission.

    ``put`` is the ``serving.enqueue`` injection site and the load-shedding
    chokepoint; ``assemble`` greedily builds the largest same-signature batch
    the bucket set allows, expiring dead requests as it goes.
    """

    def __init__(self, max_size, clock=None, metrics=None,
                 retry_after_hint=None):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1: {max_size}")
        self.max_size = int(max_size)
        self._clock = clock
        self._metrics = metrics
        # optional fn(reason) -> seconds; the server points this at the
        # admission controller so queue-full sheds carry a retry_after too
        self._retry_after_hint = retry_after_hint
        self._pending = []
        self._lock = threading.Lock()
        self.not_empty = threading.Condition(self._lock)

    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.monotonic()

    def __len__(self):
        with self._lock:
            return len(self._pending)

    def depth(self):
        return len(self)

    def _hint(self, reason):
        if self._retry_after_hint is None:
            return None
        try:
            return self._retry_after_hint(reason)
        except Exception:
            return None

    def put(self, request):
        """Admit or shed. Raises :class:`ServerOverloaded` when the queue is
        full or the deadline is already unmeetable; never blocks."""
        maybe_inject("serving.enqueue", ServerOverloaded)
        now = self._now()
        if request.deadline is not None and request.deadline <= now:
            if self._metrics:
                self._metrics.inc("shed", reason="deadline")
            raise ServerOverloaded(
                f"request {request.id}: deadline {request.deadline:.3f} "
                f"already unmeetable at enqueue (now {now:.3f})",
                retry_after=self._hint("deadline"))
        with self.not_empty:
            if len(self._pending) >= self.max_size:
                if self._metrics:
                    self._metrics.inc("shed", reason="queue_full")
                raise ServerOverloaded(
                    f"request {request.id}: queue full "
                    f"({self.max_size} pending); shedding load",
                    retry_after=self._hint("queue_full"))
            request.enqueued_at = now
            self._pending.append(request)
            if self._metrics:
                self._metrics.inc("submitted")
            self.not_empty.notify()
        return request

    def _expire_locked(self, now):
        """Complete (with DeadlineExceeded) and drop requests whose deadline
        passed while queued — they must not consume a batch slot."""
        live = []
        for req in self._pending:
            if req.deadline is not None and req.deadline <= now:
                req.set_error(DeadlineExceeded(
                    f"request {req.id} expired in queue after "
                    f"{now - req.enqueued_at:.3f}s"))
                if self._metrics:
                    self._metrics.inc("shed", reason="deadline")
            else:
                live.append(req)
        self._pending = live

    def assemble(self, buckets, max_rows=None):
        """Pop the oldest request's signature group and build one padded
        :class:`Batch` (None if the queue is empty after expiry). Greedy up
        to the largest bucket (or ``max_rows``)."""
        cap = max_rows or buckets[-1]
        now = self._now()
        with self._lock:
            self._expire_locked(now)
            if not self._pending:
                return None
            sig = self._pending[0].signature
            take, rest, rows = [], [], 0
            for req in self._pending:
                if req.signature == sig and rows + req.rows <= cap:
                    take.append(req)
                    rows += req.rows
                else:
                    rest.append(req)
            self._pending = rest
        return Batch(take, buckets)

    def wait_nonempty(self, timeout):
        """Threaded-server helper: block until something is queued."""
        with self.not_empty:
            if self._pending:
                return True
            return self.not_empty.wait(timeout)

    def drain(self, exc):
        """Fail every queued request (server shutdown / crash path)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for req in pending:
            req.set_error(exc)
        return len(pending)


class BucketedExecutor:
    """A predictor wrapper that proves compiles stay bounded.

    Every distinct (full-shape, dtype) signature reaching the predictor is a
    potential capture; because the batcher only ever sends bucket
    shapes, the set of signatures per model is ``len(buckets)``. The
    executor counts cache misses (``compile_count``) and enforces a hard
    bound (``max_cached``) by LRU-evicting both its own key table and the
    predictor's jit cache — the cache cannot grow without bound even if a
    caller bypasses bucketing.
    """

    def __init__(self, predictor, max_cached=32):
        self.predictor = predictor
        self.max_cached = int(max_cached)
        self.compile_count = 0
        self._keys = {}   # sig key -> last-use tick (LRU)
        self._tick = 0

    def _key(self, arrays):
        return tuple((tuple(np.asarray(a).shape), str(np.asarray(a).dtype))
                     for a in arrays)

    def run(self, arrays):
        key = self._key(arrays)
        self._tick += 1
        if key not in self._keys:
            self.compile_count += 1
            if len(self._keys) >= self.max_cached:
                victim = min(self._keys, key=self._keys.get)
                del self._keys[victim]
                cache = getattr(self.predictor, "_jit_cache", None)
                if cache:
                    # predictor keys are the same (shape, dtype) tuples,
                    # taken before any cast: dropping the entry frees its
                    # graph and memory pool
                    cache.pop(victim, None)
        self._keys[key] = self._tick
        return self.predictor.run(list(arrays))

    def warmup(self, signature, buckets):
        """Pre-compile every bucket for one signature by running zero
        batches — server start pays the compile cost, not the first user."""
        for b in buckets:
            arrays = [np.zeros((b,) + shape, dtype=dtype)
                      for shape, dtype in signature]
            self.run(arrays)
