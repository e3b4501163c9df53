"""Request-level distributed tracing with tail-based retention.

Port of paddle_tpu/profiler/tracing.py: the same names, snapshot and file
formats (Prometheus series keep the ``paddle_tpu_`` prefix), so one
scraper and the reference's tools read both packages' artifacts.

The serving analog of :mod:`.steptimer`: where the step timer decomposes a
training step into phases, a :class:`RequestTracer` decomposes one request's
latency into named spans — admission, queueing, batch assembly, dispatch,
replica execution, and (for decode) join/prefill/decode ticks — each stamped
with the context that makes a p99 outlier actionable (admission verdict and
AIMD limit, replica id, hedge role, breaker state, model version).

Dapper-style model, pared down:

- a :class:`Trace` is one request: ``trace_id`` (propagated over the wire by
  ``distributed.wire.stamp_trace``), a flat span list (``span_id``/``parent``
  links, non-nested and cross-thread safe), point events, and root
  annotations;
- spans use the injectable monotonic clock everywhere (fake-clock chaos
  tests reconstruct exact durations, zero real sleeps);
- **tail-based retention**: every request is traced into a bounded live set,
  but only traces that *end interesting* — slow (> ``FLAGS_trace_slow_ms``),
  shed, errored, hedged, or deadline-exceeded — plus a deterministic 1-in-N
  head sample (``FLAGS_trace_head_sample``) are serialized, appended to
  ``PADDLE_TPU_ARTIFACTS_DIR/request_traces_rank<N>.jsonl``. Everything else
  is dropped at zero serialization cost, which is what keeps the overhead
  under 1% of request wall time (self-measured against the *real* clock in
  ``overhead_ms``, StepTimer's contract, asserted by the serving bench).

``tools/request_trace.py`` lists and explains the flushed traces;
``tools/trace_merge.py`` overlays them onto the cross-rank timeline. The
span vocabulary is FIXED and lint-enforced (``tools/check_span_names.py``,
pass ``span-names``); see docs/observability.md for the table.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

__all__ = ["SPAN_NAMES", "Span", "Trace", "RequestTracer", "get_tracer",
           "set_tracer", "reset_tracer", "trace_path_for_rank"]

# The fixed span vocabulary. tools/check_span_names.py carries the lint-side
# manifest (ast-guarded by tests/test_lints.py); this tuple is the runtime
# mirror used for validation in tests and by request_trace.py's renderer.
SPAN_NAMES = (
    "client.submit",        # client-side submit → reply wall time
    "server.admit",         # admission verdict + AIMD limit snapshot
    "batcher.queue",        # time spent queued (put → assemble)
    "batcher.batch_assemble",  # signature grouping + bucket padding
    "scheduler.dispatch",   # placement + attempts (replica, hedge, breaker)
    "replica.exec",         # the executor run itself (model version stamp)
    "engine.join",          # decode admission: AIMD + slots + KV reserve
    "engine.prefill_chunk",  # one rationed prefill chunk
    "engine.decode_tick",   # one decode round this stream participated in
    "engine.kv_wait",       # KV block-table growth attempt
    "disagg.route",         # prefill-replica placement (disagg controller)
    "migrate.export",       # KV pages serialized to stamped wire frames
    "migrate.transfer",     # frames through the codec + StreamReader
    "migrate.adopt",        # decode-side admission of the migrated stream
)

_MAX_SPANS = 512     # per-trace span cap: a decode stream emits one
_MAX_EVENTS = 128    # decode_tick span per round — bounded, but cap anyway


def trace_path_for_rank(rank, base=None):
    if base is None:
        from ..resilience.recorder import artifacts_dir
        base = artifacts_dir()
    return os.path.join(base, f"request_traces_rank{rank}.jsonl")


class Span:
    __slots__ = ("sid", "parent", "name", "t0", "t1", "attrs")

    def __init__(self, sid, parent, name, t0, attrs=None):
        self.sid = sid
        self.parent = parent
        self.name = name
        self.t0 = t0
        self.t1 = None
        self.attrs = attrs or {}

    def to_dict(self):
        return {"sid": self.sid, "parent": self.parent, "name": self.name,
                "t0": self.t0, "t1": self.t1, "attrs": self.attrs}


class Trace:
    """One request's spans. ``active=False`` (ring overflow) makes every
    recording call a no-op so an unbounded burst degrades to uninstrumented
    requests instead of unbounded memory."""

    __slots__ = ("trace_id", "request_id", "seq", "t_start", "t_end",
                 "status", "flags", "attrs", "spans", "events", "active",
                 "finished", "_next_sid", "_open", "_clock", "_lock")

    def __init__(self, trace_id, request_id, seq, clock, active=True,
                 parent=0):
        self.trace_id = trace_id
        self.request_id = request_id
        self.seq = seq
        self._clock = clock
        self.t_start = clock()
        self.t_end = None
        self.status = None
        self.flags = set()          # "shed"/"deadline"/"error"/"hedged"/...
        self.attrs = {}
        self.spans = []
        self.events = []
        self.active = active
        self.finished = False
        self._next_sid = 1
        self._open = {}             # name -> last open span id
        self._lock = threading.Lock()
        if parent:
            self.attrs["parent_span"] = parent

    # -- recording ---------------------------------------------------------
    def begin_span(self, name, parent=0, t0=None, **attrs):
        """Open a span; returns its id (0 when inactive/capped)."""
        if not self.active:
            return 0
        with self._lock:
            if len(self.spans) >= _MAX_SPANS:
                return 0
            sid = self._next_sid
            self._next_sid += 1
            sp = Span(sid, parent, name,
                      self._clock() if t0 is None else t0, attrs or None)
            self.spans.append(sp)
            self._open[name] = sid
        return sid

    def end_span(self, sid, t1=None, **attrs):
        """Close a span by id or by name (the last open one)."""
        if not self.active or not sid:
            return
        with self._lock:
            if isinstance(sid, str):
                sid = self._open.pop(sid, 0)
                if not sid:
                    return
            for sp in reversed(self.spans):
                if sp.sid == sid:
                    if sp.t1 is None:
                        sp.t1 = self._clock() if t1 is None else t1
                    if attrs:
                        sp.attrs.update(attrs)
                    if self._open.get(sp.name) == sid:
                        self._open.pop(sp.name, None)
                    return

    @contextmanager
    def span(self, name, **attrs):
        sid = self.begin_span(name, **attrs)
        try:
            yield sid
        finally:
            self.end_span(sid)

    def record_span(self, name, t0, t1, parent=0, **attrs):
        """Retroactive span from two clock readings — the hot-path pattern:
        contracted hot functions stash two floats and the caller records the
        span after the fact, outside the hot path."""
        sid = self.begin_span(name, parent=parent, t0=t0, **attrs)
        if sid:
            self.end_span(sid, t1=t1)
        return sid

    def event(self, name, **attrs):
        if not self.active or len(self.events) >= _MAX_EVENTS:
            return
        self.events.append({"name": name, "t": self._clock(),
                            "attrs": attrs or {}})

    def annotate(self, **attrs):
        if self.active:
            self.attrs.update(attrs)

    def flag(self, name):
        """Mark a retention-forcing condition (e.g. "hedged")."""
        if self.active:
            self.flags.add(name)

    # -- reading -----------------------------------------------------------
    def duration_ms(self):
        end = self.t_end if self.t_end is not None else self._clock()
        return max(0.0, (end - self.t_start) * 1e3)

    def dominant_span(self):
        """Name of the span with the largest SELF time (wall minus children
        wall) — the one to blame for this trace's latency."""
        child_s = {}
        for sp in self.spans:
            if sp.parent and sp.t1 is not None:
                child_s[sp.parent] = child_s.get(sp.parent, 0.0) \
                    + (sp.t1 - sp.t0)
        best, best_self = None, -1.0
        for sp in self.spans:
            if sp.t1 is None:
                continue
            self_s = (sp.t1 - sp.t0) - child_s.get(sp.sid, 0.0)
            if self_s > best_self:
                best, best_self = sp.name, self_s
        return best

    def to_dict(self, rank=0, anchor=None, reason=None):
        return {
            "version": 1,
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "rank": rank,
            "status": self.status,
            "reason": reason,
            "flags": sorted(self.flags),
            "t_start": self.t_start,
            "duration_ms": self.duration_ms(),
            "dominant": self.dominant_span(),
            "anchor": anchor,
            "attrs": self.attrs,
            "spans": [s.to_dict() for s in self.spans],
            "events": self.events,
        }

    def ctx(self, span_id=0):
        """Wire-propagatable context: ``(trace_id, span_id)``."""
        return (self.trace_id, int(span_id))


class RequestTracer:
    """Process tracer: mints traces, bounds the live set, and applies the
    tail-based retention policy at finish.

    Two clocks on purpose: ``clock`` (injectable, fake in tests/bench) times
    the spans; ``overhead_clock`` (always real) self-measures the tracer's
    own cost, so the <1% overhead gate stays meaningful under a fake span
    clock — a fake clock never advances inside instrumentation, which would
    make the overhead trivially zero and the gate vacuous.
    """

    def __init__(self, clock=None, enabled=None, slow_ms=None,
                 head_sample_n=None, ring=None, artifacts=None, rank=None,
                 registry=None, overhead_clock=None):
        from ..framework.flags import get_flag
        self._clock = clock or time.perf_counter
        self._overhead_clock = overhead_clock or time.perf_counter
        self.enabled = bool(get_flag("FLAGS_request_tracing", True)) \
            if enabled is None else bool(enabled)
        self.slow_ms = float(get_flag("FLAGS_trace_slow_ms", 1000.0)) \
            if slow_ms is None else float(slow_ms)
        self.head_sample_n = int(
            get_flag("FLAGS_trace_head_sample", 100) or 0) \
            if head_sample_n is None else int(head_sample_n)
        self.ring = int(get_flag("FLAGS_trace_ring", 4096) or 1) \
            if ring is None else int(ring)
        if rank is None:
            from ..distributed.env import get_rank
            rank = get_rank()
        self.rank = int(rank)
        self.artifacts = artifacts
        self._registry = registry
        self._lock = threading.Lock()
        self._seq = 0
        self._live = 0
        self._overhead_s = 0.0
        self.retained = 0
        self.dropped = 0
        self.ring_rejections = 0
        self.flush_failures = 0
        # wall anchor: lets trace_merge place injected-clock spans on the
        # merged timeline (wall = anchor.wall_s + (t - anchor.mono_s))
        self.anchor = {"wall_s": time.time(), "mono_s": self._clock()}

    def _reg(self):
        if self._registry is None:
            from . import metrics as _metrics
            self._registry = _metrics.get_registry()
        return self._registry

    # -- lifecycle ---------------------------------------------------------
    def start(self, request_id=None, trace_id=None, parent=0, **attrs):
        """Begin tracing one request. ``trace_id``/``parent`` come from
        ``wire.frame_trace`` when the caller is downstream of a stamped
        peer; otherwise a deterministic process-local id is minted."""
        t_in = self._overhead_clock()
        with self._lock:
            self._seq += 1
            seq = self._seq
            active = self.enabled and self._live < self.ring
            if self.enabled and not active:
                self.ring_rejections += 1
            if active:
                self._live += 1
        if trace_id is None:
            trace_id = f"{self.rank:x}-{os.getpid():x}-{seq:08x}"
        tr = Trace(trace_id, request_id, seq, self._clock, active=active,
                   parent=parent)
        if attrs:
            tr.annotate(**attrs)
        self._overhead_s += self._overhead_clock() - t_in
        return tr

    def finish(self, trace, status="ok", error=None):
        """Close a trace and apply the retention policy. Idempotent — the
        first finish wins (a request can only terminate once, but defensive
        double-finishes from error paths must not double-count)."""
        if trace is None or trace.finished:
            return False
        t_in = self._overhead_clock()
        trace.finished = True
        trace.t_end = trace._clock()
        trace.status = status
        if error is not None:
            trace.attrs.setdefault("error", str(error))
            trace.attrs.setdefault("error_type", type(error).__name__)
        if trace.active:
            with self._lock:
                self._live = max(0, self._live - 1)
        reason = self._retention_reason(trace)
        retained = False
        if reason is not None and trace.active:
            retained = self._flush(trace, reason)
        else:
            with self._lock:
                self.dropped += 1
        self._overhead_s += self._overhead_clock() - t_in
        return retained

    def _retention_reason(self, trace):
        """First matching tail condition, or the deterministic head sample,
        or None (drop)."""
        if not self.enabled or not trace.active:
            return None
        if trace.status not in (None, "ok"):
            # typed terminal status: shed / deadline / error / evicted ...
            return trace.status if trace.status in ("shed", "deadline") \
                else "error"
        if "error" in trace.flags:
            return "error"
        if "shed" in trace.flags:
            return "shed"
        if "deadline" in trace.flags:
            return "deadline"
        if "hedged" in trace.flags:
            return "hedged"
        if trace.duration_ms() > self.slow_ms:
            return "slow"
        if self.head_sample_n > 0 and trace.seq % self.head_sample_n == 0:
            return "head_sample"
        return None

    def _flush(self, trace, reason):
        doc = trace.to_dict(rank=self.rank, anchor=self.anchor,
                            reason=reason)
        base = self.artifacts
        if base is None:
            from ..resilience.recorder import artifacts_dir
            base = artifacts_dir()
        path = trace_path_for_rank(self.rank, base)
        try:
            os.makedirs(base, exist_ok=True)
            # plain append: one line per trace; readers tolerate a torn
            # tail line (same contract as the recovery journal)
            with open(path, "a") as f:
                f.write(json.dumps(doc) + "\n")
        except OSError:
            with self._lock:
                self.flush_failures += 1
            try:
                self._reg().inc_counter("trace.flush_failures_total")
            except Exception:
                pass
            return False
        with self._lock:
            self.retained += 1
        try:
            self._reg().inc_counter("trace.retained_total",
                                    labels={"reason": reason})
        except Exception:
            pass
        return True

    # -- reading -----------------------------------------------------------
    @property
    def overhead_ms(self):
        return self._overhead_s * 1e3

    def stats(self):
        with self._lock:
            return {"seq": self._seq, "live": self._live,
                    "retained": self.retained, "dropped": self.dropped,
                    "ring_rejections": self.ring_rejections,
                    "flush_failures": self.flush_failures,
                    "overhead_ms": self._overhead_s * 1e3}


_tracer = None
_tracer_lock = threading.Lock()


def get_tracer():
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = RequestTracer()
    return _tracer


def set_tracer(tracer):
    """Install a specific tracer (bench lanes: fake clock + tmp artifacts).
    Returns the previous one so callers can restore it."""
    global _tracer
    with _tracer_lock:
        prev, _tracer = _tracer, tracer
    return prev


def reset_tracer():
    """Drop the process tracer (tests / bench lanes re-read FLAGS)."""
    global _tracer
    with _tracer_lock:
        _tracer = None
