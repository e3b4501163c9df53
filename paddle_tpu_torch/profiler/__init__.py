"""Profiler (port of paddle_tpu/profiler/__init__.py: the host recorder,
``RecordEvent``, the v2 ``Profiler`` and the classic API).

Host spans go to a lightweight in-process recorder, exported as a chrome
trace (the reference's format and keys, so ``tools/trace_merge.py`` reads
the port's ``trace_rank<N>.json``). The device timeline is
``torch.profiler``'s where the reference's is ``jax.profiler``'s: a
``Profiler`` with a ``GPU`` (or ``TPU``) target runs a ``torch.profiler``
window beside the host recorder (during each active window of its
scheduler, else from start to stop) and writes its own chrome trace
(``device_trace_path``). ``RecordEvent`` also opens
``torch.profiler.record_function`` while tracing, the counterpart of the
reference's ``TraceAnnotation``, so host spans name their kernels in the
device trace. The reference merges the spans of its native ``csrc/``
recorder into the same timeline; the port has no native binding yet
(ROADMAP A13), so its traces hold the Python spans only.

Always-on metrics (queue depth, integrity cost, step-phase times) live in
the companion registry (:mod:`.metrics`): ``record_counter`` feeds it
unconditionally and only also lands on the chrome "C" track while tracing
is enabled. Step-phase attribution is in :mod:`.steptimer`, request
tracing in :mod:`.tracing`.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time

from . import metrics, steptimer, tracing  # noqa: F401
from . import metrics as _metrics
from .metrics import get_registry  # noqa: F401
from .steptimer import get_steptimer  # noqa: F401
from .tracing import RequestTracer, get_tracer, set_tracer  # noqa: F401

__all__ = [
    "metrics", "steptimer", "tracing", "get_registry", "get_steptimer",
    "RequestTracer", "get_tracer", "set_tracer",
    "Profiler", "RecordEvent", "ProfilerTarget", "ProfilerState",
    "start_profiler", "stop_profiler", "reset_profiler", "profiler",
    "export_chrome_tracing", "export_rank_trace", "summary",
    "record_counter", "counter_samples",
]


class _HostEventRecorder:
    def __init__(self):
        self._events = []    # (name, start_us, dur_us, tid, cat)
        self._counters = []  # (name, ts_us, value) chrome "C" events
        self._instants = []  # (name, ts_us, args) chrome "i" events
        self._lock = threading.Lock()
        self.enabled = False

    def record(self, name, start_us, dur_us, tid, cat=None):
        if not self.enabled:
            return
        with self._lock:
            self._events.append((name, start_us, dur_us, tid, cat or "host"))

    def record_counter(self, name, value, ts_us=None):
        if not self.enabled:
            return
        if ts_us is None:
            ts_us = time.perf_counter_ns() / 1000.0
        with self._lock:
            self._counters.append((name, ts_us, value))

    def record_instant(self, name, ts_us=None, args=None):
        if not self.enabled:
            return
        if ts_us is None:
            ts_us = time.perf_counter_ns() / 1000.0
        with self._lock:
            self._instants.append((name, ts_us, args))

    def clear(self):
        with self._lock:
            self._events.clear()
            self._counters.clear()
            self._instants.clear()

    def chrome_trace(self):
        with self._lock:
            events = list(self._events)
            counters = list(self._counters)
            instants = list(self._instants)
        evs = [{
            "name": name, "ph": "X", "ts": start, "dur": dur,
            "pid": os.getpid(), "tid": tid, "cat": cat,
        } for name, start, dur, tid, cat in events]
        evs.extend({
            "name": name, "ph": "C", "ts": ts, "pid": os.getpid(),
            "args": {"value": value}, "cat": "counter",
        } for name, ts, value in counters)
        evs.extend({
            "name": name, "ph": "i", "ts": ts, "pid": os.getpid(),
            "s": "p", "args": args or {}, "cat": "instant",
        } for name, ts, args in instants)
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def aggregate(self, event_type=None):
        agg = {}
        with self._lock:
            events = list(self._events)
        for name, _start, dur, _tid, cat in events:
            if event_type is not None and cat != event_type:
                continue
            tot, cnt, mx = agg.get(name, (0.0, 0, 0.0))
            agg[name] = (tot + dur, cnt + 1, max(mx, dur))
        return agg

    def categories(self):
        """{span name: cat} (the last writer wins) for summary()."""
        with self._lock:
            return {name: cat for name, _s, _d, _t, cat in self._events}


_recorder = _HostEventRecorder()


def _torch_tracing():
    """Whether a torch.profiler window is recording on this process."""
    import torch
    return torch.autograd._profiler_enabled()


class RecordEvent:
    """platform/profiler.h RecordEvent parity (an RAII span): a context
    manager or a decorator. While the host recorder or a torch.profiler
    window records, it also opens ``torch.profiler.record_function`` of
    its name."""

    def __init__(self, name, event_type=None):
        self.name = name
        self.event_type = event_type  # chrome `cat`; filterable in summary()
        self._start = None
        self._annotation = None

    def begin(self):
        self._start = time.perf_counter_ns()
        if _recorder.enabled or _torch_tracing():
            import torch
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()

    def end(self):
        if self._start is None:
            return
        dur_us = (time.perf_counter_ns() - self._start) / 1000.0
        _recorder.record(self.name, self._start / 1000.0, dur_us,
                         threading.get_ident(), self.event_type)
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
            self._annotation = None
        self._start = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapped(*a, **k):
            with RecordEvent(self.name, self.event_type):
                return fn(*a, **k)
        return wrapped


class ProfilerTarget:
    CPU = "cpu"
    GPU = "gpu"
    TPU = "tpu"


class ProfilerState:
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class Profiler:
    """paddle.profiler.Profiler (v2 API) parity.

    ``scheduler=(skip, warmup, active, repeat)`` windows the host recorder
    as paddle.profiler.make_scheduler does: each cycle records nothing for
    ``skip`` steps, records and then discards for ``warmup`` steps, and
    keeps ``active`` steps of spans (``on_trace_ready`` fires at the end
    of each active window). ``repeat`` bounds the number of cycles; 0 is
    unbounded. Driven by :meth:`step`, which also stamps a chrome instant
    event per boundary and feeds samples/sec through the metrics registry.

    With a ``GPU`` or ``TPU`` target (and not ``timer_only``) a
    ``torch.profiler`` window records the card (and the host's operators)
    during each active window, or from :meth:`start` to :meth:`stop`
    without a scheduler; each window's chrome trace is written to
    ``device_trace_path`` before ``on_trace_ready`` fires, and
    ``torch_profiler`` is the last window's ``torch.profiler.profile``.
    """

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        self.targets = targets or [ProfilerTarget.CPU, ProfilerTarget.GPU]
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self._tmpdir = None
        self._device_trace = not timer_only and any(
            t in (ProfilerTarget.GPU, ProfilerTarget.TPU)
            for t in self.targets)
        self.torch_profiler = None
        self._torch_live = False
        self._windows = 0
        self.scheduler = tuple(scheduler) if scheduler is not None else None
        if self.scheduler is not None:
            skip, warmup, active, repeat = self.scheduler
            if active < 1:
                raise ValueError("scheduler needs active >= 1")
            if skip < 0 or warmup < 0 or repeat < 0:
                raise ValueError("scheduler window values must be >= 0")
        self._step_num = 0
        self._last_step_us = None
        self._sched_phase = None  # "closed" | "warmup" | "active"

    # -- the device window (torch.profiler) --------------------------------
    def _start_device(self):
        if not self._device_trace or self._torch_live:
            return
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        if self._tmpdir is None:
            self._tmpdir = tempfile.mkdtemp(prefix="paddle_tpu_prof_")
        try:
            prof = torch.profiler.profile(
                activities=acts, record_shapes=self.record_shapes,
                profile_memory=self.profile_memory)
            prof.__enter__()
        except Exception:
            return  # another profiler holds the process: host spans only
        self.torch_profiler = prof
        self._torch_live = True

    def _stop_device(self):
        if not self._torch_live:
            return
        self._torch_live = False
        try:
            self.torch_profiler.__exit__(None, None, None)
            self._windows += 1
            self.torch_profiler.export_chrome_trace(self.device_trace_path)
        except Exception:
            pass  # a lost device trace must not fail the training step

    @property
    def device_trace_path(self):
        """The chrome trace of the last device window (None before one)."""
        if self._tmpdir is None:
            return None
        return os.path.join(self._tmpdir, "device_trace.json")

    @property
    def xplane_dir(self):
        """The directory holding the device trace (the reference's name
        for its XPlane directory)."""
        return self._tmpdir

    # -- the scheduler -------------------------------------------------------
    def _schedule_phase(self, step_num):
        skip, warmup, active, repeat = self.scheduler
        cycle = skip + warmup + active
        if repeat and step_num >= repeat * cycle:
            return "closed"
        pos = step_num % cycle
        if pos < skip:
            return "closed"
        if pos < skip + warmup:
            return "warmup"
        return "active"

    def _apply_schedule(self):
        phase = self._schedule_phase(self._step_num)
        prev, self._sched_phase = self._sched_phase, phase
        if phase == prev:
            return
        if prev == "active":
            # the active window just ended: hand the recorded spans (and
            # the device window's trace) over BEFORE the next state clears
            self._stop_device()
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
        if phase == "closed":
            _recorder.enabled = False
        elif phase == "warmup":
            _recorder.enabled = True
            _recorder.clear()
        else:  # active: drop the warmup's spans, record for real
            _recorder.enabled = True
            _recorder.clear()
            self._start_device()

    @property
    def phase(self):
        """The scheduler's state for the step now running ("closed",
        "warmup" or "active"; "active" throughout without a scheduler)."""
        return self._sched_phase if self.scheduler is not None \
            else "active"

    def start(self):
        _recorder.enabled = True
        _recorder.clear()
        _metrics.get_registry().clear_samples()
        if self.scheduler is not None:
            self._step_num = 0
            self._sched_phase = None
            self._apply_schedule()
        else:
            self._start_device()

    def stop(self):
        _recorder.enabled = False
        self._stop_device()
        if self.on_trace_ready is not None and self._sched_phase != "closed":
            # with a scheduler, a closed window already fired its callback
            self.on_trace_ready(self)

    def step(self, num_samples=None):
        """Mark a step boundary: a chrome instant event, the samples/sec
        gauge and (with a scheduler) the window transition for the step
        that begins now."""
        now_us = time.perf_counter_ns() / 1000.0
        _recorder.record_instant("profiler.step", now_us,
                                 {"step": self._step_num})
        if num_samples is not None and self._last_step_us is not None:
            dt_s = (now_us - self._last_step_us) / 1e6
            if dt_s > 0:
                _metrics.get_registry().set_gauge(
                    "profiler.samples_per_sec", num_samples / dt_s)
        self._last_step_us = now_us
        self._step_num += 1
        if self.scheduler is not None:
            self._apply_schedule()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def export(self, path, format="json"):  # noqa: A002
        export_chrome_tracing(path)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        return summary()


def record_counter(name, value, ts_us=None):
    """Record a counter sample. It always lands in the metrics registry
    (production gauges must not vanish when nobody is tracing); while
    profiling is enabled it is also a chrome counter event ("ph": "C") on
    the host timeline."""
    _metrics.get_registry().record_sample(name, value, ts_us)
    _recorder.record_counter(name, value, ts_us)


def counter_samples(name=None):
    """The recorded counter samples as ``(name, ts_us, value)`` tuples,
    optionally of one name, from the registry's bounded ring (so it works
    with profiling off); ``start_profiler``/``reset_profiler`` clear it."""
    return _metrics.get_registry().counter_samples(name)


def _trace_metadata():
    """Rank, elastic generation and a wall-clock anchor stamped into every
    exported trace, so tools/trace_merge.py can place per-rank
    perf_counter timelines on one wall clock."""
    meta = {"anchor": {"wall_s": time.time(),
                       "ts_us": time.perf_counter_ns() / 1000.0}}
    try:
        from ..distributed.env import get_rank
        meta["rank"] = get_rank()
    except Exception:
        meta["rank"] = 0
    try:
        from ..resilience.recovery import current_generation
        meta["generation"] = current_generation()
    except Exception:
        meta["generation"] = 0
    return meta


def export_chrome_tracing(path, dir_name=None):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    trace = _recorder.chrome_trace()
    trace.update(_trace_metadata())
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def export_rank_trace(directory=None):
    """Export this rank's chrome trace as ``trace_rank<N>.json`` into the
    artifacts dir (``PADDLE_TPU_ARTIFACTS_DIR``), beside the flight
    recorder's dumps: the layout tools/trace_merge.py reads."""
    from ..distributed.env import get_rank
    if directory is None:
        from ..resilience.recorder import artifacts_dir
        directory = artifacts_dir()
    return export_chrome_tracing(
        os.path.join(directory, f"trace_rank{get_rank()}.json"))


def summary(sorted_by="total", event_type=None):
    """Aggregate the host spans; ``event_type`` filters to one chrome
    ``cat`` ("step_phase" shows only the step timer's spans)."""
    agg = _recorder.aggregate(event_type=event_type)
    cats = _recorder.categories()
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    header = (f"{'Event':<48}{'Cat':<12}{'Calls':>8}{'Total(us)':>14}"
              f"{'Avg(us)':>12}{'Max(us)':>12}")
    lines = [header, "-" * len(header)]
    for name, (tot, cnt, mx) in rows:
        lines.append(f"{name:<48}{cats.get(name) or 'host':<12}{cnt:>8}"
                     f"{tot:>14.1f}{tot / cnt:>12.1f}{mx:>12.1f}")
    print("\n".join(lines))
    return agg


# -- classic API (fluid/profiler.py parity) ---------------------------------

def start_profiler(state="All", tracer_option="Default"):
    _recorder.enabled = True
    _recorder.clear()
    # session semantics: counter_samples() reports samples from this start
    _metrics.get_registry().clear_samples()


def stop_profiler(sorted_key=None, profile_path=None):
    _recorder.enabled = False
    summary()


def reset_profiler():
    _recorder.clear()
    _metrics.get_registry().clear_samples()


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             tracer_option="Default"):
    start_profiler(state, tracer_option)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)
