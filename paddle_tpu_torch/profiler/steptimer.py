"""Step-phase attribution: where did this training step's time go?

Port of paddle_tpu/profiler/steptimer.py. A :class:`StepTimer` splits each
step into named phases:

- ``step/input_wait``   — blocked on the data loader;
- ``step/h2d``          — host→device transfer and batch staging;
- ``step/compile``      — discovery and capture of a compiled train step
  (jit/compiled_step.py); a steady state that keeps paying this phase is
  a retrace storm;
- ``step/compute``      — dispatch and execution of the step;
- ``step/collective_wait`` — blocked in an eager collective
  (``distributed.collective``) or in the Reducer's wait at the end of a
  backward;
- ``step/optimizer`` — kept for the reference's name;
- ``step/ckpt_io``      — the blocking checkpoint save or restore;
- ``step/integrity``    — the step guard's finiteness check.

Phases nest: a child's wall time is subtracted from its parent's self
time (a per-thread phase stack), so the per-phase totals sum to the
attributed wall time.

CUDA launches are asynchronous, so the host-side compute phase measures
dispatch, not execution. Every ``FLAGS_steptimer_sync_interval`` steps
:meth:`sync` waits for the card's work on the value's stream, so sampled
steps carry the device-inclusive step time (``device_wait_ms``) while the
others keep pipelining. A device error raised by that wait reaches the
caller: the reference's sync swallowed every exception.

Everything lands in the metrics registry (``steptimer.<phase>_ms``
histograms) and, while the profiler's host recorder records, as chrome
spans (``cat="step_phase"`` for a phase, ``cat="step"`` for a step), so
``tools/trace_merge.py`` can name the slowest rank per phase.
"""
from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager

from . import metrics as _metrics

__all__ = ["PHASES", "StepTimer", "get_steptimer", "reset_steptimer",
           "phase"]

PHASES = (
    "step/input_wait",
    "step/h2d",
    "step/compile",
    "step/compute",
    "step/collective_wait",
    "step/optimizer",
    "step/ckpt_io",
    "step/integrity",
)

_STEP_HISTORY = 4096
_EXPORT_CHECK_EVERY = 32  # steps between exporter-interval checks


def _short(name):
    return name.split("/", 1)[1] if "/" in name else name


def _percentile(values, q):
    """Nearest-rank percentile (q in [0, 100]) of a non-empty sequence."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q / 100.0 * (len(vs) - 1)))))
    return float(vs[idx])


def _first_cuda_tensor(value):
    import torch
    if isinstance(value, torch.Tensor):
        return value if value.is_cuda else None
    if isinstance(value, (list, tuple)):
        for v in value:
            t = _first_cuda_tensor(v)
            if t is not None:
                return t
    if isinstance(value, dict):
        return _first_cuda_tensor(list(value.values()))
    return None


class StepTimer:
    """Per-process step and phase attribution.

    The clock is injectable (fake-clock tests reconstruct known phase
    durations exactly); ``sync_interval`` and ``enabled`` default from the
    flags. Phases stack per thread; one step context is active per thread,
    and the aggregate state is guarded by a lock.
    """

    def __init__(self, clock=None, sync_interval=None, enabled=None,
                 registry=None):
        from ..framework.flags import get_flag
        self._clock = clock or time.perf_counter
        self._registry = registry if registry is not None \
            else _metrics.get_registry()
        self.enabled = bool(get_flag("FLAGS_steptimer", True)) \
            if enabled is None else bool(enabled)
        self.sync_interval = int(
            get_flag("FLAGS_steptimer_sync_interval", 16) or 0) \
            if sync_interval is None else int(sync_interval)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._global_phase_s = {}           # phases seen outside any step
        self._steps = collections.deque(maxlen=_STEP_HISTORY)
        self._step_count = 0
        self._overhead_s = 0.0
        self._export_countdown = _EXPORT_CHECK_EVERY

    # -- phase spans -----------------------------------------------------
    @contextmanager
    def phase(self, name):
        """Attribute the enclosed work to ``name`` (nesting-aware: the
        enclosing phase is credited only its self time)."""
        if not self.enabled:
            yield
            return
        t_in = self._clock()
        tls = self._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        frame = [name, 0.0, 0.0]  # [name, start, child wall time]
        stack.append(frame)
        frame[1] = self._clock()
        self._overhead_s += frame[1] - t_in
        try:
            yield
        finally:
            t1 = self._clock()
            dur = t1 - frame[1]
            stack.pop()
            self_s = max(0.0, dur - frame[2])
            if stack:
                stack[-1][2] += dur
            step = getattr(tls, "step", None)
            if step is not None:
                ph = step["phase_s"]
                ph[name] = ph.get(name, 0.0) + self_s
            else:
                # outside a step (standalone loaders, saves): accumulate
                # globally and feed the histogram directly
                with self._lock:
                    self._global_phase_s[name] = \
                        self._global_phase_s.get(name, 0.0) + self_s
                self._registry.observe(
                    f"steptimer.{_short(name)}_ms", self_s * 1e3)
            _chrome_span(name, frame[1], dur, "step_phase")
            self._overhead_s += self._clock() - t1

    def current_phase(self):
        """The innermost phase name open on this thread, or None."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1][0] if stack else None

    # -- step boundaries -------------------------------------------------
    @contextmanager
    def step(self, n_steps=1):
        """One step boundary (or a group of ``n_steps`` steps run by one
        call: phase and wall times are normalised per step for the
        histograms). Nested step contexts pass through."""
        if not self.enabled or getattr(self._tls, "step", None) is not None:
            yield self
            return
        t_in = self._clock()
        n = max(1, int(n_steps))
        sync_this = (self.sync_interval > 0
                     and self._step_count % self.sync_interval == 0)
        step = self._tls.step = {"phase_s": {}, "n": n, "sync": sync_this,
                                 "device_wait_s": 0.0, "t0": 0.0}
        step["t0"] = self._clock()
        self._overhead_s += step["t0"] - t_in
        try:
            yield self
        finally:
            t1 = self._clock()
            self._tls.step = None
            wall = t1 - step["t0"]
            rec = {"n": n, "wall_s": wall, "phase_s": step["phase_s"],
                   "synced": sync_this,
                   "device_wait_s": step["device_wait_s"]}
            with self._lock:
                self._steps.append(rec)
                self._step_count += n
            _chrome_span("step", step["t0"], wall, "step")
            items = [("steptimer.step_ms", wall / n * 1e3)]
            items.extend((f"steptimer.{_short(k)}_ms", v / n * 1e3)
                         for k, v in step["phase_s"].items())
            if sync_this and step["device_wait_s"]:
                items.append(("steptimer.device_wait_ms",
                              step["device_wait_s"] / n * 1e3))
            self._registry.observe_many(items)
            self._overhead_s += self._clock() - t1
            self._export_countdown -= 1
            if self._export_countdown <= 0:
                self._export_countdown = _EXPORT_CHECK_EVERY
                _metrics.get_exporter().maybe_export()

    def sync(self, value):
        """On sampled steps, wait until the card has finished the work
        queued on the stream of ``value``'s first CUDA tensor, so the
        enclosing phase (and the step's wall time) include device time;
        other steps return at once. Host values need no wait. A device
        error raised by the wait is not caught."""
        step = getattr(self._tls, "step", None)
        if step is None or not step["sync"] or value is None:
            return value
        t = _first_cuda_tensor(value)
        if t is None:
            return value
        import torch
        t0 = self._clock()
        torch.cuda.current_stream(t.device).synchronize()
        step["device_wait_s"] += self._clock() - t0
        return value

    # -- reading ---------------------------------------------------------
    def breakdown(self):
        """Attribution over the recorded window: phase totals and
        fractions, per-step wall percentiles (synced steps preferred), and
        the self-measured overhead."""
        with self._lock:
            recs = list(self._steps)
            phase_s = dict(self._global_phase_s)
            steps = self._step_count
            overhead = self._overhead_s
        wall = 0.0
        device = 0.0
        per_step_ms = []
        synced_ms = []
        for r in recs:
            wall += r["wall_s"]
            device += r["device_wait_s"]
            for k, v in r["phase_s"].items():
                phase_s[k] = phase_s.get(k, 0.0) + v
            ms = r["wall_s"] / r["n"] * 1e3
            per_step_ms.append(ms)
            if r["synced"]:
                synced_ms.append(ms)
        attributed = sum(phase_s.values())
        total = wall if wall > 0 else attributed
        basis = synced_ms or per_step_ms
        return {
            "steps": steps,
            "phase_ms": {_short(k): v * 1e3
                         for k, v in sorted(phase_s.items())},
            "phase_fraction": {
                _short(k): (v / total if total else 0.0)
                for k, v in sorted(phase_s.items())},
            "wall_ms": wall * 1e3,
            "attributed_ms": attributed * 1e3,
            "unattributed_ms": max(0.0, (wall - attributed) * 1e3)
            if wall else 0.0,
            "step_ms_p50": _percentile(basis, 50),
            "step_ms_p99": _percentile(basis, 99),
            "device_wait_ms": device * 1e3,
            "synced_steps": len(synced_ms),
            "overhead_ms": overhead * 1e3,
        }

    @property
    def overhead_ms(self):
        return self._overhead_s * 1e3

    def reset(self):
        with self._lock:
            self._global_phase_s.clear()
            self._steps.clear()
            self._step_count = 0
            self._overhead_s = 0.0


_timer = None
_timer_lock = threading.Lock()


_rec_ref = None


def _chrome_span(name, start_s, dur_s, cat):
    """A host-recorder span in the timer's clock domain (perf_counter by
    default, as RecordEvent's timestamps are). The recorder is looked up
    once and its switch read here, before the call: this runs at every
    phase exit, so while nothing records it costs two attribute loads."""
    global _rec_ref
    rec = _rec_ref
    if rec is None:
        from . import _recorder
        rec = _rec_ref = _recorder
    if not rec.enabled:
        return
    rec.record(name, start_s * 1e6, dur_s * 1e6,
               threading.get_ident(), cat)


def get_steptimer():
    global _timer
    if _timer is None:
        with _timer_lock:
            if _timer is None:
                _timer = StepTimer()
    return _timer


def reset_steptimer():
    """Drop the process timer (tests and lanes re-read the flags)."""
    global _timer
    with _timer_lock:
        _timer = None


@contextmanager
def phase(name):
    """Module-level convenience: ``with steptimer.phase("step/h2d"): ...``"""
    with get_steptimer().phase(name):
        yield
