"""Always-on metrics registry: counters, gauges, histograms + exporter.

Port of paddle_tpu/profiler/metrics.py: the same names, snapshot and file
formats (Prometheus series keep the ``paddle_tpu_`` prefix), so one
scraper and the reference's tools read both packages' artifacts.

The profiler's host recorder only keeps samples while tracing is enabled —
right for a timeline, wrong for production gauges (serving queue depth,
integrity check cost, straggler ratios all vanished the moment nobody was
tracing). This registry is the always-on half of observability:

- **counters** — monotonic totals (``inc_counter``);
- **gauges** — last-value samples (``set_gauge``) or pull-style callables
  (``register_gauge_fn``) evaluated at snapshot time;
- **histograms** — bucketed distributions (``observe``) with
  bucket-interpolated percentile estimates;
- a bounded **sample ring** backing :func:`paddle_tpu.profiler
  .counter_samples` so the existing test/CI-gate API keeps working.

Label sets are bounded per metric name (``max_label_sets``): past the cap
new label combinations fold into one ``{overflow="true"}`` series and the
``metrics.dropped_label_sets_total`` self-counter increments, so a
cardinality bug degrades gracefully instead of eating the heap.

The exporter writes per-rank snapshots into ``PADDLE_TPU_ARTIFACTS_DIR``
(same directory as flight-recorder dumps) with the autotune cache's
tmp+``os.replace`` discipline, so a crash mid-export can never leave a torn
file: ``metrics_rank<N>.prom`` (Prometheus text, node_exporter-style
textfile collector format) and ``metrics_rank<N>.jsonl`` (recent snapshot
history, one JSON object per line). Export cadence is
``FLAGS_metrics_export_interval`` seconds; 0 disables. The write path
carries a ``fs.write`` fault-injection site so the chaos suite can prove
atomicity under injected failures.

Metric names follow ``subsystem.noun_unit`` (docs/observability.md);
``tools/check_metric_names.py`` lints call sites against the manifest.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import threading
import time

__all__ = [
    "MetricsRegistry", "MetricsExporter", "get_registry", "get_exporter",
    "reset_registry", "DEFAULT_BUCKETS_MS",
]

# default histogram buckets, tuned for millisecond-scale timings (the
# dominant unit in this codebase); values outside land in +Inf
DEFAULT_BUCKETS_MS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
    250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)

_MAX_LABEL_SETS = 64
_SAMPLE_RING = 65536
_JSONL_HISTORY = 64

_OVERFLOW_KEY = (("overflow", "true"),)


def _labels_key(labels):
    """Canonical hashable form of a label mapping (sorted (k, v) tuples)."""
    if not labels:
        return ()
    items = labels.items() if isinstance(labels, dict) else labels
    return tuple(sorted((str(k), str(v)) for k, v in items))


class _Histogram:
    __slots__ = ("bounds", "counts", "count", "sum", "min", "max",
                 "exemplars")

    def __init__(self, bounds):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        # per-bucket exemplar: the LAST trace_id observed into each bucket,
        # linking a histogram outlier back to a retained request trace
        self.exemplars = [None] * (len(self.bounds) + 1)

    def observe(self, value, exemplar=None):
        v = float(value)
        idx = bisect.bisect_left(self.bounds, v)
        self.counts[idx] += 1
        if exemplar is not None:
            self.exemplars[idx] = exemplar
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q):
        """Bucket-interpolated percentile estimate (q in [0, 100])."""
        if self.count == 0:
            return 0.0
        target = q / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= target and c:
                lo = self.bounds[i - 1] if i else (self.min or 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else \
                    (self.max if self.max is not None else lo)
                frac = (target - seen) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                # clamp to the observed range: interpolation must not
                # report a percentile outside what was actually seen
                if self.max is not None:
                    est = min(est, self.max)
                if self.min is not None:
                    est = max(est, self.min)
                return est
            seen += c
        return self.max if self.max is not None else 0.0

    def le_labels(self):
        return tuple(_prom_val(b) for b in self.bounds) + ("+Inf",)

    def summary(self):
        # cumulative per-bucket counts keyed by the prometheus ``le`` label
        # (what offline burn-rate math needs from scrape/jsonl history)
        cum, buckets = 0, []
        for le, c in zip(self.le_labels(), self.counts):
            cum += c
            buckets.append([le, cum])
        exemplars = {le: ex for le, ex in zip(self.le_labels(),
                                              self.exemplars)
                     if ex is not None}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "buckets": buckets,
            "exemplars": exemplars,
        }


class MetricsRegistry:
    """Process-wide, thread-safe, always-on metric store.

    Independent of profiler enablement by design: ``record_counter`` (and
    through it every serving / integrity / autotune gauge) lands here
    whether or not anyone is tracing.
    """

    def __init__(self, max_label_sets=_MAX_LABEL_SETS,
                 sample_ring=_SAMPLE_RING):
        self._lock = threading.Lock()
        self._max_label_sets = int(max_label_sets)
        self._counters = {}      # guarded-by: _lock ((name, labels_key) -> float)
        self._gauges = {}        # guarded-by: _lock ((name, labels_key) -> float)
        self._gauge_fns = {}     # guarded-by: _lock (name -> callable() -> number)
        self._histograms = {}    # guarded-by: _lock (name -> _Histogram)
        self._label_sets = {}    # guarded-by: _lock (name -> set of labels_key)
        self._dropped_label_sets = 0  # guarded-by: _lock
        self._samples = collections.deque(
            maxlen=int(sample_ring))  # guarded-by: _lock

    # -- label bounding --------------------------------------------------------
    def _bound(self, name, labels_key):  # requires-lock: _lock
        """Admit a labels_key for `name`, folding overflow past the cap.
        Caller holds the lock."""
        seen = self._label_sets.setdefault(name, set())
        if labels_key in seen:
            return labels_key
        if len(seen) >= self._max_label_sets:
            self._dropped_label_sets += 1
            seen.add(_OVERFLOW_KEY)
            return _OVERFLOW_KEY
        seen.add(labels_key)
        return labels_key

    # -- recording -------------------------------------------------------------
    def inc_counter(self, name, value=1.0, labels=None):
        key = _labels_key(labels)
        with self._lock:
            key = self._bound(name, key)
            k = (name, key)
            self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def set_gauge(self, name, value, labels=None):
        key = _labels_key(labels)
        with self._lock:
            key = self._bound(name, key)
            self._gauges[(name, key)] = float(value)

    def register_gauge_fn(self, name, fn):
        """Pull-style gauge: `fn()` is evaluated at snapshot/export time."""
        with self._lock:
            self._gauge_fns[name] = fn

    def observe(self, name, value, buckets=None, exemplar=None):
        with self._lock:
            self._observe_locked(name, value, buckets, exemplar)

    def observe_many(self, items):
        """Batch form of :meth:`observe` — one lock acquisition for a list
        of (name, value) pairs (the steptimer's per-step flush)."""
        with self._lock:
            for name, value in items:
                self._observe_locked(name, value, None)

    def _observe_locked(self, name, value, buckets, exemplar=None):
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = _Histogram(
                buckets or DEFAULT_BUCKETS_MS)
        h.observe(value, exemplar)

    def record_sample(self, name, value, ts_us=None):
        """The always-on half of ``profiler.record_counter``: append to the
        bounded sample ring (backs ``counter_samples()``) and fold into the
        name's histogram so percentiles survive the ring."""
        if ts_us is None:
            ts_us = time.perf_counter_ns() / 1000.0
        with self._lock:
            self._samples.append((name, ts_us, value))
            self._observe_locked(name, value, None)

    # -- reading ---------------------------------------------------------------
    def counter_samples(self, name=None):
        with self._lock:
            samples = list(self._samples)
        if name is None:
            return samples
        return [s for s in samples if s[0] == name]

    def clear_samples(self):
        """Empty the sample ring only (aggregates survive). Called by
        ``start_profiler``/``reset_profiler`` to keep the historical
        samples-start-at-session-start contract tests rely on."""
        with self._lock:
            self._samples.clear()

    def counter_value(self, name, labels=None):
        with self._lock:
            return self._counters.get((name, _labels_key(labels)), 0.0)

    def gauge_value(self, name, labels=None):
        with self._lock:
            return self._gauges.get((name, _labels_key(labels)))

    def histogram_summary(self, name):
        with self._lock:
            h = self._histograms.get(name)
            return h.summary() if h is not None else None

    def histogram_counts(self, name):
        """Raw bucket state for `name` — non-cumulative per-bucket counts
        aligned with ``bounds`` (+Inf last), totals, and per-bucket
        exemplars. The accessor SLO burn-rate math samples at window
        boundaries (serving/metrics.py)."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                return None
            return {"bounds": list(h.bounds), "counts": list(h.counts),
                    "count": h.count, "sum": h.sum,
                    "exemplars": list(h.exemplars)}

    def snapshot(self):
        """Plain-dict snapshot of every series (JSONL export payload)."""
        with self._lock:
            counters = {_series(k): v for k, v in self._counters.items()}
            gauges = {_series(k): v for k, v in self._gauges.items()}
            hists = {name: h.summary()
                     for name, h in self._histograms.items()}
            fns = dict(self._gauge_fns)
            dropped = self._dropped_label_sets
        for name, fn in fns.items():
            try:
                gauges[name] = float(fn())
            except Exception:
                gauges[name] = None  # a broken gauge must not break export
        return {"counters": counters, "gauges": gauges,
                "histograms": hists,
                "dropped_label_sets": dropped}

    def prometheus_text(self):
        """Prometheus exposition text (textfile-collector compatible).
        Dots/slashes in internal names become underscores; every series
        gets a ``paddle_tpu_`` namespace prefix."""
        snap = self.snapshot()
        lines = []
        for series, v in sorted(snap["counters"].items()):
            name, labels = _split_series(series)
            lines.append(f"# TYPE {_prom_name(name)} counter")
            lines.append(f"{_prom_name(name)}{labels} {_prom_val(v)}")
        for series, v in sorted(snap["gauges"].items()):
            if v is None:
                continue
            name, labels = _split_series(series)
            lines.append(f"# TYPE {_prom_name(name)} gauge")
            lines.append(f"{_prom_name(name)}{labels} {_prom_val(v)}")
        for name, s in sorted(snap["histograms"].items()):
            p = _prom_name(name)
            lines.append(f"# TYPE {p} summary")
            lines.append(f"{p}_count {s['count']}")
            lines.append(f"{p}_sum {_prom_val(s['sum'])}")
            for q in ("p50", "p99"):
                lines.append(
                    f"{p}{{quantile=\"0.{q[1:]}\"}} {_prom_val(s[q])}")
            # cumulative buckets as a sibling counter family: the summary
            # lines above stay byte-stable for old dashboards, and offline
            # burn-rate math gets real bucket counts from scrape history
            lines.append(f"# TYPE {p}_bucket counter")
            for le, cum in s.get("buckets", ()):
                lines.append(f"{p}_bucket{{le=\"{le}\"}} {cum}")
        lines.append("# TYPE paddle_tpu_metrics_dropped_label_sets_total "
                     "counter")
        lines.append("paddle_tpu_metrics_dropped_label_sets_total "
                     f"{snap['dropped_label_sets']}")
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._gauge_fns.clear()
            self._histograms.clear()
            self._label_sets.clear()
            self._dropped_label_sets = 0
            self._samples.clear()


def _series(key):
    name, labels_key = key
    if not labels_key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels_key)
    return f"{name}{{{inner}}}"


def _split_series(series):
    if "{" not in series:
        return series, ""
    name, _, rest = series.partition("{")
    return name, "{" + rest


def _prom_name(name):
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"paddle_tpu_{safe}"


def _prom_val(v):
    return repr(float(v))


def _atomic_write(path, text):
    """tmp + os.replace, the autotune-cache discipline: readers only ever
    see a complete file. Carries the ``fs.write`` chaos site."""
    from ..resilience.faults import maybe_inject
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        maybe_inject("fs.write", OSError)
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class MetricsExporter:
    """Per-rank periodic snapshot writer.

    ``maybe_export()`` is cheap enough to call from a step loop (one clock
    read while the interval hasn't elapsed); ``start()`` runs a daemon
    thread instead for processes with no step loop (serving). Export
    failures are counted, never raised — observability must not take the
    job down.
    """

    def __init__(self, registry=None, interval=None, directory=None,
                 rank=None, clock=None, history=_JSONL_HISTORY):
        self._registry = registry if registry is not None else get_registry()
        self._interval = interval
        self._directory = directory
        self._rank = rank
        self._clock = clock or time.monotonic
        self._history = collections.deque(
            maxlen=int(history))  # guarded-by: _export_lock
        self._last = None        # guarded-by: _export_lock
        self._thread = None
        self._stop = threading.Event()
        self._export_lock = threading.Lock()
        self.exports = 0           # guarded-by: _export_lock
        self.export_failures = 0   # guarded-by: _export_lock

    @property
    def interval(self):
        if self._interval is not None:
            return float(self._interval)
        from ..framework.flags import get_flag
        return float(get_flag("FLAGS_metrics_export_interval", 60.0) or 0.0)

    def _dir(self):
        if self._directory is not None:
            return self._directory
        from ..resilience.recorder import artifacts_dir
        return artifacts_dir()

    def _rank_no(self):
        if self._rank is not None:
            return int(self._rank)
        from ..distributed.env import get_rank
        return get_rank()

    @property
    def prom_path(self):
        return os.path.join(self._dir(), f"metrics_rank{self._rank_no()}.prom")

    @property
    def jsonl_path(self):
        return os.path.join(self._dir(),
                            f"metrics_rank{self._rank_no()}.jsonl")

    def export_once(self):
        """One snapshot → both files, atomically. Raises OSError on write
        failure (maybe_export swallows and counts it)."""
        with self._export_lock:
            snap = self._registry.snapshot()
            snap["ts"] = time.time()
            snap["rank"] = self._rank_no()
            text = self._registry.prometheus_text()
            self._history.append(json.dumps(snap, sort_keys=True))
            _atomic_write(self.prom_path, text)
            _atomic_write(self.jsonl_path, "\n".join(self._history) + "\n")
            self.exports += 1
        return self.prom_path, self.jsonl_path

    def maybe_export(self, now=None):
        """Export iff the interval has elapsed; False otherwise. Never
        raises: a failed export re-arms the timer (no tight retry loop)
        and bumps ``export_failures``."""
        interval = self.interval
        if interval <= 0:
            return False
        now = self._clock() if now is None else now
        with self._export_lock:
            if self._last is not None and now - self._last < interval:
                return False
            self._last = now
        try:
            self.export_once()
        except OSError:
            with self._export_lock:
                self.export_failures += 1
            self._registry.inc_counter("metrics.export_failures_total")
            return False
        return True

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(max(self.interval, 1.0)):
                self.maybe_export(now=float("inf"))

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="paddle-tpu-metrics-exporter")
        self._thread.start()
        return self

    def stop(self, final_export=True):
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
        if final_export:
            try:
                self.export_once()
            except OSError:
                with self._export_lock:
                    self.export_failures += 1


_registry = MetricsRegistry()
_exporter = None
_exporter_lock = threading.Lock()


def get_registry():
    return _registry


def get_exporter():
    global _exporter
    if _exporter is None:
        with _exporter_lock:
            if _exporter is None:
                _exporter = MetricsExporter(_registry)
    return _exporter


def reset_registry():
    """Full reset (tests): aggregates, samples, and the cached exporter."""
    global _exporter
    _registry.reset()
    with _exporter_lock:
        if _exporter is not None:
            _exporter.stop(final_export=False)
        _exporter = None
