"""Serving metrics: counters + latency reservoir (port of
paddle_tpu/serving/metrics.py).

One :class:`ServingMetrics` instance per :class:`~.server.InferenceServer`.
Counters are plain monotonic ints behind one lock (queue pressure is the
bottleneck long before this lock is), mirrored into the always-on registry
(``profiler.metrics``). Latencies go into a bounded reservoir so p50/p99
stay O(1) memory under sustained load. :meth:`snapshot` is a plain dict
(the server's ``stats()`` and the chaos assertions all read it). The
reference's ``export_to_profiler`` (chrome-trace counter events in its
profiler's host recorder) waits for the port of ``profiler/`` (ROADMAP
A11).

The clock is injectable (fake-clock chaos tests record deterministic
latencies with no real sleeps).

SLO accounting rides on top: an :class:`SLO` names a latency histogram, a
target, and a goodput threshold; :meth:`ServingMetrics.slo_tick` samples the
cumulative bucket counts at window boundaries and computes **multi-window
burn rates** (how fast the error budget is being spent: 1.0 = exactly on
budget, >1 = burning faster), exported as ``paddle_tpu_slo_*`` gauges.
Good/bad is decided at bucket resolution — pick targets on (or near) bucket
bounds of :data:`~paddle_tpu_torch.profiler.metrics.DEFAULT_BUCKETS_MS`.
"""
from __future__ import annotations

import bisect
import collections
import threading

__all__ = ["ServingMetrics", "SLO", "percentile"]

_RESERVOIR = 4096
_SLO_WINDOWS = (60.0, 300.0, 3600.0)
_SLO_SAMPLES = 4096     # bounded (t, total, good) history per SLO


def percentile(values, q):
    """Nearest-rank percentile (q in [0, 100]) of a non-empty sequence."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q / 100.0 * (len(vs) - 1)))))
    return float(vs[idx])


class SLO:
    """One latency SLO over an always-on histogram.

    ``target_ms`` is the per-request latency objective (TTFT/TPOT for
    decode); ``goodput`` is the fraction of requests that must meet it
    (0.99 → a 1% error budget). Burn rate over a window is
    ``bad_fraction / (1 - goodput)`` computed from cumulative histogram
    counts sampled at tick time — the multiwindow form pages on fast burn
    (short window) without flapping on noise (long window).
    """

    __slots__ = ("name", "metric", "target_ms", "goodput", "windows",
                 "_samples")

    def __init__(self, name, metric, target_ms, goodput=0.99,
                 windows=_SLO_WINDOWS):
        self.name = name
        self.metric = metric
        self.target_ms = float(target_ms)
        self.goodput = min(float(goodput), 1.0 - 1e-9)
        self.windows = tuple(float(w) for w in windows)
        self._samples = collections.deque(maxlen=_SLO_SAMPLES)

    def _counts(self, registry):
        h = registry.histogram_counts(self.metric)
        if h is None:
            return 0, 0
        # observations at or under the largest bucket bound <= target —
        # bucket-resolution goodput, exact when the target sits on a bound
        j = bisect.bisect_right(h["bounds"], self.target_ms)
        return h["count"], sum(h["counts"][:j])

    def sample(self, now, registry):
        total, good = self._counts(registry)
        self._samples.append((float(now), total, good))

    def burn_rates(self, now=None):
        """{window_s: burn rate} from the recorded samples. A window with
        no traffic burns at 0.0 (nothing was missed)."""
        if not self._samples:
            return {w: 0.0 for w in self.windows}
        t_now, total_now, good_now = self._samples[-1]
        if now is not None:
            t_now = float(now)
        budget = 1.0 - self.goodput
        out = {}
        for w in self.windows:
            t_lo = t_now - w
            then = self._samples[0]
            for s in self._samples:
                if s[0] >= t_lo:
                    then = s
                    break
            d_total = total_now - then[1]
            d_bad = d_total - (good_now - then[2])
            frac = (d_bad / d_total) if d_total > 0 else 0.0
            out[w] = frac / budget
        return out

    def burn(self, window=None, now=None):
        """Burn rate over one window — the nearest recorded window to
        ``window``, or the shortest (the fast-burn signal per-stage
        admission and per-class autoscaling key off) when None."""
        rates = self.burn_rates(now)
        if not rates:
            return 0.0
        if window is None:
            return rates[min(rates)]
        w = min(self.windows, key=lambda x: abs(x - float(window)))
        return rates.get(w, 0.0)


class ServingMetrics:
    COUNTERS = (
        "submitted",        # requests admitted to the queue
        "completed",        # requests finished with a result
        "failed",           # requests finished with an error set
        "shed",             # requests rejected (ServerOverloaded) or expired
        "batches",          # batches dispatched
        "retries",          # batch dispatch retries after a replica failure
        "rows",             # real rows executed
        "padded_rows",      # padding rows executed (bucket slack)
        "replica_deaths",   # replicas marked dead
        "replica_restarts", # replicas restarted after draining
        "breaker_opens",    # circuit breakers tripped open
        "breaker_closes",   # breakers closed after preflight + canary
        "hedges",           # hedged (re-placed) dispatches
        "hedge_wins",       # hedge attempts that delivered the result
        "scale_ups",        # autoscaler replicas added
        "scale_downs",      # autoscaler replicas drained + removed
        "scale_failures",   # resize attempts that failed (journaled)
        "late_drops",       # fenced results from removed replicas, dropped
    )

    # `shed` is additionally labeled by cause so the overload runbook can
    # tell queue pressure from SLO misses from sick replicas from the
    # admission limiter (docs/serving.md). Mirrored into the registry as
    # serving.shed_total{reason=...}; snapshot carries shed_<reason> keys.
    SHED_REASONS = ("queue_full", "deadline", "unhealthy", "admission")

    def __init__(self, clock=None):
        self._clock = clock
        self._lock = threading.Lock()
        self._c = dict.fromkeys(self.COUNTERS, 0)
        self._lat = []          # bounded reservoir of request latencies (s)
        self._gauges = {}       # name -> fn() -> number (e.g. queue depth)
        self._slos = []         # guarded-by: _lock
        self._slo_last = None   # guarded-by: _lock (last tick time)

    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.monotonic()

    @staticmethod
    def _registry():
        from ..profiler import metrics as _metrics
        return _metrics.get_registry()

    # -- recording -----------------------------------------------------------
    def inc(self, name, n=1, reason=None):
        with self._lock:
            self._c[name] = self._c.get(name, 0) + n
            if reason is not None:
                key = f"{name}_{reason}"
                self._c[key] = self._c.get(key, 0) + n
        # always-on mirror: production counters must survive with the
        # profiler disabled (docs/observability.md naming manifest)
        self._registry().inc_counter(
            f"serving.{name}_total", n,
            labels={"reason": reason} if reason is not None else None)

    def note_version(self, version, n=1):
        """Per-model-version reply accounting (rollout attribution): the
        snapshot carries ``requests_v<version>`` keys and the registry
        mirror carries ``serving.requests_total{version=...}``, so a
        client A/B split is attributable to the exact manifest seq that
        served it. ``None`` (no rollout attached / launch weights) counts
        under the "unset" label."""
        label = "unset" if version is None else str(version)
        with self._lock:
            key = f"requests_v{label}"
            self._c[key] = self._c.get(key, 0) + n
        self._registry().inc_counter("serving.requests_total", n,
                                     labels={"version": label})

    def observe_latency(self, seconds, priority=None, trace_id=None):
        with self._lock:
            if len(self._lat) >= _RESERVOIR:
                # overwrite round-robin: keeps a sliding window, O(1)
                self._lat[self._c.get("completed", 0) % _RESERVOIR] = \
                    float(seconds)
            else:
                self._lat.append(float(seconds))
        # trace_id becomes the bucket's exemplar: the histogram's p99
        # bucket names a real retained trace to go look at
        self._registry().observe("serving.request_latency_ms",
                                 float(seconds) * 1e3, exemplar=trace_id)
        if priority is not None:
            # per-priority-class histogram (own series: the registry's
            # histograms are unlabeled) so class SLOs burn independently
            self._registry().observe(
                f"serving.request_p{int(priority)}_latency_ms",
                float(seconds) * 1e3, exemplar=trace_id)

    # -- SLO burn-rate accounting ---------------------------------------------
    def add_slo(self, slo):
        """Register an :class:`SLO`; its burn rates are recomputed and
        exported as gauges on every :meth:`slo_tick`."""
        with self._lock:
            self._slos.append(slo)
        self._registry().set_gauge("slo.target_ms", slo.target_ms,
                                   labels={"slo": slo.name})
        return slo

    def slos(self):
        with self._lock:
            return list(self._slos)

    def slo_tick(self, now=None, min_interval=1.0):
        """Sample every SLO's cumulative counts and export burn rates as
        ``slo.burn_rate_ratio{slo=...,window=...}`` gauges. Rate-limited —
        cheap enough for the server's pump loop to call every round."""
        now = self._now() if now is None else now
        with self._lock:
            if self._slo_last is not None \
                    and now - self._slo_last < min_interval:
                return False
            self._slo_last = now
            slos = list(self._slos)
        registry = self._registry()
        for slo in slos:
            slo.sample(now, registry)
            for w, rate in slo.burn_rates(now).items():
                registry.set_gauge(
                    "slo.burn_rate_ratio", rate,
                    labels={"slo": slo.name, "window": f"{int(w)}s"})
        return True

    def slo_report(self, now=None):
        """{slo name: {window_s: burn rate}} without exporting (tests,
        ``stats()``)."""
        now = self._now() if now is None else now
        return {s.name: s.burn_rates(now) for s in self.slos()}

    def register_gauge(self, name, fn):
        self._gauges[name] = fn
        # pull-style: evaluated at metrics-export/snapshot time
        self._registry().register_gauge_fn(f"serving.{name}_count", fn)

    # -- reading ---------------------------------------------------------------
    def get(self, name):
        with self._lock:
            return self._c.get(name, 0)

    def latency_percentiles(self):
        with self._lock:
            lat = list(self._lat)
        return {"p50": percentile(lat, 50), "p99": percentile(lat, 99)}

    def batch_occupancy(self):
        """Real rows / total bucket rows over all dispatched batches —
        1.0 means every bucket slot carried a real request row."""
        with self._lock:
            real = self._c.get("rows", 0)
            pad = self._c.get("padded_rows", 0)
        total = real + pad
        return real / total if total else 0.0

    def snapshot(self):
        with self._lock:
            out = dict(self._c)
            lat = list(self._lat)
        out["latency_p50"] = percentile(lat, 50)
        out["latency_p99"] = percentile(lat, 99)
        total = out["rows"] + out["padded_rows"]
        out["batch_occupancy"] = out["rows"] / total if total else 0.0
        for name, fn in self._gauges.items():
            try:
                out[name] = fn()
            except Exception:
                out[name] = None
        return out
