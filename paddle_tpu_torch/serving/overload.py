"""Overload control: AIMD adaptive admission + per-replica circuit breakers
(port of paddle_tpu/serving/overload.py).

A binary queue-full check alone accepts work at full rate until the
bounded queue overflows, which under sustained overload
means every admitted request ages toward its deadline in a long queue and
goodput collapses to zero even though throughput looks busy. This module
gives the serving tier the two classic overload-control primitives:

- :class:`AdmissionController` — a TCP-style **AIMD concurrency limiter**.
  The limit is a number of requests allowed *in the system* (queued +
  executing). Every completed batch reports its worst request **sojourn**
  (queue wait + execution — pure execution time is blind to queueing); at
  or under the target the limit creeps up additively (+1 per limit's worth
  of batches), over the target it is cut multiplicatively (×0.7, at most
  once per target interval, so one slow burst doesn't collapse it to the
  floor).
  Requests carry a **priority class** (0 = highest); lower classes see only
  a fraction of the limit, so as load rises the lowest class is shed first
  — the "shed lowest first" order. A shed raises
  :class:`~.batcher.ServerOverloaded` carrying a ``retry_after`` hint that
  rides the wire codec back to the reference's ``InferenceClient``.

- :class:`CircuitBreaker` — closed → open after K failures/timeouts inside a
  rolling window, so a replica that keeps hitting ``DistributedTimeout``
  stops receiving traffic even though it is still ``healthy=True``.
  An open breaker takes the replica out of placement; after a cooldown it
  goes **half-open**, and re-entry is gated by the scheduler on the
  preflight KAT plus one canary batch (:meth:`Scheduler.maintain`) — live
  traffic never probes a suspect replica.

Both are pure in-memory state machines over an injectable clock: the chaos
suite drives the full open/half-open/close cycle and the AIMD trajectory
with a fake clock and zero real sleeps.
"""
from __future__ import annotations

import collections
import threading

from .batcher import ServerOverloaded

__all__ = ["AdmissionController", "BurnGate", "CircuitBreaker",
           "PRIORITY_HEADROOM"]


def _flag(name, default):
    from ..framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


# Fraction of the AIMD limit each priority class may fill. Class 0 (the
# default) uses the whole limit; lower classes hit their ceiling first and
# are therefore shed first as the limit shrinks under overload.
PRIORITY_HEADROOM = (1.0, 0.75, 0.5)


class AdmissionController:
    """AIMD limit on requests in the system (queued + executing).

    ``admit`` is called at ``InferenceServer.submit`` *before* the queue;
    it atomically checks the priority-scaled limit and counts the request
    in. ``note_done`` is called exactly once when the request terminates
    (result, error, or failed enqueue). ``observe`` feeds the control loop
    with per-batch latency (the server reports each replied batch's worst
    request sojourn, and the elapsed wall time of failed dispatches).
    """

    def __init__(self, target_ms=None, initial=None, min_limit=1,
                 max_limit=None, metrics=None, clock=None,
                 retry_after_base=None, decrease=0.7, headroom=None):
        self._target_ms = target_ms
        self.limit = float(initial if initial is not None
                           else (max_limit or 64))  # guarded-by: _lock
        self.min_limit = float(min_limit)
        self.max_limit = float(max_limit) if max_limit else self.limit
        self.limit = min(self.limit, self.max_limit)
        self._metrics = metrics
        self._clock = clock
        self._retry_after_base = retry_after_base
        self._decrease = float(decrease)
        self._headroom = tuple(headroom) if headroom else PRIORITY_HEADROOM
        self.inflight = 0  # guarded-by: _lock (admitted, not terminated)
        self.shed = 0      # guarded-by: _lock
        self._last_decrease = None  # guarded-by: _lock
        self._lock = threading.Lock()

    # -- config read per call so paddle.set_flags retunes a live server ----
    def target_s(self):
        t = self._target_ms if self._target_ms is not None else \
            float(_flag("FLAGS_serving_admission_target_ms", 100.0))
        return t / 1e3

    def retry_after_base(self):
        if self._retry_after_base is not None:
            return self._retry_after_base
        return float(_flag("FLAGS_serving_retry_after", 0.1))

    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.monotonic()

    def ceiling(self, priority):  # requires-lock: _lock
        """The priority class's share of the current limit."""
        p = max(0, min(int(priority), len(self._headroom) - 1))
        return self.limit * self._headroom[p]

    def retry_after(self, priority=0):
        """How long a shed client should wait before retrying: the base
        hint scaled by how far over the class ceiling the system is —
        deterministic, so tests (and dashboards) can reason about it."""
        with self._lock:
            ceil = max(self.ceiling(priority), 1.0)
            excess = max(0.0, self.inflight + 1 - ceil)
        return self.retry_after_base() * (1.0 + excess / ceil) \
            + self.target_s() * min(1.0, excess / ceil)

    # -- admission ---------------------------------------------------------
    def admit(self, priority=0, now=None):
        """Admit (count in) or shed. Raises :class:`ServerOverloaded` with
        ``retry_after`` set when the class is over its share of the limit."""
        with self._lock:
            ceil = self.ceiling(priority)
            if self.inflight + 1 > ceil:
                self.shed += 1
                in_system, limit = self.inflight, self.limit
                hint = self.retry_after_base() * (
                    1.0 + (self.inflight + 1 - ceil) / max(ceil, 1.0)) \
                    + self.target_s() * min(
                        1.0, (self.inflight + 1 - ceil) / max(ceil, 1.0))
            else:
                self.inflight += 1
                return
        if self._metrics:
            self._metrics.inc("shed", reason="admission")
        raise ServerOverloaded(
            f"admission limit reached for priority {priority} "
            f"({in_system} in system, class ceiling {ceil:.1f} of "
            f"limit {limit:.1f}); retry after {hint:.3f}s",
            retry_after=hint)

    def note_done(self):
        """One admitted request terminated (result, error, or the enqueue
        after admission failed)."""
        with self._lock:
            self.inflight = max(0, self.inflight - 1)

    # -- AIMD control loop -------------------------------------------------
    def observe(self, latency_s, now=None):
        """Feed one batch's execution latency. Additive increase at/under
        target; multiplicative decrease over target, rate-limited to once
        per target interval so one burst of queued slow batches counts as
        one congestion signal (the TCP analogy: one loss event per RTT)."""
        now = self._now() if now is None else now
        target = self.target_s()
        with self._lock:
            if latency_s <= target:
                self.limit = min(self.max_limit,
                                 self.limit + 1.0 / max(self.limit, 1.0))
            else:
                if self._last_decrease is None or \
                        now - self._last_decrease >= target:
                    self.limit = max(self.min_limit,
                                     self.limit * self._decrease)
                    self._last_decrease = now

    def snapshot(self):
        with self._lock:
            return {"limit": self.limit, "inflight": self.inflight,
                    "shed": self.shed, "target_ms": self.target_s() * 1e3}


class BurnGate:
    """Stage admission priced on an SLO burn rate (disaggregated serving).

    The AIMD controller prices *total* concurrency; a disaggregated
    deployment additionally needs **per-stage** pricing — prefill admission
    on the TTFT burn rate, decode-side adoption on the TPOT burn rate
    (both :class:`~.metrics.SLO` objects) — so one stage's pain
    refuses new work for *that stage only* instead of collapsing the whole
    pipeline. The gate refuses (typed :class:`ServerOverloaded`, with a
    ``retry_after`` scaled by how hot the burn is) when the SLO's
    fast-window burn exceeds ``high`` × the priority class's headroom:
    class 0 sees the full threshold, lower classes are refused earlier —
    the same shed order as the AIMD limiter.

    Purely read-side over the SLO's recorded samples — admitting holds no
    slot and needs no ``note_done``; refusal-rate accounting is the only
    state.
    """

    def __init__(self, slo, high=None, window=None, retry_after_base=None,
                 headroom=None, clock=None):
        self.slo = slo
        self._high = high
        self._window = window
        self._retry_after_base = retry_after_base
        self._headroom = tuple(headroom) if headroom else PRIORITY_HEADROOM
        self._clock = clock
        self.admitted = 0  # guarded-by: _lock
        self.shed = 0      # guarded-by: _lock
        self._lock = threading.Lock()

    # -- config read per call so paddle.set_flags retunes a live gate ------
    def high(self):
        return float(self._high if self._high is not None
                     else _flag("FLAGS_disagg_burn_high", 2.0))

    def window(self):
        return float(self._window if self._window is not None
                     else _flag("FLAGS_disagg_burn_window", 60.0))

    def retry_after_base(self):
        if self._retry_after_base is not None:
            return self._retry_after_base
        return float(_flag("FLAGS_serving_retry_after", 0.1))

    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.monotonic()

    def burn(self, now=None):
        """The gated SLO's burn rate over the gate's window."""
        return self.slo.burn(window=self.window(),
                             now=self._now() if now is None else now)

    # -- admission ---------------------------------------------------------
    def admit(self, priority=0, now=None):
        """Admit or refuse. Raises :class:`ServerOverloaded` with
        ``retry_after`` when the stage's error budget is burning faster
        than ``high`` × the class headroom."""
        burn = self.burn(now)
        p = max(0, min(int(priority), len(self._headroom) - 1))
        threshold = self.high() * self._headroom[p]
        if burn <= threshold:
            with self._lock:
                self.admitted += 1
            return
        with self._lock:
            self.shed += 1
        hint = self.retry_after_base() * min(
            8.0, burn / max(threshold, 1e-9))
        raise ServerOverloaded(
            f"{self.slo.name} error budget burning at {burn:.2f}x "
            f"(threshold {threshold:.2f} for priority {priority}); "
            f"retry after {hint:.3f}s", retry_after=hint)

    def snapshot(self):
        with self._lock:
            admitted, shed = self.admitted, self.shed
        return {"slo": self.slo.name, "admitted": admitted, "shed": shed,
                "burn": self.burn(), "high": self.high(),
                "window_s": self.window()}


class CircuitBreaker:
    """Closed → open after K failures in a rolling window; half-open after
    a cooldown; closed again only via :meth:`close` (the scheduler calls it
    after the preflight KAT + canary batch pass).

    States: ``closed`` (traffic flows), ``open`` (no placement), and
    ``half_open`` (no normal placement either — only the scheduler's probe
    touches the replica). A probe failure re-opens and restarts the
    cooldown.
    """

    __slots__ = ("_failures", "_window", "_cooldown", "_events", "state",
                 "opened_at", "opens", "_lock")

    def __init__(self, failures=None, window=None, cooldown=None):
        self._failures = failures
        self._window = window
        self._cooldown = cooldown
        self._events = collections.deque()  # guarded-by: _lock
        self.state = "closed"  # guarded-by: _lock
        self.opened_at = None  # guarded-by: _lock
        self.opens = 0         # guarded-by: _lock
        self._lock = threading.Lock()

    def max_failures(self):
        return int(self._failures if self._failures is not None
                   else _flag("FLAGS_serving_breaker_failures", 5))

    def window(self):
        return float(self._window if self._window is not None
                     else _flag("FLAGS_serving_breaker_window", 30.0))

    def cooldown(self):
        return float(self._cooldown if self._cooldown is not None
                     else _flag("FLAGS_serving_breaker_cooldown", 10.0))

    def _prune(self, now):  # requires-lock: _lock
        horizon = now - self.window()
        while self._events and self._events[0] < horizon:
            self._events.popleft()

    # -- transitions -------------------------------------------------------
    def record_failure(self, now):
        """One failure/timeout at ``now``. Returns True when this failure
        tripped the breaker open."""
        with self._lock:
            if self.state == "half_open":
                # the probe failed: straight back to open, fresh cooldown
                self.state = "open"
                self.opened_at = now
                self.opens += 1
                return True
            self._events.append(now)
            self._prune(now)
            if self.state == "closed" and \
                    len(self._events) >= self.max_failures():
                self.state = "open"
                self.opened_at = now
                self.opens += 1
                self._events.clear()
                return True
        return False

    def record_success(self, now):
        """A completed dispatch in the closed state ages out old failures
        (the rolling window already does; this just prunes eagerly)."""
        with self._lock:
            if self.state == "closed":
                self._prune(now)

    def probe_due(self, now):
        """Open + cooldown elapsed → move to half-open and tell the caller
        to run the preflight + canary gate. Idempotent per cooldown."""
        with self._lock:
            if self.state == "open" and self.opened_at is not None and \
                    now - self.opened_at >= self.cooldown():
                self.state = "half_open"
                return True
            return False

    def close(self, now=None):
        with self._lock:
            self.state = "closed"
            self.opened_at = None
            self._events.clear()

    def allows(self):
        """Normal placement allowed? (Half-open traffic goes through the
        scheduler's probe, never through ``pick``.)"""
        with self._lock:
            return self.state == "closed"

    def describe(self):
        with self._lock:
            return {"state": self.state, "opens": self.opens,
                    "recent_failures": len(self._events)}
