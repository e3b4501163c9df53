"""Elastic replica autoscaling: queue-driven, journaled, generation-fenced
(port of paddle_tpu/serving/autoscaler.py).

A server's replica count is fixed at construction; this controller scales
it up and down from queue depth, so that resizes are safe under load:

- **signal**: queue depth per healthy replica (plus "no healthy replica at
  all", which always wants a scale-up). Sustained pressure over
  ``high_watermark`` for ``up_stable`` consecutive ticks scales up;
  sustained slack under ``low_watermark`` for ``down_stable`` ticks scales
  down. Streaks reset on any tick that breaks them, so a single spike
  never resizes anything.
- **safe scale-up**: :meth:`Scheduler.add_replica` builds the predictor,
  runs the preflight KAT, and re-warms every recorded warmup signature
  *before* the replica enters the dispatch set — new capacity never pays
  its bucket compiles on live traffic and a sick host never joins.
- **safe scale-down**: placement stops first (``begin_drain``), the
  replica's in-flight batches finish (or a bounded ``drain_timeout``
  force-removes it), and only then is it torn down. A **force-removed**
  replica is fenced: its late batch result is dropped by the scheduler,
  never delivered (:class:`~.scheduler.ReplicaRetired`).
- **journal + fencing**: every resize is recorded RecoveryJournal-style
  (``serving_scale_up`` / ``serving_scale_down`` / ``serving_scale_failed``
  events in ``recovery_journal_<job>.jsonl``) carrying the scheduler's
  monotonic ``scheduler_generation``, which bumps on every membership
  change — the same fencing discipline elastic training's recovery uses.

``scale_up``/``scale_down`` carry the ``serving.scale`` fault-injection
site: an injected failure is journaled and retried on a later tick, never
raised into the serving loop. Everything runs on the injectable clock.
On the card a scale-up captures the new replica's graphs (one per bucket)
inside ``add_replica``, on the thread that ticks the controller: in
threaded mode the serving thread, so batches wait out the build.

Two signal sources share the one controller:

- **queue mode** (the original): attached to a server, watermarks are
  queue depth per healthy replica;
- **fleet mode** (disaggregated serving): attached to a replica-class
  *fleet* (``count()`` / ``grow()`` / ``shrink()`` protocol) with an
  :class:`~.metrics.SLO`, watermarks are that class's **burn rate** — the
  prefill fleet grows on TTFT burn, the decode fleet on TPOT burn, each
  blind to the other's signal (serving/disagg.py).
"""
from __future__ import annotations

import threading

from ..resilience.faults import maybe_inject
from ..resilience.recovery import RecoveryJournal

__all__ = ["AutoscalerConfig", "Autoscaler"]


class AutoscalerConfig:
    """Controller knobs. Watermarks are queue depth *per healthy replica*;
    stability counts are consecutive ticks, so the reaction time is
    ``ticks × tick interval`` regardless of clock source."""

    def __init__(self, min_replicas=1, max_replicas=4, high_watermark=8.0,
                 low_watermark=1.0, up_stable=2, down_stable=4,
                 drain_timeout=60.0):
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min <= max replicas: "
                f"{self.min_replicas}..{self.max_replicas}")
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.up_stable = int(up_stable)
        self.down_stable = int(down_stable)
        self.drain_timeout = float(drain_timeout)


class Autoscaler:
    """Drives one server's replica set between ``min`` and ``max``.

    Attach with ``server.attach_autoscaler(...)``; the server's pump loop
    (and threaded loop) calls :meth:`tick` once per batching round. Tests
    call ``tick`` directly with a fake clock.
    """

    def __init__(self, server=None, config=None, journal=None, clock=None,
                 job_id="serving-autoscale", fleet=None, slo=None,
                 burn_window=None, metrics=None, name="serving"):
        if (server is None) == (fleet is None):
            raise ValueError("exactly one of server= (queue mode) or "
                             "fleet= (burn-rate mode) must be given")
        self.server = server
        self.scheduler = server.scheduler if server is not None else \
            getattr(fleet, "scheduler", None)
        self.config = config or AutoscalerConfig()
        self._fleet = fleet
        self._slo = slo
        self._burn_window = burn_window
        self.name = name
        self._clock = clock if clock is not None else \
            (server._clock if server is not None else None)
        self.journal = journal or RecoveryJournal(job_id=job_id,
                                                  clock=self._clock)
        self._metrics = server.metrics if server is not None else metrics
        # streaks/drains are read by describe() from other threads (the
        # stats endpoint) while tick() mutates them on the pump thread —
        # one lock serializes both (RLock: scale_down runs under tick)
        self._lock = threading.RLock()
        self._up_streak = 0     # guarded-by: _lock
        self._down_streak = 0   # guarded-by: _lock
        self._draining = {}     # guarded-by: _lock (replica idx -> t0)

    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.monotonic()

    # -- controller --------------------------------------------------------
    def replica_count(self):
        """Replicas that count toward capacity: healthy and not draining
        (queue mode) or the fleet's own count (burn-rate mode)."""
        if self._fleet is not None:
            return self._fleet.count()
        return len([r for r in self.scheduler.replicas
                    if r.healthy and not r.draining])

    def _signal(self, now):
        """The pressure signal the watermarks are compared against: queue
        depth per healthy replica, or the attached SLO's burn rate."""
        if self._fleet is not None:
            if self._slo is None:
                return 0.0
            return self._slo.burn(window=self._burn_window, now=now)
        depth = self.server.queue.depth()
        n = self.replica_count()
        return depth / n if n else float("inf")

    def tick(self, now=None):
        """One control round. Returns a dict describing any action taken
        (for tests and the bench tool); never raises — a failed resize is
        journaled and retried on a later tick."""
        now = self._now() if now is None else now
        with self._lock:
            action = {"scaled_up": False, "scaled_down": False,
                      "removed": []}
            action["removed"] = self._finish_drains(now)
            if self.server is not None and \
                    getattr(self.server, "rollout_active", lambda: False)():
                # a rollout/rollback is converging the fleet: hold resizes
                # so the roll's capacity math (and which replica scale_down
                # would pick — highest idx = the just-added new-version
                # one) can't fight the controller. Streaks reset: demand
                # evidence from during the roll is polluted by the extra
                # canary capacity.
                self._up_streak = 0
                self._down_streak = 0
                action["held_for_rollout"] = True
                return action
            signal = self._signal(now)
            action["signal"] = signal
            n = self.replica_count()
            if signal > self.config.high_watermark:
                self._up_streak += 1
                self._down_streak = 0
            elif signal <= self.config.low_watermark:
                self._down_streak += 1
                self._up_streak = 0
            else:
                self._up_streak = 0
                self._down_streak = 0
            if self._up_streak >= self.config.up_stable and \
                    n < self.config.max_replicas:
                action["scaled_up"] = self._try(self.scale_up, now)
                self._up_streak = 0
            elif self._down_streak >= self.config.down_stable and \
                    n > self.config.min_replicas and not self._draining:
                action["scaled_down"] = self._try(self.scale_down, now)
                self._down_streak = 0
            return action

    def _generation(self):
        return self.scheduler.generation if self.scheduler is not None else 0

    def _try(self, op, now):
        try:
            op(now)
            return True
        except Exception as e:
            # capacity changes are best-effort: journal and retry later
            self.journal.record("serving_scale_failed", op=op.__name__,
                                error=repr(e), fleet=self.name,
                                scheduler_generation=self._generation())
            if self._metrics:
                self._metrics.inc("scale_failures")
            return False

    # -- resize operations -------------------------------------------------
    def scale_up(self, now=None):
        """Warm + preflight a new replica, then admit it to dispatch
        (queue mode); grow the fleet by one (burn-rate mode)."""
        maybe_inject("serving.scale", RuntimeError)
        now = self._now() if now is None else now
        idx = self._fleet.grow() if self._fleet is not None \
            else self.scheduler.add_replica()
        if self._metrics:
            self._metrics.inc("scale_ups")
        self.journal.record("serving_scale_up", replica=idx,
                            replicas=self.replica_count(), fleet=self.name,
                            scheduler_generation=self._generation())
        return idx

    def scale_down(self, now=None):
        """Begin draining the highest-index eligible replica: placement
        stops now; teardown happens in :meth:`_finish_drains` once its
        in-flight work completes (or ``drain_timeout`` force-fences it).
        Burn-rate mode delegates to the fleet's own ``shrink`` (which may
        decline by returning None — e.g. every member still holds work)."""
        maybe_inject("serving.scale", RuntimeError)
        now = self._now() if now is None else now
        with self._lock:
            if self._fleet is not None:
                if self._fleet.count() <= self.config.min_replicas:
                    return None
                idx = self._fleet.shrink()
                if idx is None:
                    return None
                if self._metrics:
                    self._metrics.inc("scale_downs")
                self.journal.record(
                    "serving_scale_down", replica=idx, forced=False,
                    replicas=self.replica_count(), fleet=self.name,
                    scheduler_generation=self._generation())
                return idx
            victims = [r for r in self.scheduler.replicas
                       if r.healthy and not r.draining]
            if len(victims) <= self.config.min_replicas:
                return None
            victim = max(victims, key=lambda r: r.idx)
            self.scheduler.begin_drain(victim.idx)
            self._draining[victim.idx] = now
            self.journal.record(
                "serving_scale_down_begin", replica=victim.idx,
                scheduler_generation=self._generation())
            return victim.idx

    def _finish_drains(self, now):  # requires-lock: _lock
        """Tear down drained replicas whose in-flight count reached zero;
        force-remove (and fence) any that exceeded ``drain_timeout``."""
        removed = []
        for idx, started in list(self._draining.items()):
            rep = self.scheduler.find_replica(idx)
            if rep is None:                  # already gone (e.g. died)
                del self._draining[idx]
                continue
            forced = now - started > self.config.drain_timeout
            if rep.inflight > 0 and not forced:
                continue
            self.scheduler.remove_replica(idx, force=forced)
            del self._draining[idx]
            removed.append(idx)
            if self._metrics:
                self._metrics.inc("scale_downs")
            self.journal.record(
                "serving_scale_down", replica=idx, forced=forced,
                replicas=self.replica_count(),
                scheduler_generation=self._generation())
        return removed

    def describe(self):
        with self._lock:
            return {"replicas": self.replica_count(),
                    "min": self.config.min_replicas,
                    "max": self.config.max_replicas,
                    "fleet": self.name,
                    "draining": sorted(self._draining),
                    "up_streak": self._up_streak,
                    "down_streak": self._down_streak,
                    "scheduler_generation": self._generation()}
