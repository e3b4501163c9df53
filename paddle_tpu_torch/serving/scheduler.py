"""Multi-replica dispatch: placement, circuit breakers, hedging, elasticity
(port of paddle_tpu/serving/scheduler.py).

ORCA-style separation: the batcher decides *what* runs (which requests, what
bucket); the scheduler decides *where* (which `PredictorPool` replica) and
survives replicas dying, hanging, or resizing mid-batch. Each replica wraps
one predictor in a :class:`~.batcher.BucketedExecutor`, so the
bounded-compile guarantee holds per replica and warmup pre-compiles every
configured bucket on every replica — including replicas restarted after a
death and replicas added by the autoscaler — before they take traffic.

Failure semantics:

- a replica that raises :class:`ReplicaDead` (or any ConnectionError-shaped
  transport death — fault injection uses both) is marked unhealthy, drained
  (its in-flight count must reach zero before restart), and **restarted** by
  building a fresh predictor from the factory, re-preflighted AND re-warmed
  (every recorded warmup signature) before re-entering dispatch. The server
  keeps serving on the surviving replicas meanwhile; only when *no* replica
  is placeable does dispatch shed with :class:`~.batcher.ServerOverloaded`.
- every dispatch runs inside a resilience ``watch_section`` deadlined by
  ``FLAGS_serving_step_timeout``, so a hung device execution (or an injected
  hang) surfaces as a diagnostic ``DistributedTimeout`` with a flight-
  recorder dump instead of wedging the batching loop forever.
- every failure/timeout also feeds the replica's
  :class:`~.overload.CircuitBreaker`: K failures inside the rolling window
  open the breaker and the replica stops receiving batches (a timeouting
  replica stays ``healthy=True``, so health alone would keep it). After the
  cooldown, :meth:`maintain` runs the half-open gate — the preflight KAT
  plus one **canary batch** — and only a pass closes the breaker.
- **hedged dispatch**: when the exec-latency histogram has enough samples,
  the primary attempt is deadlined at a p99-derived hedge delay instead of
  the full step timeout; if it blows that window (and the hedge budget —
  ``FLAGS_serving_hedge_budget``, ~5% of dispatches — allows), the batch is
  re-placed on a second replica with the remaining budget. First completed
  attempt wins: the abandoned primary's late result is fenced by
  ``watch_section``'s post-deadline rule and never delivered.
- **elastic membership**: :meth:`add_replica` / :meth:`begin_drain` /
  :meth:`remove_replica` resize the replica set under a monotonic
  ``generation`` counter. A replica force-removed while a batch was still
  in flight is *fenced* (``fenced_out``): its result is dropped with
  :class:`ReplicaRetired` — counted, retried elsewhere, never delivered.

``dispatch`` carries the ``serving.dispatch`` / ``serving.replica_run``
fault-injection sites; ``_hedge_site`` carries ``serving.hedge`` (an
injected hang at the hedge boundary, forcing the re-place path). Clock and
watchdog are injectable: the chaos suite drives the whole matrix with a
fake clock and zero real sleeps.
"""
from __future__ import annotations

import threading

import numpy as np

from ..resilience.faults import maybe_inject
from ..resilience.watchdog import DistributedTimeout, Watchdog
from ..resilience.watchdog import watch_section as _watch_section
from ..framework.errors import PreconditionNotMetError
from .batcher import BucketedExecutor, ServerOverloaded
from .overload import CircuitBreaker

__all__ = ["ReplicaDead", "ReplicaRetired", "Replica", "Scheduler"]


class ReplicaDead(ConnectionError):
    """A replica's predictor failed in a way that poisons the replica (device
    lost, runtime crash) rather than the single batch."""


class ReplicaRetired(ReplicaDead):
    """A batch's result arrived from a replica that was removed from the
    membership while the batch ran (forced drain / scale-down). The result
    is fenced — dropped, never delivered — and the caller may retry the
    batch on a current member. Subclasses :class:`ReplicaDead` so the
    server's existing retry path applies."""


def _flag(name, default):
    from ..framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


class Replica:
    """One predictor worker: health + load + breaker state around an
    executor. ``draining`` excludes it from placement while in-flight work
    finishes; ``fenced_out`` marks it removed from membership — any result
    it still produces must be dropped."""

    __slots__ = ("idx", "executor", "healthy", "inflight", "completed",
                 "failures", "restarts", "last_error", "breaker",
                 "draining", "fenced_out", "version")

    def __init__(self, idx, predictor, max_cached=32, breaker=None,
                 version=None):
        self.idx = idx
        self.executor = BucketedExecutor(predictor, max_cached=max_cached)
        self.healthy = True
        self.inflight = 0
        self.completed = 0
        self.failures = 0
        self.restarts = 0
        self.last_error = None
        self.breaker = breaker or CircuitBreaker()
        self.draining = False
        self.fenced_out = False
        # model version this replica's predictor was built from (the
        # rollout controller's manifest seq; None = launch weights).
        # Stamped into every reply the replica produces.
        self.version = version

    @property
    def compile_count(self):
        return self.executor.compile_count

    def placeable(self):
        return self.healthy and not self.draining and not self.fenced_out \
            and self.breaker.allows()

    def describe(self):
        return {"replica": self.idx, "healthy": self.healthy,
                "inflight": self.inflight, "completed": self.completed,
                "failures": self.failures, "restarts": self.restarts,
                "compiles": self.executor.compile_count,
                "breaker": self.breaker.describe(),
                "draining": self.draining,
                "version": self.version,
                "last_error": (str(self.last_error)
                               if self.last_error else None)}


class Scheduler:
    """Places batches on the least-loaded placeable replica.

    ``predictor_factory(idx)`` builds (and rebuilds, on restart or
    scale-up) the predictor for replica ``idx`` — for a real server that is
    ``PredictorPool.retrieve`` / ``Predictor.clone``; chaos tests pass fakes.
    """

    def __init__(self, predictor_factory, size, clock=None, watchdog=None,
                 step_timeout=None, metrics=None, max_cached=32,
                 preflight=None, breaker_factory=None, hedge_budget=None,
                 exec_registry=None):
        if size < 1:
            raise ValueError(f"scheduler needs size >= 1 replicas: {size}")
        self._factory = predictor_factory
        self._clock = clock
        self._metrics = metrics
        self._max_cached = max_cached
        self._step_timeout = step_timeout
        # health gate for restarted replicas (default: the hardware KAT,
        # health.serving_preflight); a replica whose host died once must
        # prove the device computes right before re-entering dispatch
        self._preflight = preflight
        self._breaker_factory = breaker_factory or CircuitBreaker
        self._hedge_budget = hedge_budget
        # hedge-delay histogram: a PER-SERVER profiler.MetricsRegistry (the
        # server observes each batch's exec latency into it), NOT the
        # process-global one — a fresh server must not inherit another
        # server's latency history into its hedging policy
        if exec_registry is None:
            from ..profiler.metrics import MetricsRegistry
            exec_registry = MetricsRegistry()
        self._exec_registry = exec_registry
        self._lock = threading.Lock()
        # a fake clock means deterministic tests: never spawn a monitor
        # thread; expiry is driven by Watchdog.poll (watchdog.py contract)
        self._wd = watchdog or (Watchdog(clock=clock) if clock is not None
                                else None)
        # monotonic membership generation: bumped on every add/remove so
        # resizes are fenced the way recovery fences a re-rendezvous
        self.generation = 1   # guarded-by: _lock
        self._next_idx = size  # guarded-by: _lock
        # warmup signatures seen so far — replayed on restart / scale-up so
        # a (re)joining replica never pays bucket compiles on live traffic
        self._warmup = []  # guarded-by: _lock
        # round-robin cursor: breaks (inflight, ...) ties so equal-load
        # traffic rotates instead of pinning to low indices
        self._rr = 0  # guarded-by: _lock
        # hedge accounting: budget = hedges / dispatches
        self._dispatches = 0  # guarded-by: _lock
        self._hedges = 0      # guarded-by: _lock
        # current-version loader (set by the rollout controller): when set,
        # restart_dead and default add_replica builds go through it instead
        # of the launch-time factory, so a replica rebuilt mid- or
        # post-rollout never resurrects stale weights
        self._current_factory = None  # guarded-by: _lock
        self._current_version = None  # guarded-by: _lock
        self.replicas = [Replica(i, predictor_factory(i),
                                 max_cached=max_cached,
                                 breaker=self._breaker_factory())
                         for i in range(size)]  # guarded-by: _lock

    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.monotonic()

    # -- placement -------------------------------------------------------------
    def healthy_replicas(self):
        with self._lock:
            return [r for r in self.replicas if r.placeable()]

    def find_replica(self, idx):
        with self._lock:
            for r in self.replicas:
                if r.idx == idx:
                    return r
        return None

    def pick(self, exclude=()):
        """Least-loaded placeable replica, skipping ``exclude`` (replicas a
        retried batch already died on). Ties on load rotate round-robin so
        idle capacity is used evenly rather than pinning to low indices."""
        with self._lock:
            avail = [r for r in self.replicas
                     if r.placeable() and r.idx not in exclude]
            if not avail:
                any_healthy = any(r.healthy for r in self.replicas)
                open_breakers = sum(1 for r in self.replicas
                                    if r.healthy and not r.breaker.allows())
                if self._metrics:
                    self._metrics.inc("shed", reason="unhealthy")
                detail = "" if any_healthy else \
                    " (all replicas dead; restart pending)"
                if open_breakers:
                    detail += f" ({open_breakers} breaker(s) open)"
                raise ServerOverloaded(
                    "no healthy replica available" + detail)
            self._rr += 1
            rr = self._rr
            n = len(avail)
            best = min(enumerate(avail),
                       key=lambda p: (p[1].inflight, (p[0] - rr) % n))
            return best[1]

    def step_timeout(self):
        if self._step_timeout is not None:
            return self._step_timeout
        return float(_flag("FLAGS_serving_step_timeout", 60.0))

    # -- versioned builds ------------------------------------------------------
    def set_version_loader(self, factory, version):
        """Route every future replica build (``restart_dead``, default
        ``add_replica``, autoscaler scale-ups) through ``factory``,
        stamping the result with ``version``. The rollout controller sets
        this when a version is proven (canary pass) or restored
        (rollback), fixing the restart-resurrects-launch-weights bug."""
        with self._lock:
            self._current_factory = factory
            self._current_version = version

    def current_version(self):
        with self._lock:
            return self._current_version

    def _build_factory(self):
        """(factory, version) a rebuilt replica should use: the current
        version loader when set, else the launch factory (version None)."""
        with self._lock:
            if self._current_factory is not None:
                return self._current_factory, self._current_version
            return self._factory, None

    def stamp_versions(self, version, only_unversioned=True):
        """Label live replicas with a model version (rollout resume: a
        restarted server's launch-built replicas adopt the incumbent
        version recorded in the journal)."""
        with self._lock:
            for r in self.replicas:
                if not only_unversioned or r.version is None:
                    r.version = version

    # -- hedging ---------------------------------------------------------------
    def hedge_budget(self):
        if self._hedge_budget is not None:
            return float(self._hedge_budget)
        return float(_flag("FLAGS_serving_hedge_budget", 0.05))

    def hedge_delay(self):
        """p99-derived primary deadline, or None when hedging is off: budget
        exhausted, fewer than two placeable replicas, or not enough latency
        samples in the always-on ``serving.batch_exec_ms`` histogram yet."""
        budget = self.hedge_budget()
        if budget <= 0 or len(self.healthy_replicas()) < 2:
            return None
        with self._lock:
            if self._hedges + 1 > budget * max(self._dispatches, 20):
                return None
        summary = self._exec_registry.histogram_summary(
            "serving.batch_exec_ms")
        if not summary or summary["count"] < 16:
            return None
        delay = max(summary["p99"] / 1e3,
                    float(_flag("FLAGS_serving_hedge_min_ms", 10.0)) / 1e3)
        if delay >= self.step_timeout():
            return None
        return delay

    def note_exec_latency(self, elapsed_s):
        """Feed one batch's execution latency into the per-server histogram
        the hedge delay is derived from."""
        self._exec_registry.observe("serving.batch_exec_ms",
                                    elapsed_s * 1e3)

    def _hedge_site(self):
        # the serving.hedge chaos site: an injected hang exactly at the
        # hedge boundary — the primary attempt times out at its hedge-delay
        # deadline and the batch is re-placed on a second replica
        maybe_inject("serving.hedge", TimeoutError)

    # -- dispatch --------------------------------------------------------------
    def dispatch(self, batch):   # hot-path: every serving batch funnels through here
        """Run one batch on a replica (hedging to a second one when the
        primary blows its p99-derived window). Raises:

        - :class:`ReplicaDead` — the replica died; it has been marked
          unhealthy and queued for restart, the caller may retry elsewhere;
        - :class:`ReplicaRetired` — the replica was removed from membership
          mid-batch; the fenced result was dropped, the caller may retry;
        - ``DistributedTimeout`` — the per-batch watchdog section expired
          (diagnostics already dumped, breaker fed);
        - :class:`ServerOverloaded` — no replica to place on.
        """
        hedge_delay = self.hedge_delay()
        with self._lock:
            self._dispatches += 1
        deadline = self._now() + self.step_timeout()
        primary_timeout = hedge_delay if hedge_delay is not None \
            else self.step_timeout()
        try:
            return self._attempt(batch, primary_timeout, hedged=False)
        except DistributedTimeout:
            if hedge_delay is None:
                raise
            # primary is still running past the hedge window: re-place on a
            # second replica with the remaining step budget. First result
            # wins — the primary's late result is already fenced by the
            # watch_section post-deadline rule.
            with self._lock:
                self._hedges += 1
            if self._metrics:
                self._metrics.inc("hedges")
            remaining = max(deadline - self._now(), 1e-3)
            outputs, rep = self._attempt(batch, remaining, hedged=True)
            if self._metrics:
                self._metrics.inc("hedge_wins")
            return outputs, rep

    def _attempt(self, batch, timeout, hedged):   # hot-path: single placement attempt under the watchdog
        rep = self.pick(exclude=batch.tried_replicas)
        batch.tried_replicas.add(rep.idx)
        # tracing stash: two clock floats + one small dict; the server turns
        # this into retroactive spans outside the hot path
        info = {"replica": rep.idx, "hedged": hedged, "version": rep.version,
                "t0": self._now(), "t1": None}
        batch.dispatch_info = info
        with self._lock:
            rep.inflight += 1
        try:
            with _watch_section(f"serving.batch#{batch.id}"
                                + (".hedge" if hedged else ""),
                                timeout=timeout, watchdog=self._wd):
                # inside the watched section: an injected TimeoutError here
                # is exactly a hung dispatch — watch_section turns it into a
                # diagnostic DistributedTimeout with a flight-recorder dump
                maybe_inject("serving.dispatch", TimeoutError)
                maybe_inject("serving.replica_run", ReplicaDead)
                if not hedged:
                    self._hedge_site()
                outputs = rep.executor.run(batch.arrays)
        except DistributedTimeout:
            self._note_failure(rep)
            raise
        except (ReplicaDead, ConnectionError) as e:
            self._note_failure(rep, count_in_failures=False)
            self._mark_dead(rep, e)
            raise ReplicaDead(
                f"replica {rep.idx} died running batch#{batch.id}: "
                f"{e}") from e
        finally:
            info["t1"] = self._now()
            with self._lock:
                rep.inflight -= 1
        if rep.fenced_out:
            # the replica was force-removed while this batch ran: its
            # result belongs to a dead membership generation — drop it
            if self._metrics:
                self._metrics.inc("late_drops")
            with self._lock:
                gen = self.generation
            raise ReplicaRetired(
                f"replica {rep.idx} was removed (generation "
                f"{gen}) while batch#{batch.id} ran; "
                "late result dropped, not delivered")
        rep.breaker.record_success(self._now())
        with self._lock:
            rep.completed += 1
        return outputs, rep

    # -- health ----------------------------------------------------------------
    def _note_failure(self, rep, count_in_failures=True):
        """Feed the breaker (and the failure counter) for one bad attempt.
        K failures/timeouts in the rolling window open the breaker — the
        replica stops receiving batches until maintain()'s half-open gate
        (preflight + canary) passes."""
        now = self._now()
        opened = rep.breaker.record_failure(now)
        with self._lock:
            if count_in_failures:
                rep.failures += 1
        if opened and self._metrics:
            self._metrics.inc("breaker_opens")

    def _mark_dead(self, rep, exc):
        with self._lock:
            if rep.healthy:
                rep.healthy = False
                rep.failures += 1
                rep.last_error = exc
                if self._metrics:
                    self._metrics.inc("replica_deaths")

    def mark_dead(self, idx, exc):
        """Public death notice for work the scheduler didn't dispatch
        itself (the disagg controller's prefill handoffs run outside
        :meth:`dispatch`): the replica leaves placement now, its breaker
        is fed, and :meth:`restart_dead` rebuilds it once its in-flight
        work unwinds. Returns the replica, or None when already removed."""
        rep = self.find_replica(idx)
        if rep is not None:
            self._note_failure(rep, count_in_failures=False)
            self._mark_dead(rep, exc)
        return rep

    def maintain(self):
        """One housekeeping round for the serving loop: restart dead
        replicas and probe open breakers whose cooldown elapsed. Returns
        the indices restarted (restart_dead's contract)."""
        restarted = self.restart_dead()
        self._probe_breakers()
        return restarted

    def restart_dead(self):
        """Drain-and-restart every dead replica whose in-flight work has
        finished. Called from the server loop (and directly by tests);
        returns the replica indices restarted. A factory failure leaves the
        replica dead for the next attempt rather than raising into the
        serving loop."""
        restarted = []
        with self._lock:
            dead = [r for r in self.replicas
                    if not r.healthy and r.inflight == 0]
        for rep in dead:
            # rebuild through the CURRENT version loader, not the launch
            # factory: a replica restarted mid-rollout must come back with
            # the weights the fleet is converging to, correctly stamped
            factory, version = self._build_factory()
            try:
                predictor = factory(rep.idx)
            except Exception as e:  # keep serving on survivors
                with self._lock:
                    rep.last_error = e
                continue
            try:
                self._run_preflight(predictor)
            except Exception as e:
                # the host that killed this replica may be sick, not just
                # unlucky: until it passes the KAT it stays out of dispatch
                # (next restart_dead retries) instead of serving wrong
                # answers from flaky silicon
                with self._lock:
                    rep.last_error = e
                    if self._metrics:
                        self._metrics.inc("preflight_failures")
                continue
            executor = BucketedExecutor(predictor,
                                        max_cached=self._max_cached)
            # re-warm before re-entering dispatch: a restarted replica must
            # not pay every bucket compile on live traffic
            for sig, buckets in self._warmup_list():
                executor.warmup(sig, buckets)
            with self._lock:
                rep.executor = executor
                rep.healthy = True
                rep.restarts += 1
                rep.version = version
                rep.breaker = self._breaker_factory()
                if self._metrics:
                    self._metrics.inc("replica_restarts")
            restarted.append(rep.idx)
        return restarted

    def _probe_breakers(self):
        """Half-open re-entry gate: for each open breaker past its
        cooldown, run the preflight KAT plus one canary batch through the
        replica. Pass → breaker closes, replica re-enters placement; fail →
        breaker re-opens for another cooldown."""
        now = self._now()
        closed = []
        with self._lock:
            candidates = [r for r in self.replicas
                          if r.healthy and not r.fenced_out]
        for rep in candidates:
            if not rep.breaker.probe_due(now):
                continue
            try:
                self._run_preflight(rep.executor.predictor)
                self._canary(rep)
            except Exception as e:
                with self._lock:
                    rep.last_error = e
                rep.breaker.record_failure(self._now())
                continue
            rep.breaker.close(self._now())
            closed.append(rep.idx)
            if self._metrics:
                self._metrics.inc("breaker_closes")
        return closed

    def _canary(self, rep):
        """One real (smallest-bucket, zeros) batch through the replica
        inside a watched section — the breaker only closes if the replica
        can actually complete work, not just pass the KAT. With no warmup
        signature recorded yet there is nothing shape-safe to fabricate;
        the preflight KAT alone gates re-entry (documented)."""
        warm = self._warmup_list()
        if not warm:
            return
        sig, buckets = warm[0]
        arrays = [np.zeros((buckets[0],) + tuple(shape), dtype=dtype)
                  for shape, dtype in sig]
        with _watch_section(f"serving.canary.replica{rep.idx}",
                            timeout=self.step_timeout(), watchdog=self._wd):
            rep.executor.run(arrays)

    def _run_preflight(self, predictor):
        if self._preflight is not None:
            self._preflight(predictor)
            return
        from ..resilience.health import serving_preflight
        serving_preflight(predictor)

    # -- elastic membership ----------------------------------------------------
    def add_replica(self, factory=None, version=None):
        """Scale-up: build, preflight, and warm a new replica, then admit
        it to the dispatch set under a bumped generation. The replica never
        sees traffic before it is warm and proven. ``factory``/``version``
        default to the current version loader (autoscaler scale-ups join
        at the fleet's live version, never launch-time weights); the
        rollout controller passes them explicitly for canary/roll adds."""
        if factory is None:
            factory, version = self._build_factory()
        with self._lock:
            idx = self._next_idx
            self._next_idx += 1
        predictor = factory(idx)
        self._run_preflight(predictor)
        rep = Replica(idx, predictor, max_cached=self._max_cached,
                      breaker=self._breaker_factory(), version=version)
        for sig, buckets in self._warmup_list():
            rep.executor.warmup(sig, buckets)
        with self._lock:
            self.replicas.append(rep)
            self.generation += 1
        return idx

    def begin_drain(self, idx):
        """Scale-down step 1: stop placement on the replica; in-flight
        batches keep running and their results ARE delivered."""
        rep = self.find_replica(idx)
        if rep is None:
            raise KeyError(f"no replica {idx}")
        with self._lock:
            rep.draining = True
        return rep

    def remove_replica(self, idx, force=False):
        """Scale-down step 2: take the replica out of membership and bump
        the generation. Refuses while work is in flight unless ``force`` —
        a forced removal fences the replica (``fenced_out``) so its late
        result is dropped by ``dispatch``, never delivered."""
        rep = self.find_replica(idx)
        if rep is None:
            return None
        with self._lock:
            if rep.inflight > 0 and not force:
                raise PreconditionNotMetError(
                    f"replica {idx} still has {rep.inflight} batch(es) in "
                    "flight; drain first or pass force=True")
            rep.fenced_out = True
            rep.healthy = False
            self.replicas = [r for r in self.replicas if r.idx != idx]
            self.generation += 1
        return rep

    # -- warmup ----------------------------------------------------------------
    def _warmup_list(self):
        with self._lock:
            return list(self._warmup)

    def warmup(self, signature, buckets):
        """Pre-compile every configured bucket on every replica so steady-
        state traffic never pays a compile. The (signature, buckets) pair
        is recorded and replayed onto restarted and scaled-up replicas.
        Returns total compiles done."""
        key = (tuple(signature), tuple(buckets))
        with self._lock:
            if key not in self._warmup:
                self._warmup.append(key)
        total = 0
        for rep in self.healthy_replicas():
            before = rep.executor.compile_count
            rep.executor.warmup(signature, buckets)
            total += rep.executor.compile_count - before
        return total

    def describe(self):
        with self._lock:
            reps = list(self.replicas)
        return [r.describe() for r in reps]

    def hedge_stats(self):
        with self._lock:
            return {"dispatches": self._dispatches, "hedges": self._hedges,
                    "budget": self.hedge_budget()}
