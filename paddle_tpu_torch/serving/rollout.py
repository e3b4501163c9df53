"""Live model rollout: zero-downtime weight hot-swap with canary gating
(port of paddle_tpu/serving/rollout.py).

Production systems retrain continuously; this controller closes the
train→serve loop without draining traffic, on top of pieces that already
exist — the digest-verified manifest checkpoints of ``resilience.snapshot``,
the scheduler's warm-first replica lifecycle with generation fencing, and
the preflight KAT:

- :class:`ManifestWatcher` polls the checkpoint root for a newer
  *committed* ``manifest-<seq>.json``, walking newest → oldest with the
  same digest verification the restore path uses. A torn manifest racing a
  commit is skipped (``rollout.skipped_torn_total``), never loaded, and
  picked up on a later poll once the atomic rename lands.
- :class:`RolloutController` is a resumable state machine
  ``IDLE → CANARY → ROLLING → COMPLETE/ROLLBACK`` driven by :meth:`tick`
  from the server's pump/threaded loop:

  * **CANARY** — the new version is loaded onto ONE replica through the
    scheduler's warm-first ``add_replica`` path (preflight KAT + re-warm
    of every recorded warmup signature before it takes traffic), then a
    quality gate runs the pinned golden requests through the canary and
    compares against the incumbent's captured outputs. Non-finite output
    or drift beyond ``golden_max_drift`` fails the gate.
  * **ROLLING** — replica-by-replica ``add_replica``/``begin_drain``
    while effective capacity holds (the autoscaler suspends resizes
    during an active roll); a new-version replica dying or tripping its
    breaker mid-roll triggers rollback.
  * **ROLLBACK** — the same roll in reverse from the still-retained
    prior manifest (the controller pins incumbent + prior via
    ``snapshot.write_pin`` so keep-K GC cannot delete them). A rejected
    version is remembered and never re-tried; only a *newer* commit ends
    the quarantine.

- every reply is version-stamped (``Replica.version`` → the wire frame's
  ``model_version`` + ``serving.requests_total{version}``) so a client
  A/B is attributable to the exact manifest seq that served it;
- state survives a server restart: every transition is journaled
  (``rollout_{started,canary_failed,completed,rolled_back}`` in the
  recovery journal), and a fresh controller re-adopts the incumbent
  version and re-enters an in-flight roll from CANARY;
- chaos seams: ``rollout.watch`` / ``rollout.load`` / ``rollout.swap`` /
  ``rollout.verify`` — injected failures land in typed, journaled,
  shed-free outcomes (a failed step never raises into the serving loop).

``loader(manifest_path, replica_idx) -> predictor`` is how weights become
a predictor; production wires it to ``snapshot.load_manifest_blob`` (exact
manifest, no fallback — the version stamp must never lie), tests pass
fakes. The golden gate compares host copies of the canary's and the
incumbent's outputs (``inference.Predictor`` returns host arrays; a tensor
an executor returns is copied off its device first).
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..resilience.faults import maybe_inject
from ..resilience.snapshot import (
    CheckpointCommitError, list_manifests, manifest_name, verify_manifest,
    write_pin,
)

__all__ = ["RolloutError", "GoldenMismatch", "RolloutConfig",
           "ManifestWatcher", "RolloutController"]


class RolloutError(RuntimeError):
    """A rollout step failed (watch/load/swap/verify). Handled by the
    controller — journaled and retried or rolled back, never raised into
    the serving loop."""


class GoldenMismatch(RolloutError):
    """The canary failed the golden-request quality gate: non-finite
    output, changed output shape, or drift beyond ``golden_max_drift``
    relative to the incumbent's outputs."""


def _host(o):
    """One output as a host ndarray: a tensor is copied off its device,
    bf16 widened to f32 (numpy has no bf16)."""
    if isinstance(o, torch.Tensor):
        o = o.detach().cpu()
        return (o.float() if o.dtype == torch.bfloat16 else o).numpy()
    return np.asarray(o)


def _flag(name, default):
    from ..framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


def _registry():
    from ..profiler.metrics import get_registry
    return get_registry()


class RolloutConfig:
    """Controller knobs; defaults come from FLAGS so a live binary can be
    retuned with ``paddle.set_flags``. ``golden_check(canary_outputs,
    incumbent_outputs) -> bool`` overrides the built-in finite+drift gate
    with a model-specific one; ``consumer`` names the retention pin file
    (``pins/<consumer>.json``) under the checkpoint root."""

    def __init__(self, poll_interval=None, golden_max_drift=None,
                 drain_timeout=None, max_step_failures=None,
                 golden_check=None, consumer="serving"):
        self.poll_interval = float(
            poll_interval if poll_interval is not None
            else _flag("FLAGS_rollout_poll_interval", 30.0))
        self.golden_max_drift = float(
            golden_max_drift if golden_max_drift is not None
            else _flag("FLAGS_rollout_golden_max_drift", 1.0))
        self.drain_timeout = float(
            drain_timeout if drain_timeout is not None
            else _flag("FLAGS_rollout_drain_timeout", 60.0))
        self.max_step_failures = int(
            max_step_failures if max_step_failures is not None
            else _flag("FLAGS_rollout_max_step_failures", 3))
        self.golden_check = golden_check
        self.consumer = str(consumer)


class ManifestWatcher:
    """Discovers the newest committed manifest newer than the fleet's
    current version — exactly the snapshot restore walk (newest → oldest,
    every referenced file digest-verified), so a torn or partially-written
    manifest racing a commit is skipped and *never* loaded."""

    def __init__(self, root):
        self.root = os.path.abspath(root)

    def poll(self, current_seq=0, rejected=frozenset()):
        """Newest verified ``(seq, path)`` with ``seq > current_seq`` and
        not previously rejected, or None. Fault site ``rollout.watch``;
        an unverifiable manifest increments ``rollout.skipped_torn_total``
        and falls through to the next-older candidate."""
        maybe_inject("rollout.watch", RolloutError)
        for seq, path in list_manifests(self.root):
            if seq <= current_seq:
                return None
            if seq in rejected:
                continue
            try:
                verify_manifest(path)
            except CheckpointCommitError:
                _registry().inc_counter("rollout.skipped_torn_total")
                continue
            return seq, path
        return None


class RolloutController:
    """Rolling-update state machine over one server's replica fleet.

    Attach with ``server.attach_rollout(root, loader, goldens=...)``; the
    pump/threaded loop calls :meth:`tick` once per batching round. Model
    versions ARE manifest sequence numbers (``None`` = launch weights).
    """

    IDLE = "IDLE"
    CANARY = "CANARY"
    ROLLING = "ROLLING"
    ROLLBACK = "ROLLBACK"

    def __init__(self, server, root, loader, goldens=(), config=None,
                 journal=None, clock=None, job_id="serving-rollout",
                 resume=True):
        self.server = server
        self.scheduler = server.scheduler
        self.root = os.path.abspath(root)
        self._loader = loader
        self._launch_factory = self.scheduler._factory
        self.goldens = [list(g) for g in goldens]
        self.config = config or RolloutConfig()
        self._clock = clock if clock is not None else server._clock
        if journal is None:
            from ..resilience.recovery import RecoveryJournal
            journal = RecoveryJournal(job_id=job_id, clock=self._clock)
        self.journal = journal
        self.watcher = ManifestWatcher(self.root)
        # serializes tick() (the pump/serve thread) against describe()/
        # active() (stats endpoints on request threads)
        self._lock = threading.Lock()
        self.state = self.IDLE     # guarded-by: _lock
        self.version = None        # guarded-by: _lock (incumbent seq;
        #                            None = launch weights)
        self.prior = None          # guarded-by: _lock (version before it)
        self.target = None         # guarded-by: _lock (seq being rolled)
        self._target_path = None   # guarded-by: _lock
        self._goal_factory = None  # guarded-by: _lock (converging to)
        self._goal_version = None  # guarded-by: _lock
        self._canary_idx = None    # guarded-by: _lock
        self._golden_ref = None    # guarded-by: _lock (quality-gate ref)
        self._capacity0 = None     # guarded-by: _lock (placeable at start)
        self._draining = {}        # guarded-by: _lock (idx -> drain start)
        self._rejected = set()     # guarded-by: _lock (failed seqs)
        self._next_poll = None     # guarded-by: _lock (None = poll now)
        self._step_failures = 0    # guarded-by: _lock
        if resume:
            with self._lock:
                self._resume()

    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.monotonic()

    def active(self):
        """True while a roll (or rollback) is converging the fleet — the
        autoscaler holds resizes and ``stats()`` shows the transition."""
        with self._lock:
            return self.state != self.IDLE

    def describe(self):
        with self._lock:
            return {"state": self.state, "version": self.version,
                    "prior": self.prior, "target": self.target,
                    "canary": self._canary_idx,
                    "draining": sorted(self._draining),
                    "rejected": sorted(self._rejected),
                    "step_failures": self._step_failures}

    # -- the drive loop ------------------------------------------------------
    def tick(self, now=None):
        """One controller round, driven from the server's batching loop.
        Never raises: a failed step is journaled (``rollout_step_failed``)
        and retried, or — in CANARY, or past ``max_step_failures`` in
        ROLLING — triggers rollback. Returns the state after the round."""
        now = self._now() if now is None else now
        with self._lock:
            try:
                if self.state == self.IDLE:
                    self._tick_idle(now)
                elif self.state == self.CANARY:
                    self._tick_canary(now)
                else:
                    self._tick_roll(now)
            except Exception as e:  # noqa: BLE001 — serving loop survives
                self._note_step_failure(e, now)
            return self.state

    def _tick_idle(self, now):  # requires-lock: _lock
        if self._next_poll is not None and now < self._next_poll:
            return
        self._next_poll = now + self.config.poll_interval
        found = self.watcher.poll(self._seq(), rejected=self._rejected)
        if found is not None:
            self._start(found[0], found[1], now)

    def _seq(self):  # requires-lock: _lock
        return self.version if self.version is not None else 0

    def _start(self, seq, path, now, resumed=False):  # requires-lock: _lock
        self.target, self._target_path = int(seq), path
        self._canary_idx = None
        self._step_failures = 0
        self._capacity0 = self._placeable_count()
        self._goal_factory = self._make_factory(path)
        self._goal_version = self.target
        # pin BEFORE loading anything: K commits could land mid-roll and
        # GC must not delete the manifests rollback depends on
        self._write_pins(extra=[path])
        # golden reference: the incumbent's outputs, captured before the
        # canary enters placement
        self._golden_ref = self._incumbent_golden_outputs()
        self.journal.record(
            "rollout_resumed" if resumed else "rollout_started",
            target=self.target, manifest=os.path.basename(path),
            incumbent=self.version, replicas=self._capacity0)
        _registry().inc_counter("rollout.started_total")
        self.state = self.CANARY

    # -- CANARY --------------------------------------------------------------
    def _tick_canary(self, now):  # requires-lock: _lock
        rep = self.scheduler.find_replica(self._canary_idx) \
            if self._canary_idx is not None else None
        if rep is None:
            # warm-first admission: preflight KAT + re-warm of every
            # recorded warmup signature happen inside add_replica, so the
            # canary never pays compiles (or proves sickness) on traffic
            self._canary_idx = self.scheduler.add_replica(
                factory=self._goal_factory, version=self.target)
            rep = self.scheduler.find_replica(self._canary_idx)
        if rep is None or not rep.healthy or rep.restarts > 0 \
                or rep.version != self.target:
            raise RolloutError(
                f"canary replica {self._canary_idx} died before the "
                f"golden gate (version {self.target})")
        self._verify_canary(rep)
        # gate passed: from here every rebuild/scale-up builds the target
        self.scheduler.set_version_loader(self._goal_factory, self.target)
        self.journal.record("rollout_canary_passed", target=self.target,
                            replica=rep.idx)
        self._step_failures = 0
        self.state = self.ROLLING

    def _verify_canary(self, rep):  # requires-lock: _lock
        """The golden-request quality gate (fault site ``rollout.verify``):
        run every pinned golden request through the canary's executor and
        compare against the incumbent's captured outputs. Non-finite
        canary output always fails; otherwise relative drift beyond
        ``golden_max_drift`` fails — or a custom ``golden_check``
        decides. Raises :class:`GoldenMismatch`."""
        maybe_inject("rollout.verify", RolloutError)
        if not self.goldens:
            return
        outs = [self._run_golden(rep, g) for g in self.goldens]
        ref = self._golden_ref
        if self.config.golden_check is not None:
            if not self.config.golden_check(outs, ref):
                raise GoldenMismatch(
                    f"canary (version {self.target}) failed the custom "
                    "golden check")
            return
        for gi, golden in enumerate(outs):
            for oi, arr in enumerate(golden):
                a = np.asarray(arr, dtype=np.float64)
                if not np.all(np.isfinite(a)):
                    raise GoldenMismatch(
                        f"canary (version {self.target}) produced non-"
                        f"finite output {oi} on golden request {gi}")
                if ref is None or gi >= len(ref) or oi >= len(ref[gi]):
                    continue
                b = np.asarray(ref[gi][oi], dtype=np.float64)
                if a.shape != b.shape:
                    raise GoldenMismatch(
                        f"canary (version {self.target}) changed output "
                        f"{oi} shape on golden request {gi}: "
                        f"{a.shape} vs incumbent {b.shape}")
                denom = max(float(np.max(np.abs(b))), 1e-6)
                drift = float(np.max(np.abs(a - b))) / denom
                if drift > self.config.golden_max_drift:
                    raise GoldenMismatch(
                        f"canary (version {self.target}) drifted "
                        f"{drift:.3g}x from the incumbent on golden "
                        f"request {gi} (max {self.config.golden_max_drift})")

    def _run_golden(self, rep, arrays):
        return [_host(o)
                for o in rep.executor.run([np.asarray(a) for a in arrays])]

    def _incumbent_golden_outputs(self):  # requires-lock: _lock
        if not self.goldens:
            return None
        rep = self._pick_incumbent()
        if rep is None:
            return None
        return [self._run_golden(rep, g) for g in self.goldens]

    def _pick_incumbent(self):  # requires-lock: _lock
        for r in self.scheduler.replicas:
            if r.placeable() and r.version == self.version:
                return r
        for r in self.scheduler.replicas:
            if r.placeable():
                return r
        return None

    # -- ROLLING / ROLLBACK --------------------------------------------------
    def _tick_roll(self, now):  # requires-lock: _lock
        self._finish_drains(now)
        if self.state == self.ROLLING and self._goal_unhealthy():
            self._begin_rollback(
                "new-version replica died or tripped its breaker", now)
            return
        goal = self._goal_version
        stale = [r for r in self.scheduler.replicas
                 if r.version != goal and not r.draining
                 and not r.fenced_out]
        if not stale and not self._draining:
            self._finish(now)
            return
        if stale:
            self._swap_one(stale[0], now)
        self._step_failures = 0

    def _goal_unhealthy(self):  # requires-lock: _lock
        """Mid-roll health gate: a goal-version replica that died (its
        restart counter moved), went unhealthy, or tripped its breaker is
        evidence against the target version — roll back."""
        for r in self.scheduler.replicas:
            if r.version == self._goal_version and not r.fenced_out:
                if not r.healthy or r.restarts > 0 \
                        or not r.breaker.allows():
                    return True
        return False

    def _swap_one(self, old, now):  # requires-lock: _lock
        """One replica-by-replica roll step (fault site ``rollout.swap``):
        add a goal-version replica, then begin draining one stale one.
        The add lands before the drain and the autoscaler holds resizes,
        so effective capacity never dips below its size at roll start —
        zero sheds are attributable to the roll."""
        maybe_inject("rollout.swap", RolloutError)
        # draining `old` only costs capacity if it was serving; a dead
        # canary (rollback path) costs nothing to drain, so no add needed
        drop = 1 if (old.healthy and not old.draining) else 0
        if self._placeable_count() - drop < self._capacity0:
            self.scheduler.add_replica(factory=self._goal_factory,
                                       version=self._goal_version)
        self.scheduler.begin_drain(old.idx)
        self._draining[old.idx] = now

    def _placeable_count(self):  # requires-lock: _lock
        return len([r for r in self.scheduler.replicas
                    if r.healthy and not r.draining and not r.fenced_out])

    def _finish_drains(self, now):  # requires-lock: _lock
        """Remove drained replicas whose in-flight work finished; past
        ``drain_timeout`` force-remove (the scheduler fences them — a late
        result is dropped and the batch retried, never delivered)."""
        removed = []
        for idx, started in list(self._draining.items()):
            rep = self.scheduler.find_replica(idx)
            if rep is None:
                del self._draining[idx]
                continue
            forced = now - started > self.config.drain_timeout
            if rep.inflight > 0 and not forced:
                continue
            self.scheduler.remove_replica(idx, force=forced)
            del self._draining[idx]
            removed.append(idx)
        return removed

    def _finish(self, now):  # requires-lock: _lock
        if self.state == self.ROLLING:
            self.prior, self.version = self.version, self.target
            self._write_pins()
            self.journal.record("rollout_completed", version=self.version,
                                prior=self.prior,
                                replicas=self._placeable_count())
            _registry().inc_counter("rollout.completed_total")
        else:
            # rollback complete: 100% incumbent-version serving restored.
            # The failed seq stays rejected — only a NEWER commit rolls.
            self._rejected.add(self.target)
            self._write_pins()
            self.journal.record("rollout_rolled_back", failed=self.target,
                                restored=self.version,
                                replicas=self._placeable_count())
            _registry().inc_counter("rollout.rolled_back_total")
        self.target = None
        self._target_path = None
        self._canary_idx = None
        self._golden_ref = None
        self._capacity0 = None
        self._step_failures = 0
        self.state = self.IDLE

    # -- failure handling ----------------------------------------------------
    def _note_step_failure(self, exc, now):  # requires-lock: _lock
        self._step_failures += 1
        try:
            self.journal.record("rollout_step_failed", state=self.state,
                                target=self.target, error=repr(exc),
                                failures=self._step_failures)
        except Exception:
            pass  # journaling is best-effort on the failure path
        _registry().inc_counter("rollout.step_failures_total")
        if self.state == self.CANARY:
            self._fail_canary(exc, now)
        elif self.state == self.IDLE:
            # a failed poll/start leaves nothing half-armed; the watcher
            # retries at the next poll interval
            self.target = None
            self._target_path = None
            self._canary_idx = None
        elif self.state == self.ROLLING and \
                self._step_failures >= self.config.max_step_failures:
            self._begin_rollback(
                f"{self._step_failures} consecutive failed roll steps: "
                f"{exc}", now)
        # ROLLBACK step failures: keep retrying — restoring incumbent
        # serving is never abandoned

    def _fail_canary(self, exc, now):  # requires-lock: _lock
        self.journal.record("rollout_canary_failed", target=self.target,
                            replica=self._canary_idx, error=repr(exc))
        _registry().inc_counter("rollout.canary_failures_total")
        # take the rejected canary out of placement NOW — the batch
        # assembled right after this tick must not land on it. It is
        # extra capacity (added on top of the roll-start fleet), so
        # draining it immediately costs nothing.
        if self._canary_idx is not None:
            rep = self.scheduler.find_replica(self._canary_idx)
            if rep is not None and not rep.draining:
                self.scheduler.begin_drain(rep.idx)
                self._draining[rep.idx] = now
        self._begin_rollback(f"canary failed: {exc}", now)

    def _begin_rollback(self, reason, now):  # requires-lock: _lock
        """Flip the roll into reverse: the goal becomes the incumbent
        version again, loaded from its still-pinned manifest (or the
        launch factory when the incumbent IS the launch weights). The
        same swap loop then converges the fleet back."""
        self.journal.record("rollout_rollback_begin", target=self.target,
                            restore=self.version, reason=str(reason))
        self._goal_factory = self._incumbent_factory()
        self._goal_version = self.version
        self.scheduler.set_version_loader(self._goal_factory, self.version)
        self._step_failures = 0
        self.state = self.ROLLBACK

    def _incumbent_factory(self):  # requires-lock: _lock
        if self.version is not None:
            path = os.path.join(self.root, manifest_name(self.version))
            if os.path.exists(path):
                return self._make_factory(path)
        launch = self._launch_factory
        return lambda idx: launch(idx)

    # -- loading / pins ------------------------------------------------------
    def _make_factory(self, path):
        return lambda idx: self._load(path, idx)

    def _load(self, path, idx):  # requires-lock: _lock
        """Build one predictor from one exact manifest (fault site
        ``rollout.load``): an injected or real load failure is typed and
        journaled, and the replica is never half-admitted (add_replica
        only admits after preflight + warmup succeed)."""
        maybe_inject("rollout.load", RolloutError)
        return self._loader(path, idx)

    def _write_pins(self, extra=None):  # requires-lock: _lock
        """Pin the manifests instant rollback depends on — incumbent,
        prior, and any in-flight roll target — against keep-K retention.
        Best-effort: a pin write failure must not fail the roll."""
        names = [manifest_name(s) for s in (self.version, self.prior)
                 if s is not None]
        names.extend(os.path.basename(p) for p in (extra or []))
        try:
            write_pin(self.root, self.config.consumer, names,
                      meta={"incumbent": self.version, "prior": self.prior})
        except OSError:
            pass

    # -- resume --------------------------------------------------------------
    def _resume(self):  # requires-lock: _lock
        """Re-arm from the recovery journal after a server restart: adopt
        the last completed (or rollback-restored) incumbent version, keep
        failed targets rejected, and re-enter an in-flight roll — a
        ``rollout_started``/``rollout_resumed`` with no terminal event
        after it — from CANARY, so the target is re-proven on the fresh
        process before the fleet converges again. Launch-built replicas
        are stamped with the incumbent version (the operator contract:
        the launch factory serves the newest completed version)."""
        try:
            entries = list(self.journal.entries())
        except Exception:
            return
        version = prior = None
        inflight = None
        for e in entries:
            ev = e.get("event")
            if ev in ("rollout_started", "rollout_resumed"):
                inflight = e.get("target")
            elif ev == "rollout_completed":
                version, prior = e.get("version"), e.get("prior")
                inflight = None
            elif ev == "rollout_rolled_back":
                if e.get("failed") is not None:
                    self._rejected.add(e.get("failed"))
                version = e.get("restored", version)
                inflight = None
        if version is None and inflight is None and not self._rejected:
            return
        try:
            self.version, self.prior = version, prior
            if version is not None:
                self.scheduler.stamp_versions(version)
                self.scheduler.set_version_loader(
                    self._incumbent_factory(), version)
            if inflight is not None and inflight not in self._rejected:
                seq = int(inflight)
                path = os.path.join(self.root, manifest_name(seq))
                if os.path.exists(path) and seq > self._seq():
                    self._start(seq, path, self._now(), resumed=True)
        except Exception as e:  # noqa: BLE001 — resume is best-effort
            try:
                self.journal.record("rollout_resume_failed", error=repr(e))
            except Exception:
                pass
