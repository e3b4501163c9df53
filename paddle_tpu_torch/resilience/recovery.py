"""Coordinated elastic recovery: generation fencing + automatic restart
(port of paddle_tpu/resilience/recovery.py).

- **Generation fencing.** Every (re)start of the collective group gets a
  monotonic generation agreed through the elastic store
  (:meth:`ElasticManager.rendezvous`). p2p frames are stamped with it
  (``distributed/wire.py`` ``stamp_generation``) and every
  ``watch_section`` checks it on exit, so a rank still replaying
  generation ``g`` after the survivors moved to ``g+1`` fails fast with
  :class:`StaleGeneration` instead of corrupting or hanging the new group.
- **Automatic in-job restart.** :class:`RecoveryManager` supervises a
  train function: a :class:`DistributedError` (watchdog timeout, peer
  abort, stale generation) or a transport failure tears the group down
  (the p2p channel and the torch process group), re-rendezvouses at the
  next generation (waiting for replacements up to
  ``FLAGS_recovery_rendezvous_timeout``, proceeding scaled-in at
  ``np_min``), forms the process group again at that generation where
  one was formed before, restores from the last good checkpoint through
  the caller's ``restore`` hook, and resumes. A restart budget
  (``FLAGS_recovery_max_restarts``, exponential backoff) bounds flapping;
  when it is spent the job fails with :class:`RecoveryExhausted`.
- **Recovery journal.** Every restart's cause (exception, flight-recorder
  tail, unhealthy markers, new generation and group size) is appended to
  a per-job JSONL journal in ``PADDLE_TPU_ARTIFACTS_DIR``, in the
  reference's fields, so either package reads the other's journal.

Clock and sleep are injectable everywhere, so the chaos tests run the
kill -> re-rendezvous -> resume loop with no real sleeps.
"""
from __future__ import annotations

import json
import os
import threading
import time

from .faults import maybe_inject
from .watchdog import (  # noqa: F401  (StaleGeneration re-exported)
    DistributedError, DistributedTimeout, PeerAbort, StaleGeneration,
)

__all__ = ["StaleGeneration", "RecoveryExhausted", "RendezvousTimeout",
           "MembershipChange", "RECOVERABLE",
           "current_generation", "set_generation", "reset_generation",
           "RecoveryJournal", "get_journal", "reset_journal",
           "RecoveryManager"]


class RendezvousTimeout(DistributedError):
    """Rendezvous could not gather even ``np_min`` ranks in time."""

    def __init__(self, generation, arrived, np_min, timeout):
        super().__init__(
            f"rendezvous at generation {generation} gathered {arrived} "
            f"rank(s) in {timeout:.1f}s but needs at least {np_min}")
        self.generation = int(generation)
        self.arrived = int(arrived)
        self.np_min = int(np_min)
        self.timeout = float(timeout)


class RecoveryExhausted(DistributedError):
    """The restart budget (FLAGS_recovery_max_restarts) is spent."""

    def __init__(self, max_restarts, cause=""):
        msg = f"recovery budget exhausted after {max_restarts} restart(s)"
        if cause:
            msg += f"; last cause: {cause}"
        super().__init__(msg)
        self.max_restarts = int(max_restarts)
        self.cause = cause


class MembershipChange(DistributedError):
    """The elastic manager saw RESTART/HOLD or unhealthy peers: the group
    must re-rendezvous. Raised by :meth:`RecoveryManager.check` at step
    boundaries and recovered by :meth:`RecoveryManager.run`."""

    def __init__(self, status, np=None, unhealthy=()):
        msg = f"elastic membership change: status={status}"
        if np is not None:
            msg += f", np={np}"
        if unhealthy:
            msg += f", unhealthy ranks={sorted(unhealthy)}"
        super().__init__(msg)
        self.status = status
        self.np = np
        self.unhealthy = list(unhealthy)


# -- process-wide generation state -------------------------------------------

_GEN_LOCK = threading.Lock()
# NOT seeded from PADDLE_TPU_GENERATION: the launcher's relaunch counter is
# only a floor for rendezvous PROPOSALS (ElasticManager reads it), never the
# frame-stamping generation; the process adopts a generation only through
# set_generation() after a store-agreed rendezvous.
_GENERATION = [0]


def current_generation():
    """This process's collective generation (0 = never rendezvoused;
    frames stay unstamped and fencing is inert)."""
    return _GENERATION[0]


def set_generation(gen):
    """Adopt a generation. Monotonic: a LOWER value is ignored (a stale
    rank must never drag the fence backwards). Returns the effective
    generation."""
    with _GEN_LOCK:
        _GENERATION[0] = max(_GENERATION[0], int(gen))
        return _GENERATION[0]


def reset_generation():
    """Test hook: back to the unfenced generation 0."""
    with _GEN_LOCK:
        _GENERATION[0] = 0


# -- recovery journal --------------------------------------------------------

class RecoveryJournal:
    """Append-only JSONL journal of recovery events for one job.

    One JSON object per line; ``entries`` skips a torn final line from a
    writer that died mid-append. Lands in ``PADDLE_TPU_ARTIFACTS_DIR`` next
    to the flight-recorder dumps.
    """

    def __init__(self, job_id="local", dir=None, clock=None):
        self.job_id = str(job_id)
        self._dir = dir
        self._clock = clock
        self._lock = threading.Lock()

    @property
    def path(self):
        from .recorder import artifacts_dir
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in self.job_id)
        return os.path.join(self._dir or artifacts_dir(),
                            f"recovery_journal_{safe}.jsonl")

    def _now(self):
        return self._clock() if self._clock is not None else time.time()

    def record(self, event, **fields):
        """Append one event. Stamps job/ts/generation; explicit fields win
        (the launcher records the CHILD's generation, not its own)."""
        entry = {"event": event, "job": self.job_id, "ts": self._now(),
                 "generation": current_generation()}
        entry.update(fields)
        line = json.dumps(entry, default=repr)
        with self._lock:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._rotate(len(line) + 1)
            with open(self.path, "a") as f:
                f.write(line + "\n")
                f.flush()
        return entry

    def _rotate(self, incoming):
        """Past ``FLAGS_journal_max_bytes`` the segment moves to
        ``<path>.1`` (replacing the previous one): at most two segments.
        0 disables. The caller holds _lock."""
        from ..framework.flags import get_flag
        limit = int(get_flag("FLAGS_journal_max_bytes", 1 << 20) or 0)
        if limit <= 0:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return
        if size and size + incoming > limit:
            try:
                os.replace(self.path, self.path + ".1")
            except OSError:
                pass  # rotation is housekeeping; the append must proceed

    def entries(self):
        """All readable events, oldest first: the rotated segment (if any)
        then the current one. Torn lines are skipped in either."""
        out = []
        for p in (self.path + ".1", self.path):
            try:
                with open(p) as f:
                    lines = f.read().splitlines()
            except OSError:
                continue
            for ln in lines:
                try:
                    out.append(json.loads(ln))
                except ValueError:
                    continue  # torn tail from a writer that died mid-append
        return out


_JOURNAL = [None]
_J_LOCK = threading.Lock()


def get_journal():
    """Process-global journal keyed by PADDLE_JOB_ID (default "local")."""
    with _J_LOCK:
        if _JOURNAL[0] is None:
            _JOURNAL[0] = RecoveryJournal(
                os.environ.get("PADDLE_JOB_ID", "local"))
        return _JOURNAL[0]


def reset_journal():
    with _J_LOCK:
        _JOURNAL[0] = None


# -- recovery manager --------------------------------------------------------

def _flag(name, default):
    from ..framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


# what run() recovers from: every distributed diagnostic (timeout, peer
# abort, stale generation, membership change) plus raw transport failures.
# Everything else (ValueError, Preempted, OOM) propagates: a restart cannot
# fix a deterministic bug and must not eat a preemption.
RECOVERABLE = (DistributedError, ConnectionError, TimeoutError)


class RecoveryManager:
    """Supervises a train function: detect -> tear down -> re-rendezvous ->
    re-form -> restore -> resume, under a restart budget.

    Parameters
    ----------
    elastic: ElasticManager, which owns registration and the rendezvous.
    restore: callable(generation) -> resume-state, called after each
        re-rendezvous (typically ``load_hybrid_checkpoint``); its return
        value is passed to ``train_fn`` on the next attempt. A step cut
        short mid-backward leaves this rank's local gradients in the
        parameters (the reference's functional step holds none): the hook
        clears them (``optimizer.clear_grad()``) before the next step
        accumulates on them.
    on_restart: callable(generation, endpoints), after the restore.
    preflight: callable(generation), after the re-rendezvous and before
        the restore (typically ``health.run_preflight``).
    max_restarts / rendezvous_timeout / backoff_base /
        restart_reset_steps: default to ``FLAGS_recovery_*``.
    clock / sleep / journal: injectable for fake-clock chaos tests.

    The budget refills after ``restart_reset_steps`` consecutive healthy
    steps (clean :meth:`check` passes or :meth:`note_progress` calls); 0
    keeps one budget for the job's lifetime.
    """

    def __init__(self, elastic, restore=None, on_restart=None,
                 max_restarts=None, rendezvous_timeout=None,
                 backoff_base=None, restart_reset_steps=None, clock=None,
                 sleep=None, journal=None, preflight=None):
        self.elastic = elastic
        self.restore = restore
        self.on_restart = on_restart
        # a survivor whose device went bad since the last generation
        # quarantines itself here: Quarantined is a SystemExit, not
        # RECOVERABLE, so it propagates
        self.preflight = preflight
        self.max_restarts = int(
            _flag("FLAGS_recovery_max_restarts", 3)
            if max_restarts is None else max_restarts)
        self.rendezvous_timeout = float(
            _flag("FLAGS_recovery_rendezvous_timeout", 300.0)
            if rendezvous_timeout is None else rendezvous_timeout)
        self.backoff_base = float(
            _flag("FLAGS_recovery_backoff_base", 1.0)
            if backoff_base is None else backoff_base)
        self.restart_reset_steps = int(
            _flag("FLAGS_recovery_restart_reset_steps", 100)
            if restart_reset_steps is None else restart_reset_steps)
        self._clock = clock
        self._sleep = sleep or time.sleep
        self.journal = journal or get_journal()
        self.restarts = 0
        self._healthy_steps = 0

    # -- detection ---------------------------------------------------------
    def check(self):
        """Step-boundary poll: raise :class:`MembershipChange`
        (recoverable) when the manager sees RESTART/HOLD or another rank
        went unhealthy or quarantined while it still holds a lease."""
        from ..distributed.fleet.elastic import ElasticStatus
        status = self.elastic.poll()
        unhealthy = [u.get("rank") for u in self.elastic.unhealthy_nodes()
                     if u.get("rank") != self.elastic.rank]
        if status in (ElasticStatus.RESTART, ElasticStatus.HOLD):
            raise MembershipChange(status, np=self.elastic.np(),
                                   unhealthy=unhealthy)
        if unhealthy:
            raise MembershipChange("unhealthy", np=self.elastic.np(),
                                   unhealthy=unhealthy)
        quarantined = self._quarantined_live_peers()
        if quarantined:
            raise MembershipChange("quarantined", np=self.elastic.np(),
                                   unhealthy=quarantined)
        self.note_progress()
        return status

    def _quarantined_live_peers(self):
        """Quarantined peers that still hold a live node lease: the group
        must re-rendezvous them OUT. Once such a rank exits (its lease
        lapses) its long-lived marker alone no longer trips check()."""
        try:
            alive = {int(v.get("rank", -1))
                     for v in self.elastic.alive_nodes()}
            return sorted(
                r for r in (int(q.get("rank", -1))
                            for q in self.elastic.quarantined_nodes())
                if r != self.elastic.rank and r in alive)
        except AttributeError:
            return []  # an elastic manager without quarantine support

    def note_progress(self, steps=1):
        """Count healthy progress toward refilling the restart budget
        (journalled as ``budget_reset`` when it refills)."""
        if self.restarts == 0 or self.restart_reset_steps <= 0:
            return
        self._healthy_steps += int(steps)
        if self._healthy_steps >= self.restart_reset_steps:
            self.journal.record("budget_reset", restarts=self.restarts,
                                healthy_steps=self._healthy_steps)
            self.restarts = 0
            self._healthy_steps = 0

    # -- supervision -------------------------------------------------------
    def run(self, train_fn):
        """Run ``train_fn(resume)`` to completion, restarting it through
        :meth:`restart` on every recoverable failure. ``resume`` is None on
        the first attempt and the ``restore`` hook's value after each
        restart."""
        resume = None
        while True:
            try:
                return train_fn(resume)
            except RECOVERABLE as e:
                resume = self.restart(cause=e)

    def restart(self, cause=None):
        """One full recovery cycle, in this order:

        1. the budget and an exponential backoff (correlated failures
           must not stampede the rendezvous);
        2. the diagnostics (flight-recorder tail, unhealthy markers),
           captured BEFORE the teardown clears them;
        3. the teardown: the p2p channel and the torch process group, so
           generation-g sockets and queues cannot leak into g+1;
        4. the re-rendezvous (replacements may join; below np_max the
           group proceeds scaled-in), PADDLE_TRAINER_ENDPOINTS rewritten
           to the group, and the process group formed again at the new
           generation where one was formed before;
        5. the preflight, the flush of this process's pending background
           checkpoint commits (``snapshot.flush_all``, bounded by
           ``FLAGS_ckpt_flush_timeout``), the restore from the last good
           checkpoint and the journal entry.

        A rank's restore reads what every rank's committer wrote: where a
        peer holds the committer, the hook meets it (a barrier of the
        re-formed group) before it reads, so the peer's flush came first.
        """
        maybe_inject("recovery.restart", ConnectionError)
        from .integrity import IntegrityError
        cause_name = type(cause).__name__ if cause is not None else \
            "requested"
        culprits = []
        if isinstance(cause, IntegrityError):
            # journal the typed verdict ("sdc", "preflight", ...), not the
            # class name, and make sure an accused rank is marked even if
            # its own consensus-side mark was lost to a store hiccup
            cause_name = cause.kind
            culprits = list(cause.culprits)
            if self.elastic.rank in culprits:
                try:
                    self.elastic.mark_quarantined(
                        reason=f"{cause.kind}: {cause}")
                except Exception:
                    pass
        self._healthy_steps = 0  # a failure breaks the healthy streak
        self.restarts += 1
        if self.restarts > self.max_restarts:
            self.journal.record("recovery_exhausted", cause=cause_name,
                                detail=str(cause or ""),
                                restarts=self.restarts - 1)
            raise RecoveryExhausted(self.max_restarts,
                                    cause=repr(cause)) from cause
        tail = self._flight_tail()
        try:
            unhealthy = [u.get("rank")
                         for u in self.elastic.unhealthy_nodes()]
        except Exception:
            unhealthy = []
        delay = self.backoff_base * (2 ** (self.restarts - 1))
        if delay > 0:
            self._sleep(min(delay, 60.0))
        from ..distributed import env, p2p
        try:
            p2p.shutdown()
        except Exception:
            pass  # teardown is best effort; the rendezvous decides liveness
        env.teardown()
        gen, endpoints = self.elastic.rendezvous(
            timeout=self.rendezvous_timeout)
        if endpoints:
            os.environ["PADDLE_TRAINER_ENDPOINTS"] = ",".join(endpoints)
        self._reform(endpoints)
        if self.preflight is not None:
            self.preflight(gen)
        # the restore discovers the newest COMMITTED manifest, so a commit
        # still in flight on this process's background committer lands (or
        # fails into the journal) before the hook looks
        try:
            from ..framework.flags import get_flag
            from . import snapshot as _snapshot
            _snapshot.flush_all(
                timeout=get_flag("FLAGS_ckpt_flush_timeout", 60.0))
        except Exception:
            pass  # a wedged committer must not block recovery
        resume = self.restore(gen) if self.restore is not None else None
        record = dict(restart=self.restarts, cause=cause_name,
                      detail=str(cause or ""), generation=gen,
                      np=len(endpoints), flight_tail=tail,
                      unhealthy=unhealthy)
        if culprits:
            record["culprits"] = culprits
        self.journal.record("restart", **record)
        if self.on_restart is not None:
            self.on_restart(gen, endpoints)
        return resume

    def _reform(self, endpoints):
        """Form the process group again over the rendezvous' group, where
        this process had formed one: its rank is its endpoint's place
        among the group's, its world the group's size. The work queued on
        the card finishes first, so the restore reads settled memory."""
        from ..distributed import env
        if not env._STATE.get("formed"):
            return
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if self.elastic.endpoint in endpoints:
            os.environ["PADDLE_TRAINER_ID"] = str(
                endpoints.index(self.elastic.endpoint))
        os.environ["PADDLE_TRAINERS_NUM"] = str(len(endpoints))
        env.init_parallel_env()

    @staticmethod
    def _flight_tail(n=3):
        from .recorder import get_recorder
        try:
            return [f"{e.get('op')}#{e.get('seq')}[{e.get('status')}]"
                    for e in get_recorder().tail(n)]
        except Exception:
            return []
