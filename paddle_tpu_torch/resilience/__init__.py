"""Resilience (port of paddle_tpu/resilience/, the part serving runs on).

- :mod:`.faults` — the deterministic, flag-driven fault-injection registry
  (``maybe_inject("<domain>.<op>")`` at every serving and decode site);
- :mod:`.recorder` — the flight recorder, a bounded ring of operations
  dumped as JSON to the artifacts dir;
- :mod:`.watchdog` — deadlines on blocking sections (every serving batch
  runs in one); expiry dumps the recorder and the thread stacks and
  raises :class:`DistributedTimeout`;
- :mod:`.retry` — exponential-backoff retry shared by the FS transfer
  paths, checkpoint staging and the elastic heartbeat;
- :mod:`.recovery` — generation-fenced rendezvous, the in-job restart of
  :class:`RecoveryManager` under a budget, and the recovery journal;
- :mod:`.health` — the preflight known-answer test, and the quarantine
  lifecycle (:class:`Quarantined`, exit code 117);
- :mod:`.guard` — the StepGuard that skips a non-finite train step
  (``hapi.Model.fit`` under ``FLAGS_check_nan_inf``);
- :mod:`.preempt` — SIGTERM to an emergency save and a resumable exit;
- :mod:`.snapshot` — manifest-committed checkpoints with sha256 sidecars
  and exact resume (``hapi.Model.save``), synchronous only.

Integrity, straggler detection, the async checkpointer and the rest wait
for ROADMAP A11.
"""
from . import (faults, guard, health, preempt, recorder,  # noqa: F401
               recovery, retry, snapshot, watchdog)
from .faults import (  # noqa: F401
    FaultInjected, fault_point, maybe_inject, should_inject,
)
from .guard import BadStepError, StepGuard  # noqa: F401
from .health import (  # noqa: F401
    QUARANTINE_EXIT_CODE, PreflightFailure, Quarantined, preflight_kat,
    run_preflight, serving_preflight,
)
from .preempt import Preempted, PreemptionCallback, PreemptionHandler  # noqa: F401
from .recorder import FlightRecorder, get_recorder  # noqa: F401
from .recovery import (  # noqa: F401
    MembershipChange, RecoveryExhausted, RecoveryJournal, RecoveryManager,
    RendezvousTimeout, current_generation,
)
from .retry import retry_call  # noqa: F401
from .watchdog import (  # noqa: F401
    DistributedError, DistributedTimeout, PeerAbort, StaleGeneration,
    Watchdog, watch_section,
)

__all__ = ["faults", "guard", "health", "preempt", "recorder", "recovery",
           "snapshot", "watchdog",
           "maybe_inject", "should_inject", "fault_point", "FaultInjected",
           "StepGuard", "BadStepError", "Preempted", "PreemptionHandler",
           "PreemptionCallback", "FlightRecorder", "get_recorder",
           "Watchdog", "watch_section", "DistributedError",
           "DistributedTimeout", "PeerAbort", "StaleGeneration",
           "current_generation", "PreflightFailure", "preflight_kat",
           "serving_preflight", "retry", "retry_call", "RecoveryManager",
           "RecoveryJournal", "RecoveryExhausted", "RendezvousTimeout",
           "MembershipChange", "Quarantined", "QUARANTINE_EXIT_CODE",
           "run_preflight"]
