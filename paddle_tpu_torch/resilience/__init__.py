"""Resilience (port of paddle_tpu/resilience/).

- :mod:`.faults` — the deterministic, flag-driven fault-injection registry
  (``maybe_inject("<domain>.<op>")`` at every storage, collective,
  checkpoint and serving site);
- :mod:`.recorder` — the flight recorder, a bounded ring of operations
  dumped as JSON to the artifacts dir;
- :mod:`.watchdog` — deadlines on blocking sections; expiry dumps the
  recorder and the thread stacks and raises :class:`DistributedTimeout`;
- :mod:`.retry` — exponential-backoff retry shared by the FS transfer
  paths, checkpoint staging and the elastic heartbeat;
- :mod:`.recovery` — generation-fenced rendezvous, the in-job restart of
  :class:`RecoveryManager` under a budget, and the recovery journal;
- :mod:`.integrity` — silent-data-corruption defence: bitwise state
  checksums majority-voted across data-parallel replicas
  (:class:`ConsensusChecker`), and a bounded step-replay ring that
  re-executes an accused step on the host to classify hardware against
  software;
- :mod:`.health` — the preflight known-answer test, the quarantine
  lifecycle (:class:`Quarantined`, exit code 117) and k x median
  straggler detection (:class:`StragglerDetector`);
- :mod:`.guard` — the StepGuard that skips a non-finite train step
  (``hapi.Model.fit`` under ``FLAGS_check_nan_inf``);
- :mod:`.preempt` — SIGTERM to an emergency save and a resumable exit;
- :mod:`.snapshot` — zero-stall checkpoints: the background committer
  (:class:`~.snapshot.AsyncCheckpointer`), manifest commits with sha256
  sidecars, and exact resume.

- :mod:`.campaign` — the chaos campaign: seeded multi-site fault
  schedules over the manifest of :mod:`.injection_sites`, driven through a
  training and a serving scenario on a fake clock, with global invariants
  and a shrinker (imported on its own, as in the reference).
"""
from . import (faults, guard, health, integrity,  # noqa: F401
               preempt, recorder, recovery, retry, snapshot, watchdog)
from .faults import (  # noqa: F401
    FaultInjected, fault_point, maybe_inject, should_inject,
)
from .guard import BadStepError, StepGuard  # noqa: F401
from .health import (  # noqa: F401
    QUARANTINE_EXIT_CODE, PreflightFailure, Quarantined, StragglerDetector,
    preflight_kat, run_preflight, serving_preflight,
)
from .integrity import (  # noqa: F401
    ConsensusChecker, IntegrityError, StepReplayBuffer, checksum_state,
    classify_replay,
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

__all__ = ["faults", "retry", "guard", "preempt", "recorder", "recovery",
           "watchdog", "integrity", "health", "snapshot",
           "maybe_inject", "should_inject", "fault_point", "FaultInjected",
           "StepGuard", "BadStepError", "Preempted", "PreemptionHandler",
           "PreemptionCallback", "retry_call", "FlightRecorder",
           "get_recorder", "Watchdog", "watch_section", "DistributedError",
           "DistributedTimeout", "PeerAbort", "StaleGeneration",
           "RecoveryManager", "RecoveryJournal", "RecoveryExhausted",
           "RendezvousTimeout", "MembershipChange", "current_generation",
           "IntegrityError", "ConsensusChecker", "StepReplayBuffer",
           "checksum_state", "classify_replay", "Quarantined",
           "PreflightFailure", "preflight_kat", "run_preflight",
           "serving_preflight", "StragglerDetector", "QUARANTINE_EXIT_CODE"]
