"""Resilience (port of paddle_tpu/resilience/, the part serving runs on).

- :mod:`.faults` — the deterministic, flag-driven fault-injection registry
  (``maybe_inject("<domain>.<op>")`` at every serving and decode site);
- :mod:`.recorder` — the flight recorder, a bounded ring of operations
  dumped as JSON to the artifacts dir;
- :mod:`.watchdog` — deadlines on blocking sections (every serving batch
  runs in one); expiry dumps the recorder and the thread stacks and
  raises :class:`DistributedTimeout`;
- :mod:`.recovery` — the generation counter sections are fenced by;
- :mod:`.health` — the preflight known-answer test of a restarted replica;
- :mod:`.guard` — the StepGuard that skips a non-finite train step
  (``hapi.Model.fit`` under ``FLAGS_check_nan_inf``);
- :mod:`.preempt` — SIGTERM to an emergency save and a resumable exit;
- :mod:`.snapshot` — manifest-committed checkpoints with sha256 sidecars
  and exact resume (``hapi.Model.save``), synchronous only.

Retry, integrity, the async checkpointer, recovery's restart manager and
the rest wait for ROADMAP A11.
"""
from . import (faults, guard, health, preempt, recorder,  # noqa: F401
               recovery, snapshot, watchdog)
from .faults import (  # noqa: F401
    FaultInjected, fault_point, maybe_inject, should_inject,
)
from .guard import BadStepError, StepGuard  # noqa: F401
from .health import PreflightFailure, preflight_kat, serving_preflight  # noqa: F401
from .preempt import Preempted, PreemptionCallback, PreemptionHandler  # noqa: F401
from .recorder import FlightRecorder, get_recorder  # noqa: F401
from .recovery import current_generation  # noqa: F401
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
           "serving_preflight"]
