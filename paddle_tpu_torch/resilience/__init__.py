"""Resilience (port of paddle_tpu/resilience/, the part serving runs on).

- :mod:`.faults` — the deterministic, flag-driven fault-injection registry
  (``maybe_inject("<domain>.<op>")`` at every serving and decode site);
- :mod:`.recorder` — the flight recorder, a bounded ring of operations
  dumped as JSON to the artifacts dir;
- :mod:`.watchdog` — deadlines on blocking sections (every serving batch
  runs in one); expiry dumps the recorder and the thread stacks and
  raises :class:`DistributedTimeout`;
- :mod:`.recovery` — the generation counter sections are fenced by;
- :mod:`.health` — the preflight known-answer test of a restarted replica.

Retry, the step guard, preemption, integrity, recovery's restart manager
and the rest wait for ROADMAP A11.
"""
from . import faults, health, recorder, recovery, watchdog  # noqa: F401
from .watchdog import DistributedError, DistributedTimeout  # noqa: F401

__all__ = ["faults", "health", "recorder", "recovery", "watchdog",
           "DistributedError", "DistributedTimeout"]
