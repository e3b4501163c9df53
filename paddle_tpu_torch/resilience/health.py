"""Hardware health: the preflight known-answer test, quarantine and
stragglers (port of paddle_tpu/resilience/health.py).

- :func:`preflight_kat`, a seeded matmul + reduction known-answer test on
  a device, run when a serving replica restarts and, through
  :func:`run_preflight`, after a re-rendezvous (``RecoveryManager``'s
  ``preflight`` hook).
- quarantine: a rank that fails it publishes ``quarantined.<rank>`` in the
  elastic store (``ElasticManager.mark_quarantined``), a marker that
  survives re-rendezvous until ``FLAGS_quarantine_ttl``, and raises
  :class:`Quarantined`, a ``SystemExit`` with code
  :data:`QUARANTINE_EXIT_CODE`, which the launcher does not relaunch.
- :class:`StragglerDetector`: per-rank rolling-mean step times published
  as store heartbeats; ranks above ``FLAGS_straggler_threshold`` x the
  group median over ``FLAGS_straggler_window`` steps are flagged into
  profiler counters and the flight recorder and, opt-in through
  ``FLAGS_straggler_quarantine``, fed to the same quarantine path.
"""
from __future__ import annotations

import collections
import hashlib
import math
import statistics
import time

import numpy as np
import torch

from ..framework.flags import get_flag
from .faults import maybe_inject
from .integrity import IntegrityError, _flag

__all__ = ["QUARANTINE_EXIT_CODE", "Quarantined", "PreflightFailure",
           "preflight_kat", "run_preflight", "serving_preflight",
           "StragglerDetector"]

# Distinct from Preempted's 128+signum codes: the launcher must not
# confuse "this host is sick, leave it out" with "this host was preempted,
# bring it back". supervise_local_trainers treats 117 as terminal.
QUARANTINE_EXIT_CODE = 117


class PreflightFailure(IntegrityError):
    """The known-answer test failed on this device."""

    def __init__(self, message, **kw):
        kw.setdefault("kind", "preflight")
        super().__init__(message, **kw)


class Quarantined(SystemExit):
    """This rank is quarantined and must exit, not recover.

    A ``SystemExit`` (like ``Preempted``), NOT a ``DistributedError``: if
    RecoveryManager could catch it, a sick rank would loop
    fail -> restart -> fail. The process exits ``QUARANTINE_EXIT_CODE``
    and the supervising launcher leaves the rank down.
    """

    def __init__(self, rank, reason=""):
        super().__init__(QUARANTINE_EXIT_CODE)
        self.rank = int(rank)
        self.reason = reason

    def __str__(self):
        return (f"rank {self.rank} quarantined"
                + (f": {self.reason}" if self.reason else ""))


def preflight_kat(seed=0, size=64, rtol=1e-3, device="cpu"):
    """Seeded matmul + reduction KAT on ``device``; returns the result
    digest. Three checks, ordered by what they catch: the same launch
    twice must agree bitwise (unstable device memory); the product must
    match a host float64 reference within ``rtol`` (wrong GEMM results);
    its sum must match the reference's (accumulator faults). TF32 is off
    for the launches, as the reference's f32 dot is exact f32."""
    maybe_inject("integrity.preflight", PreflightFailure)
    rng = np.random.RandomState((1234 + int(seed)) % (2 ** 31))
    a = rng.standard_normal((size, size)).astype(np.float32)
    b = rng.standard_normal((size, size)).astype(np.float32)
    da = torch.from_numpy(a).to(device)
    db = torch.from_numpy(b).to(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        c1 = (da @ db).cpu().numpy()
        c2 = (da @ db).cpu().numpy()
        dev_sum = float((da @ db).sum())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not np.array_equal(c1, c2):
        raise PreflightFailure(
            "KAT matmul is not repeatable: two identical launches disagree "
            "bitwise (unstable device memory)")
    ref = a.astype(np.float64) @ b.astype(np.float64)
    if not np.allclose(c1, ref, rtol=rtol, atol=rtol * math.sqrt(size)):
        worst = float(np.max(np.abs(c1 - ref)))
        raise PreflightFailure(
            f"KAT matmul deviates from host reference (max abs err {worst:g} "
            f"beyond rtol={rtol})")
    ref_sum = float(ref.sum())
    if not math.isfinite(dev_sum) or \
            not np.isclose(dev_sum, ref_sum, rtol=rtol, atol=rtol * size):
        raise PreflightFailure(
            f"KAT reduction deviates from host reference "
            f"({dev_sum:g} vs {ref_sum:g})")
    return hashlib.sha256(c1.tobytes()).hexdigest()


def _rank_device():
    """The device this rank's process group runs on (the host without
    one)."""
    from ..distributed.env import device
    d = device()
    return d if d is not None else "cpu"


def run_preflight(elastic=None, seed=None, journal=None, device=None):
    """Run the KAT on this rank's device (``device``, default the process
    group's) and publish the verdict to the elastic store.

    On success: puts ``<job>/preflight.<rank>`` with the digest, returns
    the digest. On failure: marks ``quarantined.<rank>``, journals
    ``preflight_failed`` and raises :class:`Quarantined`. ``seed``
    defaults to the current generation, so every incarnation runs a fresh
    but deterministic KAT. Returns None when ``FLAGS_preflight_checks`` is
    off.
    """
    if not get_flag("FLAGS_preflight_checks", True):
        return None
    from .recovery import current_generation, get_journal
    gen = current_generation()
    rank = elastic.rank if elastic is not None else 0
    try:
        digest = preflight_kat(seed=gen if seed is None else seed,
                               device=device or _rank_device())
    except PreflightFailure as e:
        if elastic is not None:
            try:
                elastic.mark_quarantined(reason=f"preflight: {e}")
                elastic.store.put(
                    f"{elastic.job_id}/preflight.{rank}",
                    {"rank": rank, "ok": False, "generation": gen,
                     "error": str(e)})
            except Exception:
                pass
        try:
            (journal or get_journal()).record(
                "preflight_failed", rank=rank, detail=str(e))
        except Exception:
            pass
        raise Quarantined(rank, reason=str(e)) from e
    if elastic is not None:
        try:
            elastic.store.put(
                f"{elastic.job_id}/preflight.{rank}",
                {"rank": rank, "ok": True, "generation": gen,
                 "digest": digest})
        except Exception:
            pass
    return digest


def serving_preflight(predictor=None):
    """Health gate for a restarted serving replica: its device must pass
    the KAT before ``Scheduler.restart_dead`` lets it back into dispatch.
    The device is the predictor's (``device``, as ``inference.Predictor``
    has), else the host. Raises :class:`PreflightFailure`; returns the
    digest (None when ``FLAGS_preflight_checks`` is off)."""
    if not get_flag("FLAGS_preflight_checks", True):
        return None
    return preflight_kat(seed=0,
                         device=getattr(predictor, "device", None) or "cpu")


# -- straggler detection ----------------------------------------------------

class StragglerDetector:
    """k x median straggler detector over per-rank step-time heartbeats.

    Each rank feeds :meth:`note_step` (or brackets the step with
    :meth:`begin_step` / :meth:`end_step`) with its step time; the rolling
    mean over the last ``window`` steps is published to
    ``<job>/steptime.<rank>`` and emitted as a ``steptime.rank<N>_ms``
    profiler counter. :meth:`check` gathers every rank's published mean
    and flags ranks above ``threshold`` x the group median: slow relative
    to the group, which is robust to the whole job slowing down.

    Under a synchronous all-reduce every rank's wall step is the slowest
    one's, so a caller feeds what the rank itself spent (its step less the
    time it waited in collectives) for the detector to tell ranks apart.

    Detection only observes by default. With ``quarantine=True``
    (``FLAGS_straggler_quarantine``) a rank that finds itself flagged
    takes the quarantine exit: opt-in, because a straggler is often the
    network's fault, not the host's.
    """

    def __init__(self, elastic, window=None, threshold=None, clock=None,
                 recorder=None, quarantine=None):
        self.elastic = elastic
        self.window = int(_flag("FLAGS_straggler_window", 50)
                          if window is None else window)
        self.threshold = float(_flag("FLAGS_straggler_threshold", 3.0)
                               if threshold is None else threshold)
        self.quarantine = bool(_flag("FLAGS_straggler_quarantine", False)
                               if quarantine is None else quarantine)
        self._clock = clock
        self.recorder = recorder
        self._times = collections.deque(maxlen=max(1, self.window))
        self._t0 = None
        self.last_ratios = {}

    def _now(self):
        return self._clock() if self._clock is not None else time.monotonic()

    def begin_step(self):
        self._t0 = self._now()

    def end_step(self):
        """Close the bracket opened by :meth:`begin_step`; returns the
        measured duration (None if the bracket was never opened)."""
        if self._t0 is None:
            return None
        dt = self._now() - self._t0
        self._t0 = None
        self.note_step(dt)
        return dt

    def note_step(self, duration):
        """Record one step's time; publishes the rolling mean as this
        rank's step-time heartbeat. Returns the mean."""
        from ..profiler import record_counter
        self._times.append(float(duration))
        mean = sum(self._times) / len(self._times)
        rank = self.elastic.rank
        try:
            self.elastic.store.put(
                f"{self.elastic.job_id}/steptime.{rank}",
                {"rank": rank, "mean": mean, "n": len(self._times)})
        except Exception:
            pass  # a store hiccup must not fail the training step
        record_counter(f"steptime.rank{rank}_ms", mean * 1e3)
        return mean

    def check(self):
        """One detection round: returns the sorted straggler ranks (may
        include self). ``last_ratios`` holds every rank's mean / median
        ratio from this round."""
        from ..profiler import record_counter
        vals = self.elastic.store.alive_values(
            f"{self.elastic.job_id}/steptime.")
        by_rank = {int(v["rank"]): float(v["mean"])
                   for v in vals if v.get("n", 0) > 0}
        if len(by_rank) < 2:
            self.last_ratios = {}
            return []  # a group of one has no peers to lag behind
        median = statistics.median(by_rank.values())
        if median <= 0:
            self.last_ratios = {}
            return []
        self.last_ratios = {r: m / median for r, m in by_rank.items()}
        stragglers = sorted(r for r, ratio in self.last_ratios.items()
                            if ratio > self.threshold)
        for r in stragglers:
            record_counter(f"straggler.rank{r}", self.last_ratios[r])
            if self.recorder is not None:
                entry = self.recorder.start("health.straggler", peer=r)
                entry["ratio"] = self.last_ratios[r]
                self.recorder.finish(entry, status="detected")
        if self.quarantine and self.elastic.rank in stragglers:
            ratio = self.last_ratios[self.elastic.rank]
            reason = f"straggler: {ratio:.2f}x group median step time"
            try:
                self.elastic.mark_quarantined(reason=reason)
            except Exception:
                pass
            raise Quarantined(self.elastic.rank, reason=reason)
        return stragglers
