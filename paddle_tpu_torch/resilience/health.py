"""Preflight known-answer test and the quarantine lifecycle (port of
``PreflightFailure``, ``preflight_kat``, ``serving_preflight``,
``Quarantined``, ``QUARANTINE_EXIT_CODE`` and ``run_preflight`` of
paddle_tpu/resilience/health.py).

- :func:`preflight_kat`, a seeded matmul + reduction known-answer test on
  a device, run when a serving replica restarts and, through
  :func:`run_preflight`, after a re-rendezvous (``RecoveryManager``'s
  ``preflight`` hook).
- quarantine: a rank that fails it publishes ``quarantined.<rank>`` in the
  elastic store (``ElasticManager.mark_quarantined``), a marker that
  survives re-rendezvous until ``FLAGS_quarantine_ttl``, and raises
  :class:`Quarantined`, a ``SystemExit`` with code
  :data:`QUARANTINE_EXIT_CODE`, which the launcher does not relaunch.

Straggler detection comes with the rest of the resilience slice (ROADMAP
A11).
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from ..framework.flags import get_flag
from .faults import maybe_inject
from .watchdog import DistributedError

__all__ = ["QUARANTINE_EXIT_CODE", "Quarantined", "PreflightFailure",
           "preflight_kat", "run_preflight", "serving_preflight"]

# Distinct from Preempted's 128+signum codes: the launcher must not
# confuse "this host is sick, leave it out" with "this host was preempted,
# bring it back". supervise_local_trainers treats 117 as terminal.
QUARANTINE_EXIT_CODE = 117


class PreflightFailure(DistributedError):
    """The known-answer test failed on this device."""

    def __init__(self, message, kind="preflight"):
        super().__init__(message)
        self.kind = kind


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
