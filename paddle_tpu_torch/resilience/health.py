"""Preflight known-answer test for a restarted serving replica (port of
``PreflightFailure``, ``preflight_kat`` and ``serving_preflight`` of
paddle_tpu/resilience/health.py). The quarantine lifecycle and straggler
detection come with the rest of the resilience slice (ROADMAP A11).
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from ..framework.flags import get_flag
from .faults import maybe_inject
from .watchdog import DistributedError

__all__ = ["PreflightFailure", "preflight_kat", "serving_preflight"]


class PreflightFailure(DistributedError):
    """The known-answer test failed on this device."""

    def __init__(self, message, kind="preflight"):
        super().__init__(message)
        self.kind = kind


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
