"""Deterministic fault-injection registry (port of
paddle_tpu/resilience/faults.py: the same spec grammar and site names, so a
chaos spec written for the reference drives the port unchanged).

The chaos seam for the whole stack: storage, collective, and checkpoint
entry points call ``maybe_inject("<domain>.<op>")`` before doing real work,
and the registry — configured from ``FLAGS_fault_injection`` — decides
whether that call raises a simulated fault. Rates are evaluated per-site
with an independent seeded PRNG stream (``FLAGS_fault_injection_seed``), so
a given (spec, seed) pair produces the same fault schedule on every run and
injecting at one site never perturbs another site's schedule.

Spec grammar (comma-separated entries)::

    fs.upload:0.3          # probabilistic: fail ~30% of evaluations
    collective.all_reduce:1.0
    fs.mv:#3               # deterministic: fail exactly the 3rd evaluation
    fs.mv:#3+              # deterministic: fail the 3rd and every later one
    fs.mv:#3-5             # windowed burst: fail evaluations 3..5 inclusive
    fs:0.5                 # dot-prefix match: any fs.* site

Longest dot-prefix wins, so ``fs:0.1,fs.upload:1.0`` pins uploads at 1.0
while the rest of the fs domain stays at 0.1. An empty spec (the default)
disables the registry entirely; ``maybe_inject`` is then a two-instruction
no-op, safe to leave on hot paths.
"""
from __future__ import annotations

import random
import threading

__all__ = ["FaultInjected", "FaultRegistry", "configure", "reset",
           "maybe_inject", "should_inject", "fault_point", "stats",
           "is_active", "reconfigure_from_flags"]


class FaultInjected(RuntimeError):
    """Default exception raised at an injection point (call sites pass a
    domain-appropriate type, e.g. fs hooks raise ExecuteError)."""

    def __init__(self, site, count):
        super().__init__(f"injected fault at '{site}' (evaluation #{count})")
        self.site = site
        self.count = count


class _SiteRule:
    """One parsed spec entry: either a rate in [0,1] or a call-index rule."""

    def __init__(self, raw):
        self.raw = raw
        self.rate = None
        self.index = None       # 1-based evaluation index
        self.from_index = False  # '#N+' → N and onward
        self.to_index = None     # '#N-M' → N..M inclusive
        if raw.startswith("#"):
            body = raw[1:]
            if body.endswith("+"):
                self.from_index = True
                body = body[:-1]
            elif "-" in body:
                body, _, hi = body.partition("-")
                self.to_index = int(hi)
            self.index = int(body)
            if self.index < 1:
                raise ValueError(f"call index must be >=1: {raw!r}")
            if self.to_index is not None and self.to_index < self.index:
                raise ValueError(
                    f"window end must be >= start: {raw!r}")
        else:
            self.rate = float(raw)
            if not 0.0 <= self.rate <= 1.0:
                raise ValueError(f"fault rate must be in [0,1]: {raw!r}")

    def fires(self, count, rng):
        if self.index is not None:
            if self.from_index:
                return count >= self.index
            if self.to_index is not None:
                return self.index <= count <= self.to_index
            return count == self.index
        # always draw so the stream position depends only on the evaluation
        # count, not on rate changes
        return rng.random() < self.rate


class FaultRegistry:
    """Thread-safe site→rule table with per-site deterministic PRNG streams."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules = {}      # spec key -> _SiteRule
        self._seed = 0
        self._rngs = {}       # site -> random.Random
        self._counts = {}     # site -> evaluations
        self._injected = {}   # site -> injections
        self.active = False

    def configure(self, spec, seed=0):
        with self._lock:
            self._rules = {}
            self._seed = int(seed)
            self._rngs = {}
            self._counts = {}
            self._injected = {}
            for entry in (spec or "").split(","):
                entry = entry.strip()
                if not entry:
                    continue
                site, _, raw = entry.partition(":")
                if not raw:
                    raise ValueError(
                        f"bad fault spec entry {entry!r}: want 'site:rate'")
                self._rules[site.strip()] = _SiteRule(raw.strip())
            self.active = bool(self._rules)

    def reset(self):
        self.configure("", 0)

    def _rule_for(self, site):
        """Longest dot-prefix match: 'fs.upload' tries 'fs.upload' then 'fs'."""
        key = site
        while True:
            rule = self._rules.get(key)
            if rule is not None:
                return rule
            if "." not in key:
                return self._rules.get("*")
            key = key.rsplit(".", 1)[0]

    def should_fail(self, site):
        if not self.active:
            return False
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
            rule = self._rule_for(site)
            if rule is None:
                return False
            rng = self._rngs.get(site)
            if rng is None:
                rng = self._rngs[site] = random.Random(f"{self._seed}:{site}")
            if not rule.fires(count, rng):
                return False
            self._injected[site] = self._injected.get(site, 0) + 1
            return count

    def stats(self):
        with self._lock:
            return {site: {"evaluations": n,
                           "injected": self._injected.get(site, 0)}
                    for site, n in self._counts.items()}


_REGISTRY = FaultRegistry()


def configure(spec, seed=0):
    """Program the global registry; equivalent to setting
    FLAGS_fault_injection / FLAGS_fault_injection_seed."""
    _REGISTRY.configure(spec, seed)


def reset():
    _REGISTRY.reset()


def is_active():
    return _REGISTRY.active


def stats():
    return _REGISTRY.stats()


def reconfigure_from_flags():
    from ..framework.flags import get_flag
    _REGISTRY.configure(get_flag("FLAGS_fault_injection", "") or "",
                        get_flag("FLAGS_fault_injection_seed", 0) or 0)


def maybe_inject(site, exc_type=FaultInjected):
    """The injection point. No-op unless the registry has a matching rule
    that fires for this evaluation; then raises ``exc_type``.

    exc_type is instantiated as exc_type(site, count) when it is
    FaultInjected (or a subclass with that signature), else exc_type(msg).
    """
    if not _REGISTRY.active:
        return
    count = _REGISTRY.should_fail(site)
    if not count:
        return
    if exc_type is FaultInjected or (isinstance(exc_type, type)
                                     and issubclass(exc_type, FaultInjected)):
        raise exc_type(site, count)
    raise exc_type(f"injected fault at '{site}' (evaluation #{count})")


def should_inject(site):
    """Non-raising injection point for corruption-style faults.

    Some faults don't *fail* an operation — they silently change its result
    (``device.bitflip`` perturbs a checksum the way flipped device memory
    would). The call site asks the registry whether this evaluation is
    corrupted and applies the perturbation itself. Same spec grammar,
    streams, and counters as :func:`maybe_inject`.

    Returns the 1-based evaluation count (truthy int) when this evaluation
    is corrupted, so call sites can record *which* evaluation was perturbed
    in flight-recorder notes; returns a falsy value otherwise.
    """
    if not _REGISTRY.active:
        return False
    return _REGISTRY.should_fail(site)


def _init_from_flags():
    """Pick up an env-provided FLAGS_fault_injection at first import
    (mirrors framework.flags' gflags env-override behavior)."""
    reconfigure_from_flags()


_init_from_flags()


def fault_point(site, exc_type=FaultInjected):
    """Decorator form of maybe_inject for whole-function injection points."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            maybe_inject(site, exc_type)
            return fn(*args, **kwargs)
        wrapper.__fault_site__ = site
        return wrapper
    return deco
