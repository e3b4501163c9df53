"""Whole-step compilation made observable (port of
paddle_tpu/jit/compiled_step.py).

``CompiledTrainStep`` wraps a train step (forward, backward, optimizer
update) in a ``StaticFunction``, whose programs are CUDA graphs on the
card (jit/to_static.py), and counts its lifecycle:

- ``compiles`` increments once per signature, when its program is built
  (its graph captured), and ``cache_hits`` on every call (or every step of
  ``run_steps``) that replays a built program; ``compile_stats()`` reads
  them and ``reset_compile_stats()`` zeroes them. Both are mirrored into
  the metrics registry as ``compiled_step.compiles_total`` and
  ``compiled_step.cache_hits_total``; the serving decode step
  (``serving/decode/compiled_decode.py``) counts into the same pair.
- A retrace-storm guard counts the distinct signatures one step builds
  and, past ``FLAGS_compiled_step_max_retraces``, warns once through
  ``warnings``.
- A call whose program is not built yet (a discovery pass, or the
  capture) runs under the StepTimer's ``step/compile`` phase
  (profiler/steptimer.py).
- ``FLAGS_compiled_step=0`` (``compiled_step_enabled()``) or
  ``enable_to_static(False)`` makes the wrapper a passthrough to the eager
  step, with no counters.

``CompiledStageProgram`` is the same lifecycle for one direction of a
pipeline stage (distributed/fleet/pipeline_engine.py: the forward, the
forward with the loss, the recompute backward): a CUDA graph per input
signature, the same counters, builds under ``step/compile``. The engine
decides whether a stage is captured, so a stage program captures
whatever ``FLAGS_compiled_step`` says.

Not ported yet: the flight-recorder entry of a retrace storm comes with
the observability modules (ROADMAP A11).
"""
from __future__ import annotations

import threading
import warnings

from ..framework.flags import get_flag
from ..profiler import metrics as _metrics
from ..profiler import steptimer as _steptimer
from .to_static import StaticFunction, _sig_of, _sig_of_step

__all__ = ["CompiledTrainStep", "CompiledStageProgram",
           "compiled_step_enabled", "compile_stats", "reset_compile_stats"]

_STATS = {"compiles": 0, "cache_hits": 0, "retrace_warnings": 0}
_stats_lock = threading.Lock()


def compiled_step_enabled():
    """The FLAGS_compiled_step switch (default on)."""
    return bool(get_flag("FLAGS_compiled_step", True))


def compile_stats():
    """Process-wide counters: compiles, cache hits, retrace warnings."""
    with _stats_lock:
        return dict(_STATS)


def reset_compile_stats():
    with _stats_lock:
        for k in _STATS:
            _STATS[k] = 0


def _note_compile(n=1):
    with _stats_lock:
        _STATS["compiles"] += n
    _metrics.get_registry().inc_counter("compiled_step.compiles_total", n)


def _note_cache_hit(n=1):
    with _stats_lock:
        _STATS["cache_hits"] += n
    _metrics.get_registry().inc_counter("compiled_step.cache_hits_total", n)


class CompiledTrainStep:
    """A train step as a StaticFunction, with compile attribution and the
    retrace guard: ``__call__`` runs one step, ``run_steps`` K steps.
    ``label`` names the step in the retrace warning."""

    def __init__(self, fn, label="train_step"):
        self._static = fn if isinstance(fn, StaticFunction) \
            else StaticFunction(fn)
        self._label = label
        self._seen_sigs = set()
        self._storm_warned = False

    @property
    def static_function(self):
        return self._static

    def _guard_retrace(self, key):
        """Count distinct keys; past the flag's bound the step builds a new
        program per batch (ragged shapes, Python values in the signature):
        warn once instead of capturing silently."""
        if key in self._seen_sigs:
            return
        self._seen_sigs.add(key)
        bound = int(get_flag("FLAGS_compiled_step_max_retraces", 8))
        if bound <= 0 or len(self._seen_sigs) <= bound or self._storm_warned:
            return
        self._storm_warned = True
        with _stats_lock:
            _STATS["retrace_warnings"] += 1
        warnings.warn(
            f"compiled_step[{self._label}]: {len(self._seen_sigs)} distinct "
            f"input signatures built (> FLAGS_compiled_step_max_retraces="
            f"{bound}). Every new shape captures a new CUDA graph: pad or "
            f"bucket inputs to a fixed set of shapes.",
            RuntimeWarning, stacklevel=3)

    def _counted(self, key, run):
        prog = self._static._programs.get(key)
        built, hits = (prog.built, prog.hits) if prog else (False, 0)
        if not built:
            self._guard_retrace(key)
            with _steptimer.get_steptimer().phase("step/compile"):
                out = run()
        else:
            out = run()
        prog = self._static._programs.get(key)
        if prog is not None:
            if prog.built and not built:
                _note_compile()
            if prog.hits > hits:
                _note_cache_hit(prog.hits - hits)
        return out

    def __call__(self, *args, **kwargs):
        st = self._static
        if not st._active():
            return st(*args, **kwargs)
        key = st._key(_sig_of(args), _sig_of(kwargs))
        return self._counted(key, lambda: st._call(key, args, kwargs))

    def run_steps(self, *args, **kwargs):
        st = self._static
        if not st._active():
            return st.run_steps(*args, **kwargs)
        key = st._key(_sig_of_step(args), _sig_of_step(kwargs))
        return self._counted(key, lambda: st.run_steps(*args, **kwargs))


class CompiledStageProgram(CompiledTrainStep):
    """One direction of a pipeline stage as a signature-keyed program (a
    CUDA graph per signature on the card; on the host the body, with the
    same keys and counters). ``label`` names it (``pp.s{stage}.{dir}``)
    in the retrace warning."""

    def __init__(self, fn, label="stage"):
        super().__init__(fn, label=label)

    def __call__(self, *args):
        st = self._static
        key = st._key(_sig_of(args), _sig_of({}))
        return self._counted(key, lambda: st._call(key, args, {}))

    def stats(self):
        """Signatures seen, programs built, and calls that found theirs
        built (each a graph replay on the card)."""
        progs = self._static._programs.values()
        return {"label": self._label, "signatures": len(self._seen_sigs),
                "built": sum(p.built for p in progs),
                "hits": sum(p.hits for p in progs),
                "captured": sum(p.graph is not None for p in progs)}
