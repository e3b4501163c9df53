"""Whole-step compilation made observable (port of
paddle_tpu/jit/compiled_step.py).

``CompiledTrainStep`` wraps a train step (forward, backward, optimizer
update) in a ``StaticFunction``, whose programs are CUDA graphs on the
card (jit/to_static.py), and counts its lifecycle:

- ``compiles`` increments once per signature, when its program is built
  (its graph captured), and ``cache_hits`` on every call (or every step of
  ``run_steps``) that replays a built program; ``compile_stats()`` reads
  them and ``reset_compile_stats()`` zeroes them.
- A retrace-storm guard counts the distinct signatures one step builds
  and, past ``FLAGS_compiled_step_max_retraces``, warns once through
  ``warnings``.
- ``FLAGS_compiled_step=0`` (``compiled_step_enabled()``) or
  ``enable_to_static(False)`` makes the wrapper a passthrough to the eager
  step, with no counters.

Not ported yet: the flight-recorder entry of a retrace storm, the metrics
registry mirror of the counters and the StepTimer ``step/compile`` phase
come with the observability modules (ROADMAP A11); ``CompiledStageProgram``
(pipeline and ring-attention stage programs) with the distributed slice
(ROADMAP A10).
"""
from __future__ import annotations

import warnings

from ..framework.flags import get_flag
from .to_static import StaticFunction, _sig_of, _sig_of_step

__all__ = ["CompiledTrainStep", "compiled_step_enabled", "compile_stats",
           "reset_compile_stats"]

_STATS = {"compiles": 0, "cache_hits": 0, "retrace_warnings": 0}


def compiled_step_enabled():
    """The FLAGS_compiled_step switch (default on)."""
    return bool(get_flag("FLAGS_compiled_step", True))


def compile_stats():
    """Process-wide counters: compiles, cache hits, retrace warnings."""
    return dict(_STATS)


def reset_compile_stats():
    for k in _STATS:
        _STATS[k] = 0


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
        out = run()
        prog = self._static._programs.get(key)
        if prog is not None:
            if prog.built and not built:
                _STATS["compiles"] += 1
            _STATS["cache_hits"] += prog.hits - hits
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
