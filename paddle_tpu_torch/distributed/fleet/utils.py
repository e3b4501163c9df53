"""fleet.utils.recompute (port of paddle_tpu/distributed/fleet/utils.py).

``recompute(function, *args)`` runs the function under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the forward
keeps none of its activations and the backward reruns it to get them
back. Autograd Functions inside keep their own backwards, so flash
attention's B1 runs again in the rerun while B2 and B3 run once. Two
pieces of state that torch's checkpoint does not carry must be as the
forward saw them when the rerun happens inside ``loss.backward()``:

- the amp state (amp/auto_cast.py), a module global: the backward
  usually runs outside the ``auto_cast`` block, and the rerun would
  compute in f32 what the forward computed in bf16. It is saved when the
  forward runs and restored around the rerun.
- the generators of the layers that draw random numbers (training with
  dropout > 0; the layer's ``_generator``, or torch's default generator
  of the device when it has none): their states are saved when the
  forward runs and restored around the rerun, then put back, so the
  rerun draws the forward's masks. Inside a step being captured as a
  CUDA graph a generator's state cannot be saved that way: there the
  rerun switches each generator to a state of its own that the capture's
  discovery pass planned and the graph replays in step with the forward
  (core/random.py ``RerunPlan``), so each replay's rerun draws that
  replay's forward masks. A function that draws nothing saves nothing.

The region's fusion-policy decisions (``ops/autotune.py``) are taken for
a differentiated region: ``_FORCE_DIRECTION`` is "fwd_bwd" while the
forward runs, as in the reference.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ...amp.auto_cast import restore, snapshot
from ...core.random import rerun_region
from ...ops import autotune

__all__ = ["recompute"]


def _modules(function):
    owner = function if isinstance(function, torch.nn.Module) \
        else getattr(function, "__self__", None)
    return list(owner.modules()) if isinstance(owner, torch.nn.Module) \
        else []


def _draws(module):
    """Whether a layer draws random numbers when it runs: in training with
    a dropout probability (``p`` or ``dropout``) above 0."""
    return module.training and any(
        isinstance(v, float) and v > 0.0
        for v in (getattr(module, "p", None), getattr(module, "dropout", None)))


def _generators(function, args):
    device = next((t.device for t in args if isinstance(t, torch.Tensor)),
                  torch.device("cpu"))
    gens = {}
    for m in _modules(function):
        if hasattr(m, "_generator") and _draws(m):
            g = m._generator
            if g is None:
                g = (torch.cuda.default_generators[device.index or 0]
                     if device.type == "cuda" else torch.default_generator)
            gens[id(g)] = g
    return list(gens.values())


@contextlib.contextmanager
def _as_in_forward(amp_state, gens, states):
    amp_now = snapshot()
    now = [g.get_state() for g in gens]
    restore(amp_state)
    for g, s in zip(gens, states):
        g.set_state(s)
    try:
        yield
    finally:
        restore(amp_now)
        for g, s in zip(gens, now):
            g.set_state(s)


@contextlib.contextmanager
def _on_planned_states(amp_state, planned):
    """The captured rerun: the forward's amp state, and each generator
    switched to its planned state (graph-safe), then back."""
    amp_now = snapshot()
    live = [g.graphsafe_get_state() for g, _ in planned]
    restore(amp_state)
    for g, state in planned:
        g.graphsafe_set_state(state)
    try:
        yield
    finally:
        restore(amp_now)
        for (g, _), state in zip(planned, live):
            g.graphsafe_set_state(state)


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward (module docstring)."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    gens = _generators(function, args) if preserve else []
    amp_state = snapshot()
    planned = rerun_region(gens) if gens else None
    if planned is not None:
        def rerun():
            return _on_planned_states(amp_state, planned)
    else:
        states = [g.get_state() for g in gens]

        def rerun():
            return _as_in_forward(amp_state, gens, states)

    def contexts():
        return contextlib.nullcontext(), rerun()

    prev = autotune._FORCE_DIRECTION[0]
    autotune._FORCE_DIRECTION[0] = "fwd_bwd"
    try:
        return checkpoint(function, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=contexts,
                          **kwargs)
    finally:
        autotune._FORCE_DIRECTION[0] = prev
