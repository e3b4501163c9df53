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
  CUDA graph a generator's state cannot be saved that way, and such a
  function raises; a function that draws nothing saves nothing.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ...amp.auto_cast import restore, snapshot

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


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward (module docstring)."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    gens = _generators(function, args) if preserve else []
    if gens and any(isinstance(t, torch.Tensor) and t.is_cuda for t in args) \
            and torch.cuda.is_current_stream_capturing():
        raise NotImplementedError(
            "recompute of a layer that draws dropout masks inside a step "
            "being captured as a CUDA graph: the generators' states cannot "
            "be saved there; train it with dropout 0, without recompute, or "
            "with FLAGS_compiled_step=0")
    amp_state = snapshot()
    states = [g.get_state() for g in gens]

    def contexts():
        return contextlib.nullcontext(), _as_in_forward(amp_state, gens,
                                                        states)

    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=contexts, **kwargs)
