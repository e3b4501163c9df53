"""Random state: seeds become explicit torch.Generators.

Port of paddle_tpu/core/random.py. The reference keeps one global JAX key;
here every entry point takes a ``torch.Generator`` (a caller that passes
none draws from torch's own default generator). A CPU generator draws the
same numbers wherever the tensors end up, so a model built from a seed has
the same weights on the host and on the card.

Random draws inside a step go through ``uniform``, which tells a
``to_static`` discovery pass which generators the step uses
(``collect_generators``): the capture registers them with the CUDA graph,
so each replay draws new numbers. A CPU generator cannot feed a captured
CUDA step (its draws happen once, on the host, at capture) and raises
there; torch's default CUDA generator needs no registration.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["make_generator", "seed", "uniform", "collect_generators"]

# the sets of generators that running discovery passes collect
_collectors: list = []


def make_generator(seed: int = 0, device="cpu"):
    """A fresh generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def seed(s: int):
    """paddle.seed: reseed torch's default generators (the host's and
    each card's, which layers built without a generator and dropout
    without one draw from) and nothing else; numpy's generator is left as
    it is, as the reference leaves it. Returns the host's default
    generator."""
    return torch.manual_seed(int(s))


@contextlib.contextmanager
def collect_generators(into):
    """Add to the set ``into`` every explicit generator that ``uniform``
    draws from while the block runs."""
    _collectors.append(into)
    try:
        yield into
    finally:
        _collectors.remove(into)


def uniform(shape, generator, device):
    """Uniform [0, 1) f32 draws of ``shape`` on ``device`` from
    ``generator`` (None: torch's default generator of ``device``). A CPU
    generator draws on the host and the draws are copied to ``device``."""
    if generator is not None:
        for into in _collectors:
            into.add(generator)
    gen_dev = generator.device if generator is not None else device
    if torch.device(device).type == "cuda" and gen_dev.type != "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a random draw from a CPU generator inside a step captured as "
            "a CUDA graph would be fixed at capture: give the layers a CUDA "
            "generator (or none) to train with dropout under to_static")
    return torch.rand(shape, generator=generator, device=gen_dev).to(device)
