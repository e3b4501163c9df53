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

A recomputed region (distributed/fleet/utils.py) must draw its forward's
masks again in the backward. Eagerly it saves and restores its
generators' states; inside a capture those states cannot be read, so a
``RerunPlan`` does it the graph-safe way: the discovery pass records
where, counted from the step's start, each region's draws begin on each
CUDA generator; the build gives every (region, generator) a state of its
own (``Generator.clone_state``) registered with the graph; the captured
rerun switches the generator to that state
(``graphsafe_set_state``) and back; and before every replay ``sync``
puts each state where its generator will be when the region's forward
draws, so the rerun draws the forward's numbers and each replay new ones.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["make_generator", "seed", "uniform", "normal",
           "collect_generators", "api_generator", "note_draw", "RerunPlan",
           "record_reruns", "play_reruns", "rerun_region",
           "get_cuda_rng_state", "set_cuda_rng_state"]

# the sets of generators that running discovery passes collect
_collectors: list = []
# the tensor API's generators, one per device, seeded from paddle.seed
_api_generators: dict = {}
# the RerunPlans that running discovery passes record, and the planned
# regions' states that running captures hand out
_recording: list = []
_playing: list = []


class RerunPlan:
    """Where each recomputed region of a step draws on its CUDA
    generators, and the graph states that replay those draws (module
    docstring)."""

    def __init__(self, device):
        default = torch.cuda.default_generators[device.index or 0]
        self.starts = {default: default.get_offset()}
        self.regions = []   # [[(generator, offset from the step's start)]]
        self.states = []    # [[(generator, its state for the rerun, offset)]]

    def saw(self, gen):
        """Note a generator's offset when the step first draws from it."""
        if gen.device.type == "cuda":
            self.starts.setdefault(gen, gen.get_offset())

    def region(self, gens):
        """A recomputed region's forward begins drawing from ``gens``."""
        for g in gens:
            self.saw(g)
        self.regions.append([(g, g.get_offset() - self.starts[g])
                             for g in gens if g.device.type == "cuda"])

    def register(self, graph):
        """Give every planned (region, generator) its own state, once, and
        register the states with ``graph`` before it is captured."""
        if not self.states:
            self.states = [[(g, g.clone_state(), d) for g, d in region]
                           for region in self.regions]
        for region in self.states:
            for _, state, _ in region:
                graph.register_generator_state(state)

    def sync(self):
        """Before a replay: each state at its generator's seed and at the
        offset where the region's forward will draw."""
        for region in self.states:
            for g, state, d in region:
                if state.initial_seed() != g.initial_seed():
                    state.manual_seed(g.initial_seed())
                state.set_offset(g.get_offset() + d)


@contextlib.contextmanager
def record_reruns(plan):
    """Record the recomputed regions of the block's step into ``plan``."""
    _recording.append(plan)
    try:
        yield plan
    finally:
        _recording.remove(plan)


@contextlib.contextmanager
def play_reruns(plan):
    """Hand the planned regions' states out, in order, to the recomputed
    regions captured in the block."""
    _playing.append(iter(plan.states))
    try:
        yield
    finally:
        _playing.pop()


def rerun_region(gens):
    """Called by a recomputed region as its forward starts. Eagerly, it
    is recorded into the running discovery passes' plans and None is
    returned; inside a capture it returns the region's planned
    [(generator, state)], or raises when there is no plan for it."""
    if not (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        for plan in _recording:
            plan.region(gens)
        return None
    region = next(_playing[-1], None) if _playing else None
    if region is None or [g for g, _, _ in region] != \
            [g for g in gens if g.device.type == "cuda"]:
        raise NotImplementedError(
            "recompute of a layer that draws dropout masks inside a CUDA "
            "graph capture needs the capture's discovery pass to have "
            "planned it: capture the step through jit.to_static, with the "
            "same recomputed regions in every call")
    return [(g, state) for g, state, _ in region]


def make_generator(seed: int = 0, device="cpu"):
    """A fresh generator on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def seed(s: int):
    """paddle.seed: reseed torch's default generators (the host's and
    each card's, which layers built without a generator and dropout
    without one draw from) and the tensor API's (``api_generator``);
    numpy's generator is left as it is, as the reference leaves it.
    Returns the host's default generator."""
    _api_generators.clear()
    return torch.manual_seed(int(s))


def _refuse_in_capture(what):
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what} inside a CUDA graph capture: a captured generator's "
            f"state cannot be read or set while it captures (as "
            f"Generator.clone_state refuses); call it outside the step")


def get_cuda_rng_state():
    """paddle.get_cuda_rng_state: the state of torch's default generator
    of each visible card (the ones ``seed`` seeds and dropout without a
    generator draws from), one per device (none on a host without a
    card). Refused inside a capture."""
    _refuse_in_capture("get_cuda_rng_state")
    return [torch.cuda.default_generators[i].get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state_list):
    """paddle.set_cuda_rng_state: put each card's default generator back
    to a state ``get_cuda_rng_state`` returned, so the next draws (a
    dropout mask) repeat. Refused inside a capture."""
    _refuse_in_capture("set_cuda_rng_state")
    states = list(state_list)
    if len(states) != torch.cuda.device_count():
        raise ValueError(f"set_cuda_rng_state: {len(states)} states for "
                         f"{torch.cuda.device_count()} devices")
    for i, st in enumerate(states):
        torch.cuda.default_generators[i].set_state(st)


def api_generator(device):
    """The generator the tensor API's random functions (tensor/random.py)
    draw from on ``device``: explicit, never torch's global one, seeded
    with the last ``seed`` (torch's initial seed before any)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    gen = _api_generators.get(device)
    if gen is None:
        gen = make_generator(torch.initial_seed(), device)
        _api_generators[device] = gen
    return gen


def note_draw(generator):
    """Tell the running discovery passes that the step draws from the
    explicit ``generator`` (the capture registers it with the graph)."""
    for into in _collectors:
        into.add(generator)
    for plan in _recording:
        plan.saw(generator)


@contextlib.contextmanager
def collect_generators(into):
    """Add to the set ``into`` every explicit generator that ``uniform``
    draws from while the block runs."""
    _collectors.append(into)
    try:
        yield into
    finally:
        _collectors.remove(into)


def _draw_device(generator, device):
    """Where ``generator`` (None: torch's default one of ``device``)
    draws, noted for the running discovery passes; a CPU generator's draw
    for a step captured on the card is refused."""
    if generator is not None:
        note_draw(generator)
    gen_dev = generator.device if generator is not None else device
    if torch.device(device).type == "cuda" and gen_dev.type != "cuda" \
            and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "a random draw from a CPU generator inside a step captured as "
            "a CUDA graph would be fixed at capture: give the layers a CUDA "
            "generator (or none) to train with dropout under to_static")
    return gen_dev


def uniform(shape, generator, device):
    """Uniform [0, 1) f32 draws of ``shape`` on ``device`` from
    ``generator`` (None: torch's default generator of ``device``). A CPU
    generator draws on the host and the draws are copied to ``device``."""
    return torch.rand(shape, generator=generator,
                      device=_draw_device(generator, device)).to(device)


def normal(shape, generator, device, dtype=torch.float32):
    """Standard normal draws of ``shape``, as ``uniform`` draws."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=_draw_device(generator, device)).to(device)
