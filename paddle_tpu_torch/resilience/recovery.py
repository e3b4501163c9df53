"""The collective generation (port of the generation state of
paddle_tpu/resilience/recovery.py).

``watch_section`` fences every watched section by this process's
generation: a section whose generation moved while it blocked fails with
``StaleGeneration``. Generation-fenced rendezvous, the in-job restart
manager and the recovery journal come with the rest of the resilience
slice (ROADMAP A11); until then nothing moves the generation off 0, the
unfenced value.
"""
from __future__ import annotations

__all__ = ["current_generation"]

_GENERATION = [0]


def current_generation():
    """This process's collective generation (0 = never rendezvoused;
    fencing is inert)."""
    return _GENERATION[0]
