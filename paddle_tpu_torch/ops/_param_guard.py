"""Degenerate-parameter guard for fused ops with reconstruction backwards.

Port of paddle_tpu/ops/_param_guard.py. fused_residual_ln's backward
recovers the normalized activation by dividing by the LayerNorm weight;
channels with |weight| <= tol cannot be recovered and the custom backward
would freeze them, so the entry point routes such weights through plain
autograd instead.
"""
from __future__ import annotations

import torch

__all__ = ["degenerate_below_tol", "clear_degenerate_cache", "generation"]

# bumped whenever a cached verdict is dropped: a step captured as a CUDA
# graph took its branches from the verdicts of its time, and to_static keys
# its programs by this number, so a changed verdict builds a new program
_generation = [0]


def degenerate_below_tol(param, tol):
    """True iff some element of ``param`` sits inside the |value| <= tol
    band.

    The result is sticky per tensor: it is cached on the tensor as
    ``_degen_cache`` and kept across optimizer updates, so the check costs
    one host sync per parameter ever, not one per fused op per step. The
    guard exists to catch zero-initialised weights, which are set at
    construction or by loading a state dict, and loading drops the cache
    (``clear_degenerate_cache``); a trained weight landing exactly inside
    the band is not worth a sync per step."""
    cached = getattr(param, "_degen_cache", None)
    if cached is not None and cached[0] == tol:
        return cached[1]
    with torch.no_grad():
        res = bool((param.detach().abs() <= tol).any())
    param._degen_cache = (tol, res)
    return res


def clear_degenerate_cache(param):
    """Forget the guard's verdict on ``param`` (its values were replaced)."""
    if param.__dict__.pop("_degen_cache", None) is not None:
        _generation[0] += 1


def generation():
    """How many cached verdicts have been dropped so far."""
    return _generation[0]
