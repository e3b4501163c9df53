"""Degenerate-parameter guard for fused ops with reconstruction backwards.

Port of paddle_tpu/ops/_param_guard.py. fused_residual_ln's backward
recovers the normalized activation by dividing by the LayerNorm weight;
channels with |weight| <= tol cannot be recovered and the custom backward
would freeze them, so the entry point routes such weights through plain
autograd instead.

The verdict costs a host sync, so it is cached on the parameter
(``_degen_cache``, (tol, verdict)) with the parameter's ``_version``
(torch's count of in-place writes) stamped beside it (``_degen_stamp``). A
write the version counter sees (``copy_``, ``zero_``, ``load_state_dict``,
``paddle.assign(x, output=p)``) leaves a stamp that no longer matches,
and the verdict is checked again before it is used; a write through
``p.data``, which torch does not count, is caught by the port's
``Parameter.data`` (framework/param_attr.py), which clears the stamp. The
optimizers update in place every step and re-stamp the parameters they
updated (``fresh`` before, ``restamp`` after), so a training step costs
no sync. A check that changes a verdict bumps ``generation()``:
``to_static`` keys its programs by it, so a captured step whose branch
the change affects is built again, and only then.
"""
from __future__ import annotations

import weakref

import torch

__all__ = ["degenerate_below_tol", "recheck", "touch", "fresh", "restamp",
           "generation"]

# bumped whenever a check changes a cached verdict: a step captured as a
# CUDA graph took its branches from the verdicts of its time
_generation = [0]
# the parameters holding a verdict, by id (tensors compare elementwise, so
# they cannot key a WeakKeyDictionary)
_guarded: dict = {}


def _check(param, tol):
    with torch.no_grad():
        return bool((param.detach().abs() <= tol).any())


def _store(param, tol, res):
    param._degen_cache = (tol, res)
    param._degen_stamp = param._version
    key = id(param)
    if key not in _guarded:
        _guarded[key] = weakref.ref(param,
                                    lambda _, k=key: _guarded.pop(k, None))


def _refresh(param, cached):
    tol, old = cached
    res = _check(param, tol)
    _store(param, tol, res)
    if res != old:
        _generation[0] += 1
    return res


def degenerate_below_tol(param, tol):
    """True iff some element of ``param`` sits inside the |value| <= tol
    band: checked once (one host sync), then answered from the cache
    while the parameter's version matches the cached stamp."""
    cached = getattr(param, "_degen_cache", None)
    if cached is not None and cached[0] == tol:
        if param._degen_stamp == param._version:
            return cached[1]
        return _refresh(param, cached)
    res = _check(param, tol)
    _store(param, tol, res)
    return res


def recheck(param):
    """Check ``param``'s cached verdict again now (its values were
    replaced); a changed verdict bumps the generation."""
    cached = getattr(param, "_degen_cache", None)
    if cached is not None:
        _refresh(param, cached)


def touch(param):
    """``param`` may have been written where its version counter does not
    see it: its verdict is checked again before its next use."""
    if "_degen_cache" in param.__dict__:
        param._degen_stamp = None


def fresh(params):
    """The parameters among ``params`` whose verdict is current (taken
    before an optimizer's in-place update)."""
    return [p for p in params
            if getattr(p, "_degen_stamp", None) == p._version]


def restamp(params):
    """After an optimizer's in-place update of ``params`` (what ``fresh``
    returned): keep their verdicts, at the new versions. A trained weight
    landing exactly inside the band is not worth a sync per step."""
    for p in params:
        p._degen_stamp = p._version


def _capturing(param):
    return param.is_cuda and torch.cuda.is_current_stream_capturing()


def generation():
    """How many checks have changed a verdict so far, after checking again
    every verdict whose parameter was written since (none is checked
    while a CUDA graph captures: a sync would break the capture)."""
    for ref in list(_guarded.values()):
        p = ref()
        if p is None:
            continue
        cached = p.__dict__.get("_degen_cache")
        if cached is not None and p._degen_stamp != p._version \
                and not _capturing(p):
            _refresh(p, cached)
    return _generation[0]
