"""Global flags: paddle.set_flags / paddle.get_flags.

Port of paddle_tpu/framework/flags.py, with only the flags the port reads:

- ``FLAGS_compiled_step`` (default on): ``jit.to_static`` and
  ``jit.compiled_step.CompiledTrainStep`` capture a step as a CUDA graph;
  0 runs every call eagerly, the debug and parity oracle.
- ``FLAGS_compiled_step_max_retraces`` (8): distinct input signatures one
  compiled step may build before the retrace-storm guard warns; 0
  disables the guard.
- ``FLAGS_max_cached_programs`` (64): programs one ``to_static`` function
  keeps, evicted oldest first.

``FLAGS_donate_state_buffers`` is not ported: it donates a jitted
program's state buffers so XLA may write the new state over them, and a
CUDA graph already updates its state in place. A flag named in the
environment at import sets its initial value, as gflags does. Unknown
flags are stored as given, as the reference stores them.
"""
from __future__ import annotations

import os
from typing import Any

__all__ = ["get_flag", "get_flags", "set_flags"]

_FLAGS: dict[str, Any] = {
    "FLAGS_compiled_step": True,
    "FLAGS_compiled_step_max_retraces": 8,
    "FLAGS_max_cached_programs": 64,
}


def _coerce(cur, val):
    if isinstance(cur, bool):
        if isinstance(val, str):
            return val.lower() in ("1", "true", "yes")
        return bool(val)
    if isinstance(cur, int):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    return val


for _k in list(_FLAGS):
    if _k in os.environ:
        _FLAGS[_k] = _coerce(_FLAGS[_k], os.environ[_k])


def set_flags(flags: dict):
    for k, v in flags.items():
        _FLAGS[k] = _coerce(_FLAGS[k], v) if k in _FLAGS else v


def get_flags(flags=None):
    if flags is None:
        return dict(_FLAGS)
    if isinstance(flags, str):
        flags = [flags]
    return {k: _FLAGS.get(k) for k in flags}


def get_flag(name, default=None):
    return _FLAGS.get(name, default)
