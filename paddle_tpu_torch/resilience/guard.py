"""Step guard: NaN/Inf containment for compiled train steps (port of
paddle_tpu/resilience/guard.py).

A step captured as a CUDA graph runs as one launch, so a NaN born inside
it lands directly in the parameters. The guard closes that hole at the
step boundary::

    guard.before_step()          # snapshot of the registered state
    loss = compiled_step(batch)  # one replay
    ok = guard.after_step(loss)  # finite? no: restore the snapshot

A skipped step leaves the parameters bit-identical to the pre-step state
and backs off an attached GradScaler. After ``FLAGS_guard_max_bad_steps``
consecutive bad steps the guard rolls back through ``on_rollback`` or a
``saver`` (anything with ``load_checkpoint()``), and raises
:class:`BadStepError` when it has neither. ``hapi.Model.fit`` builds one
when ``FLAGS_check_nan_inf`` is set.

The snapshot is a copy of every tensor of the objects' state dicts on
the tensor's own device (the reference copies to the host), and the
restore copies back in place, keeping the addresses a captured step
holds. The reference's step-replay dump (``replay=``) waits for the
integrity module (ROADMAP A11).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..framework.io_utils import load_numpy_state_dict

__all__ = ["StepGuard", "BadStepError"]


class BadStepError(FloatingPointError):
    """Raised by StepGuard.after_step when a rollback is due and there is
    no rollback target."""


def _leaves(x, out):
    if isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    elif x is not None:
        out.append(x)
    return out


def _all_finite(x):
    """Finiteness over loss-like values (tensors, arrays, floats, and
    lists, tuples and dicts of them), with one host sync per device for
    all the floating tensors."""
    by_device = {}
    for v in _leaves(x, []):
        if isinstance(v, torch.Tensor):
            if v.is_floating_point() or v.is_complex():
                by_device.setdefault(v.device, []).append(
                    torch.isfinite(v).all())
            continue
        if isinstance(v, float):
            if not math.isfinite(v):
                return False
            continue
        arr = np.asarray(v)
        if (np.issubdtype(arr.dtype, np.floating)
                or np.issubdtype(arr.dtype, np.complexfloating)) \
                and not np.all(np.isfinite(arr)):
            return False
    return all(bool(torch.stack(flags).all())
               for flags in by_device.values())


def _set_state(obj, sd):
    """Copy a state dict into ``obj`` in place: an optimizer's
    ``set_state_dict``, or a module's ``load_numpy_state_dict`` (which
    also drops the fused ops' cached verdicts on the weights)."""
    if isinstance(obj, torch.nn.Module):
        load_numpy_state_dict(obj, sd)
    elif hasattr(obj, "set_state_dict"):
        obj.set_state_dict(sd)


class StepGuard:
    """Guards a train step over a fixed set of stateful objects.

    objs: modules and optimizers (anything with ``state_dict``), in the
    order a ``saver``'s checkpoint keys them ("0", "1", ...).
    """

    def __init__(self, objs, scaler=None, max_bad_steps=None, saver=None,
                 on_rollback=None, check_state=True):
        from ..framework.flags import get_flag
        self.objs = [o for o in objs if o is not None]
        self.scaler = scaler
        self.max_bad_steps = int(
            max_bad_steps if max_bad_steps is not None
            else get_flag("FLAGS_guard_max_bad_steps", 3))
        self.saver = saver
        self.on_rollback = on_rollback
        self.check_state = check_state
        self.bad_steps = 0       # consecutive
        self.steps = 0           # total steps observed
        self.skipped = 0         # total skipped
        self.rollbacks = 0
        self._pre = None

    # -- state capture ---------------------------------------------------
    def _capture(self):
        return [self._copy_tree(obj.state_dict())
                if hasattr(obj, "state_dict") else {} for obj in self.objs]

    @staticmethod
    def _copy_tree(sd):
        out = {}
        for k, v in sd.items():
            if isinstance(v, dict):
                out[k] = StepGuard._copy_tree(v)
            elif isinstance(v, torch.Tensor):
                out[k] = v.detach().clone()
            else:
                out[k] = v
        return out

    def _restore(self, snap):
        for obj, sd in zip(self.objs, snap):
            _set_state(obj, sd)

    def _state_finite(self):
        return _all_finite([obj.state_dict() for obj in self.objs
                            if hasattr(obj, "state_dict")])

    # -- step protocol ---------------------------------------------------
    def before_step(self):
        self._pre = self._capture()

    def after_step(self, loss=None):
        """True if the step is kept; False if it was skipped (the state
        restored) or a rollback fired."""
        self.steps += 1
        good = _all_finite(loss) and (not self.check_state
                                      or self._state_finite())
        if good:
            self.bad_steps = 0
            self._pre = None
            return True
        self.skipped += 1
        self.bad_steps += 1
        if self._pre is not None:
            self._restore(self._pre)
            self._pre = None
        self._backoff_scale()
        if self.bad_steps >= self.max_bad_steps:
            self.rollback()
        return False

    def guard(self, step_fn, *args, **kwargs):
        """Snapshot, run, check. Returns (result, ok)."""
        self.before_step()
        result = step_fn(*args, **kwargs)
        return result, self.after_step(result)

    # -- recovery --------------------------------------------------------
    def _backoff_scale(self):
        s = self.scaler
        if s is None or not getattr(s, "_enable", False):
            return
        with torch.no_grad():
            s._scale.fill_(max(float(s._scale) * s._decr_ratio, 1.0))

    def rollback(self):
        """Restore the registered state from the saver's last checkpoint
        (or run the on_rollback hook); resets the consecutive count."""
        self.bad_steps = 0
        self.rollbacks += 1
        if self.on_rollback is not None:
            self.on_rollback(self)
            return
        if self.saver is not None:
            state, meta = self.saver.load_checkpoint()
            if state is not None:
                for i, obj in enumerate(self.objs):
                    sub = state.get(str(i))
                    if sub is not None:
                        _set_state(obj, sub)
                return
        raise BadStepError(
            f"{self.max_bad_steps} consecutive non-finite steps and no "
            "rollback target (attach a saver or on_rollback)")
