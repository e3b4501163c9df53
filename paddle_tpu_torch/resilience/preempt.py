"""Preemption handling: SIGTERM → emergency checkpoint → resumable exit
(port of paddle_tpu/resilience/preempt.py).

A preemptible machine gets SIGTERM and a short grace window. The handler
turns the signal into a cooperative shutdown: the signal callback only
sets a flag (safe in any async context); training loops poll at step and
epoch boundaries, run the registered emergency actions once (typically a
checkpoint save with a ``preempted`` meta flag), and raise
:class:`Preempted`, a SystemExit with the conventional 128+signum exit
code, so that the process dies resumable. ``hapi.Model.fit`` adds a
:class:`PreemptionCallback` when a handler is installed. The drain first
lands the pending background checkpoint commits
(``snapshot.flush_all``, bounded by ``FLAGS_ckpt_flush_timeout``), so the
emergency save never races or orphans one.
"""
from __future__ import annotations

import signal
import threading

__all__ = ["Preempted", "PreemptionHandler", "PreemptionCallback",
           "install", "uninstall", "get_handler", "installed",
           "is_preempted", "check"]


class Preempted(SystemExit):
    """Cooperative-exit exception; SystemExit so an unhandled propagation
    terminates the process cleanly (no traceback spam in the grace window)
    with the conventional 128+signum code."""

    def __init__(self, signum=signal.SIGTERM):
        super().__init__(128 + int(signum))
        self.signum = int(signum)


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._signum = signal.SIGTERM
        self._actions = []    # (name, fn) run once, in registration order
        self._drained = False
        self._drain_lock = threading.Lock()
        self._prev = {}

    # -- signal plumbing --------------------------------------------------
    def install_signals(self):
        for s in self.signals:
            try:
                self._prev[s] = signal.signal(s, self._on_signal)
            except ValueError:
                # not the main thread — callers must use notify()
                pass
        return self

    def uninstall_signals(self):
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._prev = {}

    def _on_signal(self, signum, frame):
        self._signum = signum
        self._event.set()

    def notify(self, signum=signal.SIGTERM):
        """Programmatic preemption (tests, cluster-agent webhooks)."""
        self._signum = int(signum)
        self._event.set()

    def is_preempted(self):
        return self._event.is_set()

    def clear(self):
        self._event.clear()
        self._drained = False

    # -- emergency actions ------------------------------------------------
    def add_action(self, fn, name=None):
        """Register an emergency action (e.g. a checkpoint save closure).
        Actions run once per preemption, in registration order."""
        self._actions.append((name or getattr(fn, "__name__", "action"), fn))
        return fn

    def remove_action(self, fn):
        self._actions = [(n, f) for n, f in self._actions if f is not fn]

    def drain(self):
        """Run all emergency actions exactly once; returns [(name, error)]
        for any that failed (a broken save must not block the exit path)."""
        with self._drain_lock:
            if self._drained:
                return []
            self._drained = True
            failures = []
            # a background commit in flight lands BEFORE the emergency
            # save: the grace-window save never races or orphans it
            try:
                from ..framework.flags import get_flag
                from . import snapshot as _snapshot
                for mpath, err in _snapshot.flush_all(
                        timeout=get_flag("FLAGS_ckpt_flush_timeout", 60.0)):
                    failures.append((f"ckpt_flush:{mpath}", err))
            except Exception as e:  # noqa: BLE001 — exit path must survive
                failures.append(("ckpt_flush", e))
            for name, fn in self._actions:
                try:
                    fn()
                except Exception as e:  # noqa: BLE001 — exit path must survive
                    failures.append((name, e))
            return failures

    def check(self):
        """Poll point for training loops: no-op until preempted, then drains
        the emergency actions and raises Preempted."""
        if not self._event.is_set():
            return
        self.drain()
        raise Preempted(self._signum)


_HANDLER = None


def install(signals=(signal.SIGTERM,)):
    """Install (or return) the process-wide handler. Idempotent."""
    global _HANDLER
    if _HANDLER is None:
        _HANDLER = PreemptionHandler(signals).install_signals()
    return _HANDLER


def uninstall():
    global _HANDLER
    if _HANDLER is not None:
        _HANDLER.uninstall_signals()
        _HANDLER = None


def get_handler():
    return _HANDLER


def installed():
    return _HANDLER is not None


def is_preempted():
    return _HANDLER is not None and _HANDLER.is_preempted()


def check():
    if _HANDLER is not None:
        _HANDLER.check()


class PreemptionCallback:
    """hapi callback: polls the handler after every train batch; on
    preemption saves the model (when given a path), drains emergency
    actions, and stops training. Raises Preempted at train end so the
    process exits resumable."""

    def __init__(self, save_path=None, raise_on_end=True):
        self.save_path = save_path
        self.raise_on_end = raise_on_end
        self.model = None
        self.params = {}
        self.triggered = False

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def _poll(self):
        h = get_handler()
        if h is None or not h.is_preempted() or self.triggered:
            return
        self.triggered = True
        if self.save_path is not None and self.model is not None:
            try:
                # older pending commits land before the emergency save, so
                # the manifest sequence stays ordered under preemption
                from . import snapshot as _snapshot
                _snapshot.flush_all()
            except Exception:
                pass
            self.model.save(self.save_path)
        h.drain()
        if self.model is not None:
            self.model.stop_training = True

    def on_train_batch_end(self, step, logs=None):
        self._poll()

    def on_epoch_end(self, epoch, logs=None):
        self._poll()

    def on_train_end(self, logs=None):
        if self.triggered and self.raise_on_end:
            h = get_handler()
            raise Preempted(h._signum if h is not None else signal.SIGTERM)
