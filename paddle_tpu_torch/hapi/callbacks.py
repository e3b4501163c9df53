"""Callbacks (port of paddle_tpu/hapi/callbacks.py, the same code).

``ModelCheckpoint`` saves through ``Model.save``, the hardened path of
``resilience.snapshot.save_model``; ``LRScheduler`` steps the optimizer's
scheduler, which writes the lr tensor a captured step reads at every
replay; ``VisualDL`` writes its scalars as JSON lines, as the reference
does (it needs no VisualDL package).
"""
from __future__ import annotations

import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "LRScheduler", "EarlyStopping", "VisualDL", "ReduceLROnPlateau"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                # params must be visible from inside on_train_begin itself
                # (reference: ProgBarLogger reads self.params there)
                if name == "on_train_begin" and args:
                    for c in self.callbacks:
                        c.set_params(args[0])
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._start = time.time()
        self._losses = []

    def on_train_batch_end(self, step, logs=None):
        logs = logs or {}
        loss = logs.get("loss")
        if loss:
            self._losses.append(loss[0])
        if self.verbose and self.log_freq and step % self.log_freq == 0:
            avg = np.mean(self._losses[-self.log_freq:]) if self._losses else 0
            print(f"Epoch {self.epoch} step {step}: loss {avg:.4f}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            avg = np.mean(self._losses) if self._losses else 0
            print(f"Epoch {epoch} done in {dt:.1f}s, avg loss {avg:.4f}")


class ModelCheckpoint(Callback):
    """Epoch-end checkpoints through the SAME hardened entry as Model.save
    (resilience.snapshot.save_model): sha256 sidecars, a generation-stamped
    manifest commit, and the FLAGS_async_checkpoint background committer —
    so a callback-driven checkpoint is restorable by RecoveryManager, not
    just reloadable when every byte happens to be intact."""

    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def _save(self, tag):
        path = f"{self.save_dir}/{tag}"
        save = getattr(self.model, "save", None)
        if callable(save):
            save(path)  # Model.save routes through snapshot.save_model
        else:
            # bare-Layer fallback: still the hardened path, never raw pickle
            from ..resilience.snapshot import save_model
            save_model(getattr(self.model, "network", self.model),
                       getattr(self.model, "_optimizer", None), path)

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self._save(str(epoch))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self._save("final")


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_scheduler", None) if opt else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class _MonitorCallback(Callback):
    """Shared best/patience machinery for monitor-driven callbacks."""

    def _init_monitor(self, monitor, mode, min_delta):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.wait = 0
        self.best = None
        if mode == "auto":
            mode = "min" if "loss" in monitor or "err" in monitor else "max"
        self.mode = mode

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta


class EarlyStopping(_MonitorCallback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self._init_monitor(monitor, mode, min_delta)
        self.patience = patience
        self.baseline = baseline

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class VisualDL(Callback):
    """Logging callback; writes scalars to a jsonl file (the reference writes
    VisualDL event files — out-of-scope dependency)."""

    def __init__(self, log_dir="./log"):
        super().__init__()
        self.log_dir = log_dir
        self._step = 0

    def on_train_batch_end(self, step, logs=None):
        import json
        import os
        os.makedirs(self.log_dir, exist_ok=True)
        with open(f"{self.log_dir}/scalars.jsonl", "a") as f:
            f.write(json.dumps({"step": self._step,
                                **{k: v for k, v in (logs or {}).items()
                                   if isinstance(v, (int, float, list))}})
                    + "\n")
        self._step += 1


class ReduceLROnPlateau(_MonitorCallback):
    """hapi/callbacks.py ReduceLROnPlateau parity: scale the optimizer LR by
    `factor` after `patience` epochs without improvement on `monitor`."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self._init_monitor(monitor, mode, min_delta)
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.cooldown_counter = 0

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self._better(cur):
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = self.model._optimizer
                if getattr(opt, "_lr_scheduler", None) is not None:
                    import warnings
                    warnings.warn(
                        "ReduceLROnPlateau: optimizer uses an LRScheduler; "
                        "set_lr would be ignored — use "
                        "optimizer.lr.ReduceOnPlateau instead")
                    self.wait = 0
                    return
                old = float(opt.get_lr())
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    opt.set_lr(new)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {old:g} -> {new:g}")
                self.cooldown_counter = self.cooldown
                self.wait = 0
