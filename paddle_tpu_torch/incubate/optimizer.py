"""incubate optimizers (port of paddle_tpu/incubate/optimizer.py):
LookAhead and ModelAverage.

The parameters are updated in place, so their addresses, a captured
step's and the inner optimizer's state keep pointing at them."""
from __future__ import annotations

import torch

__all__ = ["LookAhead", "ModelAverage"]


class LookAhead:
    """Every ``k`` inner steps the slow weights move ``alpha`` of the way
    toward the fast ones, and the fast weights take the slow ones."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step_count = 0
        self._slow = {}

    @property
    def _parameter_list(self):
        return self.inner_optimizer._parameter_list

    @torch.no_grad()
    def step(self):
        params = self.inner_optimizer._parameter_list or []
        if not self._slow:
            for p in params:
                self._slow[id(p)] = p.detach().clone()
        self.inner_optimizer.step()
        self._step_count += 1
        if self._step_count % self.k == 0:
            for p in params:
                slow = self._slow[id(p)]
                slow = slow + self.alpha * (p - slow)
                self._slow[id(p)] = slow
                p.copy_(slow)

    def clear_grad(self, set_to_zero=False):
        self.inner_optimizer.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def minimize(self, loss, **kwargs):
        loss.backward()
        self.step()
        return None, None

    def state_dict(self):
        return {"slow": dict(self._slow), "step": self._step_count}

    def set_state_dict(self, sd):
        self._slow = dict(sd.get("slow", {}))
        self._step_count = sd.get("step", 0)


class ModelAverage:
    """A running sum of the parameters; ``apply()`` puts their average in
    (keeping the current values for ``restore()``)."""

    def __init__(self, average_window_rate=0.15, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._parameter_list = list(parameters or [])
        self.rate = average_window_rate
        self.min_w = min_average_window
        self.max_w = max_average_window
        self._sum = {id(p): torch.zeros_like(p) for p in self._parameter_list}
        self._count = 0
        self._backup = None

    @torch.no_grad()
    def step(self):
        for p in self._parameter_list:
            self._sum[id(p)] = self._sum[id(p)] + p
        self._count += 1

    def minimize(self, loss, **kwargs):
        self.step()
        return None, None

    @torch.no_grad()
    def apply(self, executor=None, need_restore=True):
        if self._count == 0:
            return
        self._backup = {id(p): p.detach().clone()
                        for p in self._parameter_list}
        for p in self._parameter_list:
            p.copy_((self._sum[id(p)] / self._count).to(p.dtype))

    @torch.no_grad()
    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._parameter_list:
            p.copy_(self._backup[id(p)])
        self._backup = None
