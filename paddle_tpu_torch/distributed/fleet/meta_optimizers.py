"""Strategy-driven optimizer behaviour (port of
paddle_tpu/distributed/fleet/meta_optimizers.py): gradient merge.

``GradientMergeOptimizer`` accumulates the gradients of ``k_steps``
backward passes and applies them in one step (their mean with ``avg``).
A standard ``backward / step / clear_grad`` loop works unchanged: the
first k - 1 ``step()`` calls of each window do nothing, and the
``clear_grad()`` calls after them are suppressed so the gradients keep
accumulating. A sparse gradient (core/selected_rows.py) is scaled in its
value block and stays sparse.

The reference leaves DGC and LocalSGD out (they trade convergence for
interconnect bandwidth); so does the port.
"""
from __future__ import annotations

import torch

from ...core import selected_rows as sr

__all__ = ["GradientMergeOptimizer"]


class GradientMergeOptimizer:
    def __init__(self, optimizer, k_steps=1, avg=True):
        self._inner = optimizer
        self._k = max(int(k_steps), 1)
        self._avg = avg
        self._count = 0
        self._applied = True  # a clear_grad before any step is honoured

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner_opt(self):
        return self._inner

    @torch.no_grad()
    def step(self):
        self._count += 1
        if self._count % self._k:
            self._applied = False
            return
        if self._avg and self._k > 1:
            for p, g in self._inner._collect_params_grads():
                if g is None:
                    continue
                if g.is_sparse:
                    p.grad = sr.make(sr.rows(g), sr.value(g) / self._k,
                                     sr.height(g))
                else:
                    g.div_(self._k)
        self._inner.step()
        self._applied = True

    def clear_grad(self, *a, **kw):
        if self._applied:
            self._inner.clear_grad(*a, **kw)

    clear_gradients = clear_grad

    def minimize(self, loss, **kw):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None
