"""paddle.optimizer: SGD, Momentum, Adam and AdamW, and the schedulers in
``optimizer.lr``.

Port of paddle_tpu/optimizer/__init__.py with the reference's update rules
(operators/optimizers/*_op.h): Adam's bias correction folded into the
step, lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t) and
eps_t = eps * sqrt(1 - beta2^t), with f32 beta powers for every parameter
dtype; AdamW's decoupled decay applied to the weight (the master, with
multi_precision) before the Adam update. torch.optim is not used: it has
no master weights and places epsilon differently, which rounds otherwise.
The other optimizers of the reference (Adagrad, Adadelta, Adamax,
RMSProp, Lamb, Lars, Ftrl) and sparse updates come with a later slice.
"""
from __future__ import annotations

import torch

from . import lr
from .optimizer import Optimizer

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "lr"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _apply_update(self, p, g):
        p.copy_(p - self._lr.to(p.dtype) * g.to(p.dtype))


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._multi_precision = multi_precision

    def _apply_update(self, p, g):
        mp = self._mp_active(p)
        vel = self._get_accumulator("velocity", p,
                                    dtype=torch.float32 if mp else None)
        master = self._get_master(p) if mp else None
        work = master if mp else p
        g = g.to(work.dtype)
        lr_ = self._lr.to(work.dtype)
        v_new = self._momentum * vel + g
        vel.copy_(v_new)
        if self._use_nesterov:
            new_w = work - lr_ * (g + self._momentum * v_new)
        else:
            new_w = work - lr_ * v_new
        self._write(p, master, new_w)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._multi_precision = multi_precision

    def _apply_update(self, p, g):
        mp = self._mp_active(p)
        acc_dtype = torch.float32 if mp else None
        m = self._get_accumulator("moment1", p, dtype=acc_dtype)
        v = self._get_accumulator("moment2", p, dtype=acc_dtype)
        # beta powers and the bias correction stay f32 for every parameter
        # dtype: bf16 rounds beta2 = 0.999 to 1.0 and 1 - beta2^t to 0
        b1p = self._get_accumulator("beta1_pow", p, init=1.0, shape=(),
                                    dtype=torch.float32)
        b2p = self._get_accumulator("beta2_pow", p, init=1.0, shape=(),
                                    dtype=torch.float32)
        master = self._get_master(p) if mp else None
        work = master if mp else p
        dtype = work.dtype
        g = g.to(dtype)
        b1, b2 = self._beta1, self._beta2
        b1p.mul_(b1)
        b2p.mul_(b2)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        lr_t = (self._lr * torch.sqrt(1 - b2p) / (1 - b1p)).to(dtype)
        eps_t = (self._epsilon * torch.sqrt(1 - b2p)).to(dtype)
        self._write(p, master, work - lr_t * (m / (torch.sqrt(v) + eps_t)))


class AdamW(Adam):
    """Decoupled weight decay: the weight (the f32 master with
    multi_precision) is scaled by 1 - lr * coeff before the Adam update,
    for the parameters ``apply_decay_param_fun(name)`` selects (all when it
    is None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                "AdamW lr_ratio comes with a later slice of the port")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode=lazy_mode,
                         multi_precision=multi_precision)
        self._coeff = float(weight_decay) if weight_decay is not None \
            else 0.0
        self._apply_decay_param_fun = apply_decay_param_fun

    def _apply_update(self, p, g):
        if self._coeff and (self._apply_decay_param_fun is None
                            or self._apply_decay_param_fun(
                                getattr(p, "name", None))):
            if self._mp_active(p):
                mw = self._get_master(p)
                mw.copy_(mw * (1.0 - self._lr * self._coeff))
            else:
                p.copy_(p * (1.0 - self._lr.to(p.dtype) * self._coeff))
        super()._apply_update(p, g)
