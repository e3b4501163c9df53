"""Optimizer base (port of paddle_tpu/optimizer/optimizer.py).

The learning rate is an f32 0-d tensor on the parameters' device
(``get_lr``/``set_lr``); an ``LRScheduler`` passed as ``learning_rate``
writes it in place, so a step captured as a CUDA graph reads the current
value at each replay. Parameters moved after construction
(``model.to("cuda")`` keeps the Parameter objects) take the lr tensor
with them at the next ``step()``, which rebinds the scheduler; the first
step of a captured function runs in its discovery pass, before the
capture, so the graph reads the moved tensor. Per-parameter accumulators are created lazily
(``_get_accumulator``), keyed by the parameter. With ``multi_precision`` a
bf16/f16 parameter gets an f32 master weight and f32 moments; the update
runs on the master and the parameter is rewritten from it. ``step()``
clips the grads (``grad_clip``, nn/clip.py), folds in the L2
``weight_decay`` and updates the parameters in place under no_grad, so
the model keeps its Parameter objects.

``state_dict`` uses the reference's keys (``{name}__{accumulator}``, name
the parameter's ``name`` or ``param_{i}`` by its place in the list, and
``LR_Scheduler``), so either package reads the other's optimizer
checkpoints; ``set_state_dict`` copies into existing tensors in place,
keeping the addresses a captured step holds. Sparse gradients raise
NotImplementedError until a later slice brings them (ROADMAP A2);
parameter groups, per-parameter regularizers and ``minimize`` are not
ported yet either.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..framework.io_utils import tensor_from_numpy
from ..nn.clip import ClipGradBase
from .lr import LRScheduler

__all__ = ["Optimizer"]

_LATER = "comes with a later slice of the port (ROADMAP A2)"


class Optimizer:
    # optimizers with the flag set it in __init__
    _multi_precision = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr_scheduler = None
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            lr0 = float(learning_rate())
        elif isinstance(learning_rate, (int, float)):
            lr0 = float(learning_rate)
        else:
            raise TypeError(f"learning_rate must be a number or an "
                            f"LRScheduler, got {type(learning_rate)}")
        if grad_clip is not None and not isinstance(grad_clip, ClipGradBase):
            raise TypeError(f"grad_clip must be a ClipGradBy* instance, got "
                            f"{type(grad_clip)}")
        params = list(parameters) if parameters is not None else None
        self._parameter_list = params
        device = params[0].device if params else torch.device("cpu")
        self._learning_rate = torch.tensor(lr0, dtype=torch.float32,
                                           device=device)
        if self._lr_scheduler is not None:
            self._lr_scheduler._bind(self._learning_rate)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators = defaultdict(dict)  # name -> {id(param): tensor}
        self._acc_inits = {}                    # name -> initial value

    # -- lr ----------------------------------------------------------------
    def set_lr(self, value):
        self._learning_rate.fill_(float(value))

    def get_lr(self):
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return float(self._learning_rate)

    @property
    def _lr(self):
        return self._learning_rate

    def _follow_params_device(self):
        """Move the lr tensor to the parameters' device when they moved,
        and rebind the scheduler to the moved tensor. Parameters on more
        than one device raise."""
        devices = {p.device for p in self._parameter_list or ()}
        if len(devices) > 1:
            raise ValueError(
                f"the optimizer's parameters lie on more than one device "
                f"({sorted(map(str, devices))}); one learning-rate tensor "
                f"cannot serve them")
        if devices and self._learning_rate.device not in devices:
            self._learning_rate = self._learning_rate.to(devices.pop())
            if self._lr_scheduler is not None:
                self._lr_scheduler._bind(self._learning_rate)

    # -- accumulators and masters ---------------------------------------------
    def _mp_active(self, p):
        return self._multi_precision and p.dtype in (torch.bfloat16,
                                                     torch.float16)

    def _get_master(self, p):
        """The f32 master of a bf16/f16 parameter, made from it at first
        use."""
        accs = self._accumulators["master_weight"]
        mw = accs.get(id(p))
        if mw is None:
            mw = p.detach().to(torch.float32, copy=True)
            accs[id(p)] = mw
            self._acc_inits["master_weight"] = 0.0
        return mw

    def _get_accumulator(self, name, param, init=0.0, dtype=None,
                         shape=None):
        self._acc_inits[name] = init
        accs = self._accumulators[name]
        acc = accs.get(id(param))
        if acc is None:
            shp = tuple(shape) if shape is not None else tuple(param.shape)
            acc = torch.full(shp, init, dtype=dtype or param.dtype,
                             device=param.device)
            accs[id(param)] = acc
        return acc

    # -- main entry points ------------------------------------------------------
    def _collect_params_grads(self):
        if self._parameter_list is None:
            raise ValueError(
                "parameters must be passed to the optimizer in eager mode")
        return [(p, p.grad) for p in self._parameter_list if p.requires_grad]

    def _apply_decay(self, params_grads):
        """L2 regularization folded into the grads (the optimizer-level
        ``weight_decay`` coefficient). Decoupled decay (AdamW) overrides
        ``_apply_update`` instead."""
        coeff = float(self._weight_decay or 0.0)
        if not coeff:
            return params_grads
        out = []
        for p, g in params_grads:
            if g is not None:
                if self._mp_active(p):
                    # f32 decay against the master: a bf16 decay term can
                    # round away entirely
                    g = g.float() + coeff * self._get_master(p)
                else:
                    g = g + coeff * p
            out.append((p, g))
        return out

    @torch.no_grad()
    def step(self):
        self._follow_params_device()
        pairs = self._collect_params_grads()
        if any(g is not None and g.is_sparse for _, g in pairs):
            raise NotImplementedError(f"sparse gradients: {_LATER}")
        if self._grad_clip is not None:
            pairs = self._grad_clip(pairs)
        for p, g in self._apply_decay(pairs):
            if g is not None:
                self._apply_update(p, g)

    def _apply_update(self, param, grad):
        raise NotImplementedError

    def _write(self, p, master, new_w):
        """Store an update: into the master and then the parameter (rounded
        to its dtype) with multi_precision, else into the parameter."""
        if master is not None:
            master.copy_(new_w)
        p.copy_(new_w)

    def clear_grad(self, set_to_zero=False):
        """Drop the gradients (``p.grad = None``), or zero them in place
        with ``set_to_zero=True``."""
        for p in self._parameter_list or ():
            if set_to_zero:
                if p.grad is not None:
                    p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict -------------------------------------------------------------
    def _param_names(self):
        return [getattr(p, "name", None) or f"param_{i}"
                for i, p in enumerate(self._parameter_list or [])]

    def state_dict(self):
        """{"{param}__{accumulator}": tensor, ..., "LR_Scheduler": dict}:
        the live tensors, as the reference returns its own."""
        by_id = {id(p): n for p, n in zip(self._parameter_list or [],
                                          self._param_names())}
        sd = {f"{by_id.get(pid, pid)}__{acc_name}": t
              for acc_name, accs in self._accumulators.items()
              for pid, t in accs.items()}
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Load tensors or arrays by the reference's keys: into existing
        accumulators in place, or as new ones on the parameter's device
        with the stored dtype. Unknown parameters are skipped."""
        by_name = dict(zip(self._param_names(), self._parameter_list or []))
        for key, val in state_dict.items():
            if key == "LR_Scheduler":
                if self._lr_scheduler is not None:
                    self._lr_scheduler.set_state_dict(val)
                continue
            if "__" not in key:
                continue
            pname, acc_name = key.rsplit("__", 1)
            p = by_name.get(pname)
            if p is None:
                continue
            if not isinstance(val, torch.Tensor):
                val = tensor_from_numpy(np.asarray(val))
            accs = self._accumulators[acc_name]
            acc = accs.get(id(p))
            if acc is None:
                accs[id(p)] = val.to(p.device, copy=True)
                self._acc_inits.setdefault(acc_name, 0.0)
            else:
                # paddle stores a 0-d accumulator as shape [1]
                acc.copy_(val.reshape(acc.shape))

    set_dict = set_state_dict
