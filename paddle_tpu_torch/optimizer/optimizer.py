"""Optimizer base (port of paddle_tpu/optimizer/optimizer.py).

The learning rate is an f32 0-d tensor on the parameters' device
(``get_lr``/``set_lr``), so a captured step (a CUDA graph, in a later
slice) reads the current value. Per-parameter accumulators are created
lazily (``_get_accumulator``), keyed by the parameter. With
``multi_precision`` a bf16/f16 parameter gets an f32 master weight and f32
moments; the update runs on the master and the parameter is rewritten
from it. ``step()`` updates the parameters in place under no_grad, so the
model keeps its Parameter objects.

Not on the slice's path, and raising NotImplementedError until a later
slice brings them (ROADMAP A2): learning-rate schedulers
(``optimizer/lr.py``), ``grad_clip`` (``nn/clip.py``), sparse gradients
and ``state_dict``/``set_state_dict``. Parameter groups, per-parameter
regularizers and ``minimize`` are not ported yet either.
"""
from __future__ import annotations

from collections import defaultdict

import torch

__all__ = ["Optimizer"]

_LATER = "comes with a later slice of the port (ROADMAP A2)"


class Optimizer:
    # optimizers with the flag set it in __init__
    _multi_precision = False

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"learning-rate schedulers (optimizer/lr.py): {_LATER}")
        if grad_clip is not None:
            raise NotImplementedError(f"grad_clip (nn/clip.py): {_LATER}")
        params = list(parameters) if parameters is not None else None
        self._parameter_list = params
        device = params[0].device if params else torch.device("cpu")
        self._learning_rate = torch.tensor(float(learning_rate),
                                           dtype=torch.float32, device=device)
        self._weight_decay = weight_decay
        self._accumulators = defaultdict(dict)  # name -> {id(param): tensor}

    # -- lr ----------------------------------------------------------------
    def set_lr(self, value):
        self._learning_rate.fill_(float(value))

    def get_lr(self):
        return float(self._learning_rate)

    @property
    def _lr(self):
        return self._learning_rate

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
        return mw

    def _get_accumulator(self, name, param, init=0.0, dtype=None,
                         shape=None):
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
        for p, g in self._apply_decay(self._collect_params_grads()):
            if g is None:
                continue
            if g.is_sparse:
                raise NotImplementedError(f"sparse gradients: {_LATER}")
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

    def state_dict(self):
        raise NotImplementedError(f"optimizer state_dict: {_LATER}")

    def set_state_dict(self, state_dict):
        raise NotImplementedError(f"optimizer set_state_dict: {_LATER}")
