"""Optimizer base (port of paddle_tpu/optimizer/optimizer.py).

The learning rate is an f32 0-d tensor on the parameters' device
(``get_lr``/``set_lr``); an ``LRScheduler`` passed as ``learning_rate``
writes it in place, so a step captured as a CUDA graph reads the current
value at each replay. Parameters moved after construction
(``model.to("cuda")`` keeps the Parameter objects) take the lr tensor
with them at the next ``step()``, which rebinds the scheduler; the first
step of a captured function runs in its discovery pass, before the
capture, so the graph reads the moved tensor. ``parameters`` may be a
list of parameter-group dicts: their ``params`` are flattened, as in the
reference, and a group that sets anything else raises (the reference
stores such keys and never reads them; ROADMAP C-ref-10). So does a
parameter whose ``ParamAttr(learning_rate=r)`` is not 1.0: the reference
stores r in ``optimize_attr`` and no optimizer of it reads it (ROADMAP
C-ref-14).

``step()``:

1. collects the (parameter, grad) pairs of the trainable parameters
   (under ZeRO-1 those this rank owns, ``_owned_ids``);
2. clips them (``grad_clip``, nn/clip.py); a sparse gradient is merged,
   its value block clipped, and rebuilt, so it stays sparse;
3. folds the regularizers into the dense grads (``_apply_decay``): a
   parameter's own ``ParamAttr`` regularizer, else the optimizer's
   ``weight_decay`` (a float is an L2 coefficient, or an
   ``L2Decay``/``L1Decay``; under ``multi_precision`` taken against the
   f32 master);
4. hands each sparse gradient to ``_apply_sparse_update`` (densify and
   update, unless the rule has a row-wise form), and buckets the dense
   pairs by (device, dtype, multi-precision). Each optimizer's rule
   (``_update``) then runs once per bucket as ``torch._foreach_*``
   passes over its lists, with the ops in the order of the reference's
   per-parameter rule, so the roundings are the same. Parameters,
   masters and accumulators are updated in place: a captured step keeps
   its addresses across replays. The updated parameters keep the
   degenerate-weight guard's verdicts (ops/_param_guard.py ``restamp``):
   an optimizer's own update is not a load.

Per-parameter accumulators are created lazily (``_get_accumulator``),
keyed by the parameter; beta powers and bias corrections are f32 0-d
tensors per parameter whatever its dtype. With ``multi_precision`` a
bf16/f16 parameter gets an f32 master weight and f32 moments; the update
runs on the master and the parameter is rewritten from it.
``minimize(loss)`` runs the backward and the step.

``state_dict`` uses the reference's keys (``{name}__{accumulator}``, name
the parameter's ``name`` or ``param_{i}`` by its place in the list, and
``LR_Scheduler``), so either package reads the other's optimizer
checkpoints; ``set_state_dict`` copies into existing tensors in place,
keeping the addresses a captured step holds.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..core import selected_rows as sr
from ..framework.io_utils import tensor_from_numpy
from ..nn.clip import ClipGradBase
from ..ops import _param_guard
from ..regularizer import L2Decay, WeightDecayRegularizer
from .lr import LRScheduler

__all__ = ["Optimizer"]


def _flatten_groups(parameters):
    """The parameter list, with parameter-group dicts flattened."""
    params = list(parameters) if parameters is not None else None
    if not params or not isinstance(params[0], dict):
        return params
    flat = []
    for group in params:
        extra = sorted(set(group) - {"params"})
        if extra:
            raise NotImplementedError(
                f"parameter group options {extra}: the reference stores "
                f"them and never reads them, so the port refuses them "
                f"instead of ignoring them (ROADMAP C-ref-10)")
        flat += list(group["params"])
    return flat


def _refuse_lr_factors(params):
    """Raise for a parameter whose ParamAttr sets a learning-rate factor
    other than 1.0: the reference keeps it in ``optimize_attr`` and none
    of its optimizers reads it, so the port refuses it instead of
    ignoring it (ROADMAP C-ref-14)."""
    for p in params or ():
        r = (getattr(p, "optimize_attr", None) or {}).get("learning_rate",
                                                          1.0)
        if r != 1.0:
            raise NotImplementedError(
                f"parameter {getattr(p, 'name', None)!r} has "
                f"ParamAttr(learning_rate={r}): the reference stores the "
                f"factor and no optimizer reads it, so the port refuses it "
                f"instead of ignoring it (ROADMAP C-ref-14)")


def _as_regularizer(weight_decay):
    """The optimizer-level regularizer: None, a float (an L2 coefficient)
    or an L2Decay/L1Decay; None where it decays nothing."""
    if isinstance(weight_decay, WeightDecayRegularizer):
        return weight_decay if weight_decay.coeff else None
    if weight_decay is None or isinstance(weight_decay, (int, float)):
        return L2Decay(weight_decay) if weight_decay else None
    raise TypeError(f"weight_decay must be a float or an L1Decay/L2Decay, "
                    f"got {type(weight_decay)}")


class _Bucket:
    """Dense (parameter, grad) pairs of one device, dtype and precision
    mode: the lists an optimizer's rule runs over. ``work`` is what the
    rule updates: the f32 masters under multi_precision (the grads cast
    to f32), else the parameters (the grads in their dtype)."""

    __slots__ = ("params", "grads", "masters")

    def __init__(self, params, grads, masters=None):
        self.params, self.grads, self.masters = params, grads, masters

    @property
    def work(self):
        return self.params if self.masters is None else self.masters

    @property
    def dtype(self):
        return self.work[0].dtype


def _one_minus(ts):
    """[1 - t] for 0-d tensors, each rounded once."""
    out = torch._foreach_neg(ts)
    torch._foreach_add_(out, 1.0)
    return out


class Optimizer:
    # optimizers with the flag set it in __init__
    _multi_precision = False
    # ZeRO-1 (distributed/fleet/sharding_optimizer.py): the ids of the
    # parameters this rank updates; None: all of them
    _owned_ids = None

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
        params = _flatten_groups(parameters)
        _refuse_lr_factors(params)
        self._parameter_list = params
        device = params[0].device if params else torch.device("cpu")
        self._learning_rate = torch.tensor(lr0, dtype=torch.float32,
                                           device=device)
        if self._lr_scheduler is not None:
            self._lr_scheduler._bind(self._learning_rate)
        self._regularizer = _as_regularizer(weight_decay)
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

    def _lr_as(self, dtype):
        """The lr tensor in ``dtype`` (itself in f32)."""
        return self._lr if dtype == torch.float32 else self._lr.to(dtype)

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
            if shape is None:
                # the parameter's own layout (channels_last conv weights):
                # lists whose strides differ fall off the multi-tensor
                # kernels onto one launch per tensor
                acc = torch.full_like(param, init, dtype=dtype or param.dtype)
            else:
                acc = torch.full(tuple(shape), init, dtype=dtype
                                 or param.dtype, device=param.device)
            accs[id(param)] = acc
        return acc

    def _accs(self, name, b, init=0.0, shape=None, f32=False):
        """A bucket's accumulators ``name``: f32 where ``f32`` or under
        multi_precision, else in the parameters' dtype."""
        dtype = torch.float32 if f32 or b.masters is not None else None
        return [self._get_accumulator(name, p, init, dtype, shape)
                for p in b.params]

    def _beta_pows(self, name, b):
        """Each parameter's f32 0-d beta power ``name``, from 1."""
        return self._accs(name, b, init=1.0, shape=(), f32=True)

    # -- main entry points ------------------------------------------------------
    def _collect_params_grads(self):
        if self._parameter_list is None:
            raise ValueError(
                "parameters must be passed to the optimizer in eager mode")
        owned = self._owned_ids
        return [(p, p.grad) for p in self._parameter_list
                if p.requires_grad and (owned is None or id(p) in owned)]

    def _clip(self, pairs):
        """The grad clip over the pairs; a sparse gradient is merged, its
        value block (whose norm is the dense gradient's) clipped, and
        rebuilt sparse."""
        merged = {}
        proxied = []
        for i, (p, g) in enumerate(pairs):
            if g.is_sparse:
                merged[i] = g = sr.merge(g)
                g = sr.value(g)
            proxied.append((p, g))
        clipped = list(self._grad_clip(proxied))
        for i, g in merged.items():
            p, v = clipped[i]
            clipped[i] = (p, torch.sparse_coo_tensor(
                g._indices(), v, g.shape, is_coalesced=True))
        return clipped

    def _apply_decay(self, pairs):
        """Regularization folded into the dense grads: a parameter's own
        regularizer (ParamAttr) wins over the optimizer-level one, which
        under multi_precision is taken against the f32 master (a bf16
        decay term can round away entirely). Each regularizer's terms are
        one multi-tensor pass; sparse grads pass undecayed, as in the
        reference. Decoupled decay (AdamW) is part of its rule instead."""
        groups = {}
        for i, (p, g) in enumerate(pairs):
            own = getattr(p, "regularizer", None)
            reg = own or self._regularizer
            if reg is None or g.is_sparse:
                continue
            master = own is None and self._mp_active(p)
            groups.setdefault((id(reg), master), (reg, master, []))[2] \
                .append(i)
        out = list(pairs)
        for reg, master, idx in groups.values():
            ps = [self._get_master(pairs[i][0]) if master else pairs[i][0]
                  for i in idx]
            terms = reg.grad_terms(ps)
            torch._foreach_add_(terms, [pairs[i][1].float() if master
                                        else pairs[i][1] for i in idx])
            for i, t in zip(idx, terms):
                out[i] = (pairs[i][0], t)
        return out

    def _buckets(self, pairs):
        groups = defaultdict(list)
        for p, g in pairs:
            groups[(p.device, p.dtype, self._mp_active(p))].append((p, g))
        out = []
        for (_, dtype, mp), items in groups.items():
            params = [p for p, _ in items]
            if mp:
                out.append(_Bucket(params, [g.float() for _, g in items],
                                   [self._get_master(p) for p in params]))
            else:
                out.append(_Bucket(params, [g.to(dtype) for _, g in items]))
        return out

    @torch.no_grad()
    def step(self):
        self._follow_params_device()
        pairs = [(p, g) for p, g in self._collect_params_grads()
                 if g is not None]
        guarded = _param_guard.fresh(p for p, _ in pairs)
        if self._grad_clip is not None:
            pairs = self._clip(pairs)
        dense = []
        for p, g in self._apply_decay(pairs):
            if g.is_sparse:
                self._apply_sparse_update(p, g)
            else:
                dense.append((p, g))
        for b in self._buckets(dense):
            self._update(b)
        _param_guard.restamp(guarded)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """The backward of ``loss`` and one ``step()``; returns (None, None)
        as the reference's eager path does."""
        loss.backward()
        self.step()
        return None, None

    def _update(self, b):
        """The optimizer's rule over one bucket."""
        raise NotImplementedError

    def _apply_sparse_update(self, p, g):
        """A sparse gradient. Default: densify (right for every rule);
        rules with a row-wise form (SGD, Adam's lazy_mode) override."""
        for b in self._buckets([(p, sr.to_dense(g))]):
            self._update(b)

    @staticmethod
    def _store(b):
        """Round the masters into the parameters (multi_precision)."""
        if b.masters is not None:
            torch._foreach_copy_(b.params, b.masters)

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
