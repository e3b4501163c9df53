"""Layer: paddle's base layer as a torch.nn.Module.

Port of paddle_tpu/nn/layer/layers.py. A layer knows the device (default:
the current device, cuda:0 unless ``set_device`` named another; resolved
when the layer first needs it, so a layer without parameters needs no
card), the dtype (default ``get_default_dtype()``) and the generator its
parameters are created with. Besides torch's own API (state_dict,
named_parameters, eval, bfloat16, forward pre-hooks) it has the
reference's: ``create_parameter`` (a ``ParamAttr``'s initializer, else
``set_global_initializer``'s, else the layer's default), ``full_name``,
``sublayers``/``named_sublayers`` in the reference's order,
``add_sublayer``, ``add_parameter``, ``create_tensor``,
``register_forward_post_hook``, ``clear_gradients``, ``astype``, ``to``
with paddle's dtype names, and ``set_state_dict``/``load_dict``.
Parameter names follow the attribute names, as in the reference, so state
dicts cross unchanged.

Loading writes into the existing parameters in place (their objects,
addresses and memory format stay, so captured steps and optimizer state
keep pointing at them), and every load, torch's ``load_state_dict``
included, makes the fused ops' degenerate-weight guard check the loaded
parameters again (ops/_param_guard.py).
"""
from __future__ import annotations

import torch

from ...core.device import resolve_device
from ...core.dtypes import convert_dtype, get_default_dtype
from ...framework.io_utils import load_numpy_state_dict
from ...framework.param_attr import ParamAttr, Parameter
from ...ops import _param_guard
from .. import initializer as I

__all__ = ["Layer"]


def _recheck_after_load(module, incompatible_keys):
    """torch's load_state_dict post-hook: the loaded parameters' guard
    verdicts are checked again."""
    for p in module.parameters(recurse=False):
        _param_guard.recheck(p)


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype=None, *, device=None,
                 generator=None):
        super().__init__()
        self._device_arg = device
        self._device_resolved = None
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        self._generator = generator
        self._full_name = name_scope or type(self).__name__.lower()
        self.register_load_state_dict_post_hook(_recheck_after_load)

    @property
    def _device(self):
        if self._device_resolved is None:
            self._device_resolved = resolve_device(self._device_arg)
        return self._device_resolved

    def factory_kwargs(self):
        """The (device, dtype, generator) to build sublayers with."""
        return {"device": self._device, "dtype": self._dtype,
                "generator": self._generator}

    def full_name(self):
        """``name_scope`` as given, else the class name in lower case."""
        return self._full_name

    # -- construction helpers -------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """``attr`` is None, False (no parameter: returns None), a name, an
        Initializer or a ParamAttr. The attribute's initializer wins, then
        the one ``set_global_initializer`` installed, then
        ``default_initializer``; without any, biases start at 0 and
        weights XavierNormal. Draws come from the layer's generator. The
        Parameter carries the attribute's ``name``, ``trainable`` (as
        ``requires_grad``), ``optimize_attr``, ``regularizer`` and
        ``need_clip``, which the optimizer and the grad clips read."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = (attr.initializer or I._global_initializer(is_bias)
                or default_initializer)
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        value = init(shape, convert_dtype(dtype) or self._dtype,
                     self._device, self._generator)
        p = Parameter(value, requires_grad=attr.trainable)
        p.name = attr.name
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None):
        """A 0-d zero tensor in ``dtype`` (default: the layer's) on the
        layer's device. torch tensors have no settable name, so ``name``
        is not kept."""
        return torch.zeros((), dtype=convert_dtype(dtype) or self._dtype,
                           device=self._device)

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    # -- traversal ------------------------------------------------------------
    def sublayers(self, include_self=False):
        """Every sublayer, each once, depth first with a layer before its
        children (the reference's order)."""
        return [layer for _, layer in
                self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """(dotted name, layer) pairs, depth first, each layer once."""
        if layers_set is None:
            layers_set = set()
        if include_self and id(self) not in layers_set:
            layers_set.add(id(self))
            yield prefix, self
        for name, layer in self._modules.items():
            if layer is None or id(layer) in layers_set:
                continue
            path = prefix + ("." if prefix else "") + name
            layers_set.add(id(layer))
            yield path, layer
            if isinstance(layer, Layer):
                yield from layer.named_sublayers(path, False, layers_set)
            else:
                for sub, m in layer.named_modules(prefix=path):
                    if sub != path and id(m) not in layers_set:
                        layers_set.add(id(m))
                        yield sub, m

    # -- hooks and gradients --------------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, input, output)`` after each forward; a non-None
        return replaces the output. Returns a handle with ``remove()``."""
        return self.register_forward_hook(hook)

    def clear_gradients(self):
        """Drop every parameter's gradient (``p.grad = None``)."""
        for p in self.parameters():
            p.grad = None

    # -- state dict -----------------------------------------------------------
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict`` ({structured name: tensor or array}) into
        the layer's parameters and persistent buffers in place, cast to
        each one's dtype and device. Returns (missing, unexpected): the
        layer's names the dict lacks (parameters first, then buffers, in
        the reference's order) and the dict's names the layer lacks. A
        shape mismatch raises. ``use_structured_name=False`` (keys that
        are parameter names) raises: the reference never reads it."""
        if not use_structured_name:
            raise NotImplementedError(
                "set_state_dict(use_structured_name=False): the reference "
                "never reads the flag and loads by structured name")
        own = self.state_dict()
        params = [n for n, _ in self.named_parameters() if n in own]
        order = params + [n for n in own if n not in set(params)]
        missing = [n for n in order if n not in state_dict]
        unexpected = [n for n in state_dict if n not in own]
        load_numpy_state_dict(self, {k: v for k, v in state_dict.items()
                                     if k in own}, strict=False)
        return missing, unexpected

    load_dict = set_state_dict

    # -- dtype and place ------------------------------------------------------
    def to(self, device=None, dtype=None, blocking=None, *args, **kwargs):
        """paddle's ``to(device, dtype, blocking)``: ``device`` a Place, a
        string ("cpu", "gpu:0", "cuda:0") or a torch.device; ``dtype`` a
        paddle dtype name or a torch dtype (only floating parameters and
        buffers are cast). torch's forms (``to(dtype)``, ``to(tensor)``,
        ``non_blocking=``, ``memory_format=``) pass through. Parameter
        objects are kept. Every sublayer takes the new device and dtype
        for what it creates later."""
        if isinstance(device, torch.dtype):
            device, dtype = None, device
        if dtype is not None and not isinstance(dtype, torch.dtype):
            dtype = convert_dtype(dtype)
        if device is not None and not isinstance(device, torch.Tensor):
            device = resolve_device(device)
        if blocking is not None:
            kwargs.setdefault("non_blocking", not blocking)
        lead = [device] if device is not None else []
        if dtype is not None:
            kwargs["dtype"] = dtype
        out = super().to(*lead, *args, **kwargs)
        for layer in self.modules():
            if isinstance(layer, Layer):
                if isinstance(device, torch.device):
                    layer._device_resolved = device
                if dtype is not None and dtype.is_floating_point:
                    layer._dtype = dtype
        return out

    def astype(self, dtype):
        return self.to(dtype=dtype)
