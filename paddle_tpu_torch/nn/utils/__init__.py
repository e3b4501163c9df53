"""paddle.nn.utils: weight_norm, remove_weight_norm and spectral_norm
(port of paddle_tpu/nn/utils/__init__.py), as forward pre-hooks that
recompute a layer's weight before every forward.

``weight_norm`` replaces the parameter ``<name>`` by ``<name>_g`` (the
norm of each slice along ``dim``, or of the whole tensor for dim=None)
and ``<name>_v`` (the direction), so the weight is g * v / max(||v||,
1e-12); ``remove_weight_norm`` folds them back into ``<name>``.
``spectral_norm`` puts a SpectralNorm sublayer ``<name>_spectral_norm``
(with its ``weight_u``, ``weight_v``) in front of the weight. The
reference then drops the weight from the layer's parameters (its
``setattr`` of the normalised tensor removes it), so an optimizer built
from ``layer.parameters()`` never trains it; the port keeps it as the
parameter ``<name>_orig`` instead (ROADMAP C-ref-18).
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast
from ...framework.param_attr import Parameter

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm"]


def _norm_except(w, dim):
    if dim is None:
        return torch.sqrt(torch.sum(w * w))
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt(torch.sum(w * w, dim=axes, keepdim=True))


def _weight(g, v, dim):
    g, v = amp_cast("weight_norm", g, v)
    return g * v / torch.clamp(_norm_except(v, dim), min=1e-12)


def weight_norm(layer, name="weight", dim=0):
    """Reparameterise ``layer.<name>`` as g * v / ||v||."""
    w = getattr(layer, name)
    with torch.no_grad():
        g = Parameter(_norm_except(w.detach(), dim).clone())
        v = Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.add_parameter(name + "_g", g)
    layer.add_parameter(name + "_v", v)

    def pre_hook(lyr, inputs):
        setattr(lyr, name, _weight(g, v, dim))

    handle = layer.register_forward_pre_hook(pre_hook)
    layer._weight_norm_state = (name, dim, handle)
    setattr(layer, name, _weight(g, v, dim))
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``<name>_g`` and ``<name>_v`` back into the parameter
    ``<name>`` and drop the hook."""
    state = getattr(layer, "_weight_norm_state", None)
    if state is None:
        return layer
    _, dim, handle = state
    handle.remove()
    g = layer._parameters.pop(name + "_g")
    v = layer._parameters.pop(name + "_v")
    with torch.no_grad():
        w = (g.double() * v.double()
             / torch.clamp(_norm_except(v.double(), dim), min=1e-12))
    layer.__dict__.pop(name, None)
    layer.add_parameter(name, Parameter(w.to(v.dtype)))
    del layer._weight_norm_state
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=None):
    """``layer.<name>`` divided by its largest singular value before every
    forward (SpectralNorm along ``dim``, default 0)."""
    from ..layer.norm import SpectralNorm

    w = layer._parameters.pop(name)
    sn = SpectralNorm(list(w.shape), dim=0 if dim is None else dim,
                      power_iters=n_power_iterations, eps=eps,
                      device=w.device)
    layer.add_sublayer(name + "_spectral_norm", sn)
    layer.add_parameter(name + "_orig", w)

    def pre_hook(lyr, inputs):
        setattr(lyr, name, sn(w))

    layer.register_forward_pre_hook(pre_hook)
    setattr(layer, name, sn(w))
    return layer
