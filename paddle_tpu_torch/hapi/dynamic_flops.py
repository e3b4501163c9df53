"""paddle.flops (port of paddle_tpu/hapi/dynamic_flops.py): the FLOPs of
one forward pass of zeros, counted per leaf layer by forward hooks under
the reference's rules (a multiply-add counts 2)."""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import get_default_dtype
from ..nn.layer import common as C
from ..nn.layer import conv as CONV
from ..nn.layer import norm as NORM
from ..nn.layer import pooling as POOL

__all__ = ["flops"]


def _out(outs):
    return outs if isinstance(outs, torch.Tensor) else outs[0]


def _conv_flops(layer, ins, outs):
    out_elems = _out(outs).numel()
    kernel = int(np.prod(layer._kernel_size))
    cin = layer._in_channels // layer._groups
    f = out_elems * (kernel * cin * 2)
    if layer.bias is not None:
        f += out_elems
    return f


def _linear_flops(layer, ins, outs):
    return _out(outs).numel() * layer._in_features * 2


def _norm_flops(layer, ins, outs):
    return ins[0].numel() * 2


def _pool_flops(layer, ins, outs):
    return _out(outs).numel()


_RULES = [
    (CONV.Conv2D, _conv_flops),
    (C.Linear, _linear_flops),
    (NORM._BatchNormBase, _norm_flops),
    (NORM.LayerNorm, _norm_flops),
    (POOL._PoolNd, _pool_flops),
]


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The FLOPs of ``net`` on zeros of ``input_size`` (the default dtype,
    on the network's device); ``custom_ops`` maps a layer type to its own
    rule."""
    total = [0]
    hooks = []
    custom_ops = custom_ops or {}

    def hook(layer, ins, outs):
        fn = custom_ops.get(type(layer))
        if fn is None:
            for klass, rule in _RULES:
                if isinstance(layer, klass):
                    fn = rule
                    break
        if fn is not None:
            n = fn(layer, ins, outs)
            total[0] += n
            if print_detail:
                print(f"{type(layer).__name__}: {n:,} FLOPs")

    for name, layer in net.named_modules():
        if name and not any(True for _ in layer.children()):
            hooks.append(layer.register_forward_hook(hook))
    device = next((p.device for p in net.parameters()), torch.device("cpu"))
    x = torch.zeros(tuple(input_size), dtype=get_default_dtype(),
                    device=device)
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(x)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()
    return total[0]
