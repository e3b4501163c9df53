"""paddle.summary (port of paddle_tpu/hapi/model_summary.py): a forward
pass of zeros through the network, with hooks on its leaf layers, prints
each leaf's output shape and parameter count and returns the totals."""
from __future__ import annotations

import torch

from ..core.dtypes import convert_dtype, get_default_dtype

__all__ = ["summary"]


def _device_of(net):
    for t in net.parameters():
        return t.device
    return torch.device("cpu")


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    """Print a table of ``net``'s leaf layers and return
    ``{"total_params", "trainable_params"}``. The input is ``input`` or
    zeros of ``input_size`` (one shape, or a list of shapes) and
    ``dtypes`` (default: the default dtype) on the network's device."""
    entries = []
    hooks = []

    def make_hook(name):
        def hook(layer, ins, outs):
            params = sum(p.numel() for p in layer._parameters.values()
                         if p is not None)
            out0 = outs[0] if isinstance(outs, (list, tuple)) else outs
            shape = list(out0.shape) if isinstance(out0, torch.Tensor) \
                else None
            entries.append((name, type(layer).__name__, shape, params))
        return hook

    for name, layer in net.named_modules():
        if name and not any(True for _ in layer.children()):  # leaves
            hooks.append(layer.register_forward_hook(make_hook(name)))

    if input is not None:
        x = input if isinstance(input, (list, tuple)) else [input]
    else:
        if isinstance(input_size, (tuple, list)) and input_size and \
                isinstance(input_size[0], (tuple, list)):
            sizes = list(input_size)
        else:
            sizes = [input_size]
        dts = dtypes if isinstance(dtypes, (list, tuple)) else \
            [dtypes] * len(sizes)
        device = _device_of(net)
        x = [torch.zeros(tuple(s),
                         dtype=convert_dtype(dt) or get_default_dtype(),
                         device=device) for s, dt in zip(sizes, dts)]
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*x)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    total = sum(p.numel() for p in net.parameters())
    trainable = sum(p.numel() for p in net.parameters() if p.requires_grad)
    header = f"{'Layer':<40}{'Type':<22}{'Output Shape':<22}{'Params':>12}"
    lines = [header, "-" * len(header)]
    for name, tname, shape, params in entries:
        lines.append(f"{name:<40}{tname:<22}{str(shape):<22}{params:>12,}")
    lines.append("-" * len(header))
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    lines.append(f"Non-trainable params: {total - trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}
