"""conv2d (port of paddle_tpu/nn/functional/conv.py).

The convolution itself is ``torch.nn.functional.conv2d`` (cuDNN on the
card), as the reference leaves it to XLA's ``conv_general_dilated``.
Weights are OIHW in both layouts, as in the reference and in torch.

- ``data_format="NHWC"``: the input is viewed as NCHW with
  ``x.permute(0, 3, 1, 2)``, which has channels_last strides, so cuDNN
  runs its NHWC kernels and writes a channels_last output, viewed back as
  NHWC. No layer makes a transposing copy of an activation. The weight is
  taken in channels_last memory format (``Conv2D`` keeps its parameter
  so, where this is free).
- Padding: an int, a pair, [lo, hi] pairs per axis (the reference's
  asymmetric form), or "SAME" / "VALID". "SAME" pads as lax does, the odd
  pad at the end, at any stride (``torch.conv2d(padding="same")`` refuses
  stride > 1). Padding torch cannot express (asymmetric pairs) is applied
  with ``pad`` first.
"""
from __future__ import annotations

import numpy as np
import torch

from ...amp.auto_cast import amp_cast
from .common import pad as _pad

__all__ = ["conv2d"]


def _norm_tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


def _norm_padding(padding, n, stride, dilation, kernel):
    """The reference's padding forms as "SAME", "VALID" or [(lo, hi)] * n."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    # nested [[lo, hi], ...], possibly with the batch and channel axes
    pairs = [tuple(int(x) for x in p) for p in padding]
    if len(pairs) == n + 2:
        pairs = pairs[2:]
    return pairs


def _explicit_pads(pad, in_sizes, window, stride, dilation=None):
    """[(lo, hi)] per spatial axis for a ``_norm_padding`` result: "VALID"
    pads nothing and "SAME" as lax.padtype_to_pads does, out = ceil(in /
    stride) with the odd pad at the end; ``window`` is the kernel size,
    dilated by ``dilation``."""
    if not isinstance(pad, str):
        return [tuple(p) for p in pad]
    if pad == "VALID":
        return [(0, 0)] * len(in_sizes)
    if pad != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {pad!r}")
    dilation = dilation or (1,) * len(in_sizes)
    pairs = []
    for size, k, s, d in zip(in_sizes, window, stride, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def _split_pads(pairs):
    """(pads torch's op takes as symmetric padding, the [lo, hi] list to
    ``pad`` the input with first, or None)."""
    if all(lo == hi for lo, hi in pairs):
        return tuple(lo for lo, _ in pairs), None
    return (0,) * len(pairs), [p for lo_hi in pairs for p in lo_hi]


def nchw_view(x, data_format):
    """``x`` as an NCHW-shaped tensor: NHWC input is permuted as a view
    (channels_last strides)."""
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def from_nchw_view(y, data_format):
    return y.permute(0, 2, 3, 1) if data_format == "NHWC" else y


def conv_args(x_nchw, weight, stride, padding, dilation):
    """Normalized (stride, symmetric padding, pre-pad list or None,
    dilation) for a conv of the NCHW-shaped ``x_nchw`` by OIHW
    ``weight``."""
    stride = _norm_tuple(stride, 2)
    dilation = _norm_tuple(dilation, 2)
    pairs = _explicit_pads(_norm_padding(padding, 2, stride, dilation, None),
                           x_nchw.shape[2:], weight.shape[2:], stride,
                           dilation)
    sym, pre = _split_pads(pairs)
    return stride, sym, pre, dilation


def conv2d_nchw(x, weight, bias, stride, sym, pre, dilation, groups,
                channels_last):
    """The cuDNN convolution of an NCHW-shaped input, padded first where
    the padding is asymmetric; ``channels_last`` takes the weight in that
    memory format, so cuDNN runs its NHWC kernels."""
    if pre is not None:
        # [lo_h, hi_h, lo_w, hi_w] -> pad's last-axis-first order
        x = _pad(x, [pre[2], pre[3], pre[0], pre[1]])
    if channels_last:
        weight = weight.contiguous(memory_format=torch.channels_last)
    return torch.nn.functional.conv2d(x, weight, bias, stride, sym, dilation,
                                      groups)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """x: (N, C, H, W), or (N, H, W, C) under NHWC; weight (O, C/groups,
    kh, kw); bias (O,) or None."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be 'NCHW' or 'NHWC', got "
                         f"{data_format!r}")
    x, weight, bias = amp_cast("conv2d", x, weight, bias)
    xc = nchw_view(x, data_format)
    stride, sym, pre, dilation = conv_args(xc, weight, stride, padding,
                                           dilation)
    out = conv2d_nchw(xc, weight, bias, stride, sym, pre, dilation, groups,
                      data_format == "NHWC")
    return from_nchw_view(out, data_format)
