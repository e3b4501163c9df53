"""max_pool2d, avg_pool2d and adaptive_avg_pool2d (port of
paddle_tpu/nn/functional/pooling.py), in NCHW and NHWC.

NHWC input is viewed as NCHW with channels_last strides
(``conv.nchw_view``), as conv2d does; the pooling is torch's. The
reference's semantics:

- padding: an int, a pair, [lo, hi] pairs, "SAME" or "VALID" (SAME as
  lax pads it, the odd pad at the end). Max pooling pads with -inf.
- ``avg_pool2d(exclusive=True)`` divides each window by the count of its
  elements inside the input where explicit padding is nonzero; under
  "SAME" the reference divides by the whole window, and so does the port.
  A padded average pool pads explicitly and counts with a pooled tensor
  of ones, since torch's count_include_pad=False backward is wrong on
  channels_last CUDA tensors.
- ``adaptive_avg_pool2d``: window j of n over a length L spans [floor(j L
  / n), ceil((j + 1) L / n)), the reference's rule and torch's.
- ``ceil_mode=True`` raises: the reference accepts it but never applies
  it (ROADMAP C-ref-4), so the port matches it only for False.
"""
from __future__ import annotations

import math

import torch

from ...amp.auto_cast import amp_cast
from .common import pad as _pad
from .conv import (_explicit_pads, _norm_padding, _norm_tuple,
                   from_nchw_view, nchw_view)

__all__ = ["max_pool2d", "avg_pool2d", "adaptive_avg_pool2d"]


def _window(x, kernel_size, stride, padding, ceil_mode):
    if ceil_mode:
        raise NotImplementedError(
            "ceil_mode=True: the reference accepts it but pools as with "
            "False (ROADMAP C-ref-4); the port does not diverge silently")
    kernel = _norm_tuple(kernel_size, 2)
    stride = _norm_tuple(stride, 2) if stride is not None else kernel
    pad = _norm_padding(padding, 2, stride, (1, 1), kernel)
    pairs = _explicit_pads(pad, x.shape[2:], kernel, stride)
    return kernel, stride, pad, pairs


def _torch_pads(pairs, kernel):
    """The symmetric padding torch's max pooling takes for ``pairs``, or
    None where it cannot (asymmetric, or more than half the window)."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pairs, kernel)):
        return tuple(lo for lo, _ in pairs)
    return None


def _flat(pairs):
    # [(lo_h, hi_h), (lo_w, hi_w)] -> pad's last-axis-first list
    return [pairs[1][0], pairs[1][1], pairs[0][0], pairs[0][1]]


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported yet")
    x, = amp_cast("max_pool2d", x)
    xc = nchw_view(x, data_format)
    kernel, stride, _, pairs = _window(xc, kernel_size, stride, padding,
                                       ceil_mode)
    sym = _torch_pads(pairs, kernel)
    if sym is None:
        xc = _pad(xc, _flat(pairs), value=float("-inf"))
        sym = (0, 0)
    out = torch.nn.functional.max_pool2d(xc, kernel, stride, sym)
    return from_nchw_view(out, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    x, = amp_cast("avg_pool2d", x)
    xc = nchw_view(x, data_format)
    kernel, stride, pad, pairs = _window(xc, kernel_size, stride, padding,
                                         ceil_mode)
    # the reference counts only the input's elements where explicit
    # padding is nonzero, and divides by the whole window otherwise
    exclusive = exclusive and not isinstance(pad, str)
    if not any(lo or hi for lo, hi in pairs):
        out = torch.nn.functional.avg_pool2d(xc, kernel, stride)
    else:
        # padded windows are pooled over explicit zero padding: torch's own
        # count_include_pad=False backward is wrong on a channels_last
        # CUDA tensor (torch 2.11 on an H100: relative error ~0.9 against
        # the host's, which matches the reference)
        summed = torch.nn.functional.avg_pool2d(
            _pad(xc, _flat(pairs)), kernel, stride) * math.prod(kernel)
        if exclusive:
            ones = torch.ones_like(xc[:1, :1])
            counts = torch.nn.functional.avg_pool2d(
                _pad(ones, _flat(pairs)), kernel, stride) * math.prod(kernel)
            out = summed / counts
        else:
            out = summed / math.prod(kernel)
    return from_nchw_view(out, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    x, = amp_cast("adaptive_avg_pool2d", x)
    xc = nchw_view(x, data_format)
    out = torch.nn.functional.adaptive_avg_pool2d(
        xc, _norm_tuple(output_size, 2))
    return from_nchw_view(out, data_format)
