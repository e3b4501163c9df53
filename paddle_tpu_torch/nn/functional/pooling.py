"""Pooling, 1-D to 3-D, adaptive, with masks, and unpooling (port of
paddle_tpu/nn/functional/pooling.py).

A channel-last input (NLC, NHWC, NDHWC) is viewed channel-first
(``conv.channel_first``; NHWC so has channels_last strides, as conv2d
views it); the pooling is torch's. The reference's semantics:

- padding: an int, a tuple, [lo, hi] pairs, "SAME" or "VALID" (SAME as
  lax pads it, the odd pad at the end). Max pooling pads with -inf.
- ``avg_pool*(exclusive=True)`` divides each window by the count of its
  elements inside the input where explicit padding is nonzero; under
  "SAME" the reference divides by the whole window, and so does the port
  (torch's count_include_pad differs). A padded average pool pads
  explicitly and counts with a pooled tensor of ones, since torch's
  count_include_pad=False backward is wrong on channels_last CUDA
  tensors.
- Adaptive pooling: window j of n over a length L spans [floor(j L / n),
  ceil((j + 1) L / n)), the reference's rule and torch's.
- ``return_mask=True`` gives, beside the maxima, the int32 flat index of
  each maximum in the unpadded spatial extent, the first in window order
  on ties (torch gives int64); the reference refuses it with
  ``ceil_mode``, a string padding or a channel-last format, and so does
  the port. ``max_unpool1d/2d`` scatter the maxima back to those indices;
  the output is (in - 1) * stride - 2 * padding + kernel long unless
  ``output_size`` is given.
- ``ceil_mode=True`` raises: the reference accepts it but never applies
  it (ROADMAP C-ref-4), so the port matches it only for False.
  ``return_mask=True`` of the adaptive max poolings and
  ``divisor_override`` of the average poolings are never read by the
  reference: they raise too (ROADMAP C-ref-17).
"""
from __future__ import annotations

import itertools
import math

import torch

from ...amp.auto_cast import amp_cast
from .conv import (_explicit_pads, _norm_padding, _norm_tuple, _torch_pad,
                   channel_first, from_channel_first)

__all__ = ["avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool1d", "max_unpool2d"]

_UNREAD = ("the reference accepts it but never reads it (ROADMAP "
           "C-ref-17); the port does not diverge silently")


def _window(x, n, kernel_size, stride, padding, ceil_mode):
    if ceil_mode:
        raise NotImplementedError(
            "ceil_mode=True: the reference accepts it but pools as with "
            "False (ROADMAP C-ref-4); the port does not diverge silently")
    kernel = _norm_tuple(kernel_size, n)
    stride = _norm_tuple(stride, n) if stride is not None else kernel
    pad = _norm_padding(padding, n, stride, (1,) * n, kernel)
    pairs = _explicit_pads(pad, x.shape[2:], kernel, stride)
    return kernel, stride, pad, pairs


def _torch_pads(pairs, kernel):
    """The symmetric padding torch's max pooling takes for ``pairs``, or
    None where it cannot (asymmetric, or more than half the window)."""
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pairs, kernel)):
        return tuple(lo for lo, _ in pairs)
    return None


def _max_pool(x, n, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format):
    if return_mask:
        return _max_pool_with_mask(x, n, kernel_size, stride, padding,
                                   data_format, ceil_mode)
    x, = amp_cast(f"max_pool{n}d", x)
    xc = channel_first(x, data_format, n)
    kernel, stride, _, pairs = _window(xc, n, kernel_size, stride, padding,
                                       ceil_mode)
    sym = _torch_pads(pairs, kernel)
    if sym is None:
        xc = torch.nn.functional.pad(
            xc, [p for lo_hi in reversed(pairs) for p in lo_hi],
            value=float("-inf"))
        sym = (0,) * n
    pool = getattr(torch.nn.functional, f"max_pool{n}d")
    return from_channel_first(pool(xc, kernel, stride, sym), data_format)


def _avg_pool(x, n, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, data_format):
    if divisor_override is not None:
        raise NotImplementedError(f"divisor_override: {_UNREAD}")
    x, = amp_cast(f"avg_pool{n}d", x)
    xc = channel_first(x, data_format, n)
    kernel, stride, pad, pairs = _window(xc, n, kernel_size, stride, padding,
                                         ceil_mode)
    pool = getattr(torch.nn.functional, f"avg_pool{n}d")
    # the reference counts only the input's elements where explicit
    # padding is nonzero, and divides by the whole window otherwise
    exclusive = exclusive and not isinstance(pad, str)
    if not any(lo or hi for lo, hi in pairs):
        out = pool(xc, kernel, stride)
    else:
        # padded windows are pooled over explicit zero padding: torch's own
        # count_include_pad=False backward is wrong on a channels_last
        # CUDA tensor (torch 2.11 on an H100: relative error ~0.9 against
        # the host's, which matches the reference)
        summed = pool(_torch_pad(xc, pairs), kernel, stride) \
            * math.prod(kernel)
        if exclusive:
            ones = torch.ones_like(xc[:1, :1])
            counts = pool(_torch_pad(ones, pairs), kernel, stride) \
                * math.prod(kernel)
            out = summed / counts
        else:
            out = summed / math.prod(kernel)
    return from_channel_first(out, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, 1, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, 2, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, 3, kernel_size, stride, padding, return_mask,
                     ceil_mode, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, 1, kernel_size, stride, padding, ceil_mode,
                     exclusive, None, data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, 2, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, 3, kernel_size, stride, padding, ceil_mode,
                     exclusive, divisor_override, data_format)


def _adaptive(x, n, output_size, mode, data_format, return_mask=False):
    if return_mask:
        raise NotImplementedError(f"adaptive_max_pool{n}d(return_mask=True):"
                                  f" {_UNREAD}")
    x, = amp_cast(f"adaptive_{mode}_pool{n}d", x)
    xc = channel_first(x, data_format, n)
    pool = getattr(torch.nn.functional, f"adaptive_{mode}_pool{n}d")
    return from_channel_first(pool(xc, _norm_tuple(output_size, n)),
                              data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, 1, output_size, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, 2, output_size, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, 3, output_size, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 1, output_size, "max", "NCL", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 2, output_size, "max", "NCHW", return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 3, output_size, "max", "NCDHW", return_mask)


def _max_pool_with_mask(x, n, kernel_size, stride, padding, data_format,
                        ceil_mode=False):
    """(maxima, int32 flat indices into the unpadded spatial extent): the
    window's elements are stacked along a leading axis, one strided slice
    of the -inf-padded input per kernel offset (kernels are small), and
    the first maximum along it is taken."""
    if ceil_mode:
        raise NotImplementedError(
            "return_mask=True with ceil_mode=True is not supported; pad the "
            "input explicitly or use ceil_mode=False")
    kernel = _norm_tuple(kernel_size, n)
    stride = _norm_tuple(stride, n) if stride is not None else kernel
    pad = _norm_padding(padding, n, stride, (1,) * n, kernel)
    if isinstance(pad, str):
        raise ValueError("return_mask does not support string padding modes")
    if data_format in ("NHWC", "NLC", "NDHWC"):
        raise ValueError("return_mask requires channel-first data_format")
    x, = amp_cast(f"max_pool{n}d_with_mask", x)
    spatial = x.shape[2:]
    out_sizes = [(spatial[i] + pad[i][0] + pad[i][1] - kernel[i])
                 // stride[i] + 1 for i in range(n)]
    xp = torch.nn.functional.pad(
        x, [p for lo_hi in reversed(pad) for p in lo_hi],
        value=float("-inf"))
    starts = torch.meshgrid(
        *[torch.arange(o, device=x.device) * s
          for o, s in zip(out_sizes, stride)], indexing="ij")
    vals, idxs = [], []
    for offs in itertools.product(*[range(k) for k in kernel]):
        sl = (slice(None), slice(None)) + tuple(
            slice(offs[i], offs[i] + out_sizes[i] * stride[i], stride[i])
            for i in range(n))
        vals.append(xp[sl])
        flat = starts[0] + offs[0] - pad[0][0]
        for i in range(1, n):
            flat = flat * spatial[i] + starts[i] + offs[i] - pad[i][0]
        idxs.append(flat)
    stacked = torch.stack(vals)                       # (K, N, C, *out)
    which = stacked.argmax(dim=0, keepdim=True)       # first maximum
    out = stacked.gather(0, which)[0]
    idx = torch.stack(idxs).to(torch.int32)           # (K, *out)
    idx = idx.reshape((len(idxs), 1, 1) + tuple(out_sizes)).expand(
        (len(idxs),) + tuple(out.shape))
    return out, idx.gather(0, which)[0]


def _unpool(x, indices, sizes):
    """Zeros of (N, C, *sizes) with x's values at the flat ``indices``."""
    x, = amp_cast(f"max_unpool{len(sizes)}d", x)
    nb, c = x.shape[:2]
    out = torch.zeros((nb, c, math.prod(sizes)), dtype=x.dtype,
                      device=x.device)
    out = out.scatter(2, indices.reshape(nb, c, -1).long(),
                      x.reshape(nb, c, -1))
    return out.reshape((nb, c) + tuple(sizes))


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    """The inverse of max_pool1d(return_mask=True)."""
    if data_format != "NCL":
        raise ValueError("max_unpool1d requires NCL")
    kernel = _norm_tuple(kernel_size, 1)
    stride = _norm_tuple(stride, 1) if stride is not None else kernel
    if output_size:
        size = int(output_size[-1])
    else:
        size = ((x.shape[-1] - 1) * stride[0]
                - 2 * _norm_tuple(padding, 1)[0] + kernel[0])
    return _unpool(x, indices, (size,))


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """The inverse of max_pool2d(return_mask=True): each pooled value
    goes back to its argmax position, zeros elsewhere."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d requires NCHW")
    kernel = _norm_tuple(kernel_size, 2)
    stride = _norm_tuple(stride, 2) if stride is not None else kernel
    pad = _norm_tuple(padding, 2)
    if output_size:
        sizes = (int(output_size[-2]), int(output_size[-1]))
    else:
        sizes = tuple((x.shape[2 + i] - 1) * stride[i] - 2 * pad[i]
                      + kernel[i] for i in range(2))
    return _unpool(x, indices, sizes)
