"""The convolutions, 1-D to 3-D and transposed (port of
paddle_tpu/nn/functional/conv.py).

Each is torch's convolution (cuDNN on the card), as the reference leaves
it to XLA's ``conv_general_dilated``. Weights are (out, in / groups, *k)
for a convolution and (in, out / groups, *k) for a transposed one, in
every data format, as in the reference and in torch.

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
- The 1-D and 3-D convolutions take NCL / NLC and NCDHW / NDHWC; a
  channel-last input is viewed channel-first (``movedim``), as NHWC is.
- The transposed convolutions compute the adjoint of the convolution
  with the same weight, stride, padding, dilation and groups, as
  Paddle's and torch's do. The reference calls ``lax.conv_transpose``
  with ``transpose_kernel=False``, which does not flip the kernel: its
  result is the port's with ``w`` flipped along every spatial axis. The
  port does not mirror that (ROADMAP C-ref-16). Explicit padding (lo,
  hi) crops lo from the front and hi - output_padding from the back of
  the full result, of length (in - 1) * stride + (k - 1) * dilation + 1;
  "SAME" and "VALID" crop as lax.conv_transpose pads (out = in * stride
  for "SAME"). ``output_size``, and ``output_padding`` beside a string
  padding, are never read by the reference, so they raise (ROADMAP
  C-ref-17).
"""
from __future__ import annotations

import numpy as np
import torch

from ...amp.auto_cast import amp_cast
from .common import pad as _pad

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]


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


# -- 1-D and 3-D, and the transposed convolutions ---------------------------
_CHANNEL_LAST = ("NLC", "NHWC", "NDHWC")
_FORMATS = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def channel_first(x, data_format, n):
    """``x`` viewed channel-first (a channel-last input is moved as a
    view), after checking ``data_format`` is one of the n-D formats."""
    if data_format not in _FORMATS[n]:
        raise ValueError(f"data_format must be one of {_FORMATS[n]}, got "
                         f"{data_format!r}")
    return x.movedim(-1, 1) if data_format in _CHANNEL_LAST else x


def from_channel_first(y, data_format):
    return y.movedim(1, -1) if data_format in _CHANNEL_LAST else y


def _torch_pad(x, pairs):
    """Constant zero padding (or, for negative entries, cropping) of the
    trailing len(pairs) axes by [(lo, hi)] per axis, first axis first."""
    return torch.nn.functional.pad(
        x, [p for lo_hi in reversed(pairs) for p in lo_hi])


def _conv_nd(n, x, weight, bias, stride, padding, dilation, groups,
             data_format):
    x, weight, bias = amp_cast(f"conv{n}d", x, weight, bias)
    xc = channel_first(x, data_format, n)
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    pairs = _explicit_pads(_norm_padding(padding, n, stride, dilation, None),
                           xc.shape[2:], weight.shape[2:], stride, dilation)
    sym, pre = _split_pads(pairs)
    if pre is not None:
        xc = _torch_pad(xc, pairs)
    conv = getattr(torch.nn.functional, f"conv{n}d")
    out = conv(xc, weight, bias, stride, sym, dilation, groups)
    return from_channel_first(out, data_format)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """x: (N, C, L), or (N, L, C) under NLC; weight (O, C/groups, k)."""
    return _conv_nd(1, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """x: (N, C, D, H, W), or (N, D, H, W, C) under NDHWC; weight (O,
    C/groups, kd, kh, kw)."""
    return _conv_nd(3, x, weight, bias, stride, padding, dilation, groups,
                    data_format)


def _transpose_crops(padding, output_padding, n, kernel, stride, dilation):
    """[(lo, hi)] per spatial axis to crop from the full transposed
    result (negative: zeros appended), the module docstring's rule."""
    eff = [(k - 1) * d + 1 for k, d in zip(kernel, dilation)]
    opad = _norm_tuple(output_padding, n) if output_padding else (0,) * n
    if isinstance(padding, str):
        pad = padding.upper()
        if any(opad):
            raise NotImplementedError(
                f"output_padding={output_padding!r} with padding={padding!r}: "
                f"the reference never reads output_padding under a string "
                f"padding (ROADMAP C-ref-17)")
        crops = []
        for k, s in zip(eff, stride):
            # lax.conv_transpose's pads on the dilated input (pad_a, pad_b)
            if pad == "SAME":
                total = k + s - 2
                pad_a = k - 1 if s > k - 1 else -(-total // 2)
            elif pad == "VALID":
                total = k + s - 2 + max(k - s, 0)
                pad_a = k - 1
            else:
                raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                                 f"{padding!r}")
            crops.append((k - 1 - pad_a, k - 1 - (total - pad_a)))
        return crops
    pairs = _norm_padding(padding, n, stride, dilation, None)
    return [(lo, hi - o) for (lo, hi), o in zip(pairs, opad)]


def _conv_transpose_nd(n, x, weight, bias, stride, padding, output_padding,
                       dilation, groups, output_size, data_format):
    if output_size is not None:
        raise NotImplementedError(
            "output_size: the reference never reads it and sizes the output "
            "from padding and output_padding (ROADMAP C-ref-17); pass "
            "output_padding instead")
    x, weight, bias = amp_cast(f"conv{n}d_transpose", x, weight, bias)
    xc = channel_first(x, data_format, n)
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    crops = _transpose_crops(padding, output_padding, n, weight.shape[2:],
                             stride, dilation)
    conv_t = getattr(torch.nn.functional, f"conv_transpose{n}d")
    if all(lo == hi for lo, hi in crops) \
            and all(lo >= 0 for lo, _ in crops):
        out = conv_t(xc, weight, bias, stride, tuple(lo for lo, _ in crops),
                     0, groups, dilation)
    else:
        # torch takes one symmetric padding and an output_padding below
        # the stride: crop (or extend) the full result instead
        out = conv_t(xc, weight, None, stride, 0, 0, groups, dilation)
        out = _torch_pad(out, [(-lo, -hi) for lo, hi in crops])
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * n)
    return from_channel_first(out, data_format)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    """x: (N, C, L) or NLC; weight (C, O/groups, k)."""
    return _conv_transpose_nd(1, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    """x: (N, C, H, W) or NHWC; weight (C, O/groups, kh, kw)."""
    return _conv_transpose_nd(2, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    """x: (N, C, D, H, W) or NDHWC; weight (C, O/groups, kd, kh, kw)."""
    return _conv_transpose_nd(3, x, weight, bias, stride, padding,
                              output_padding, dilation, groups, output_size,
                              data_format)
