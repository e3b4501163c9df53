"""The common functions (port of paddle_tpu/nn/functional/common.py and
of the reference's ``pad``, tensor/manipulation.py): linear, the
dropouts, embedding, one_hot, label_smooth, pad and zeropad2d,
interpolate/upsample, pixel_shuffle/unshuffle, channel_shuffle,
unfold/fold, cosine_similarity and bilinear.

``linear`` keeps paddle's (in, out) weight layout: y = x @ W + b. Under
``amp.auto_cast`` each casts its inputs as the reference's op of the same
name is cast (amp/auto_cast.py). ``interpolate`` is the reference's
``jax.image.resize`` written out: separable weight matrices per spatial
axis (half-pixel centres, Keys' cubic with a = -0.5, a triangle or cubic
kernel widened by the scale when downsampling, so ``linear`` and
``cubic`` antialias), not torch's ``F.interpolate``, whose kernels,
``nearest`` rounding and borders differ.
"""
from __future__ import annotations

import numpy as np
import torch

from ...amp.auto_cast import amp_cast
from ...core.random import uniform

__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "pad", "interpolate",
           "upsample", "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "unfold", "fold", "cosine_similarity", "bilinear",
           "class_center_sample", "zeropad2d"]


def linear(x, weight, bias=None):
    """weight shape (in, out), the reference layout."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    out = torch.matmul(x, weight)
    return out if bias is None else out + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Gather rows of ``weight`` (int32 or int64 ids). Positions equal to
    ``padding_idx`` (negative: counted from the end) give zero rows and
    add nothing to the weight's gradient. ``sparse=True`` makes the
    weight's gradient a sparse COO tensor (one row per id, duplicates
    accumulating; core/selected_rows.py) in plain eager mode on a leaf
    weight; inside a ``to_static`` step, and for a computed weight, the
    gradient is dense, as in the reference (a sparse gradient never
    enters a CUDA graph)."""
    weight, = amp_cast("embedding", weight)
    if padding_idx is not None and padding_idx < 0:
        padding_idx += weight.shape[0]
    if sparse:
        from ...jit.to_static import in_static_step
        sparse = (weight.is_leaf and weight.requires_grad
                  and torch.is_grad_enabled() and not in_static_step())
    out = torch.nn.functional.embedding(x, weight, padding_idx=padding_idx,
                                        sparse=sparse)
    if padding_idx is not None:
        out = out * (x != padding_idx).unsqueeze(-1).to(out.dtype)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """In training, zero each element (or, with ``axis``, each slice along
    the axes not listed) with probability p, the keep mask drawn from
    ``generator`` (None: torch's default generator of x's device), and
    scale the rest by 1 / (1 - p) (``upscale_in_train``) or leave them
    (``downscale_in_infer``, which instead scales by 1 - p in eval).
    Identity in eval and at p == 0."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    x, = amp_cast("dropout", x)
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = uniform(shape, generator, x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Whole channels: one draw per (sample, channel)."""
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p=p, axis=axis, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p=p, axis=axis, training=training, generator=generator)


_SELU_ALPHA = 1.6732632423543772848170429916717
_SELU_SCALE = 1.0507009873554804934193349852946


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """SELU's dropout: a dropped element takes -alpha * scale, then the
    affine map that keeps a SELU activation's mean and variance."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = uniform(x.shape, generator, x.device) < 1.0 - p
    a = float(np.float32(1.0 / np.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2))))
    b = -a * alpha_p * p
    return (torch.where(keep, x, alpha_p) * a + b).to(x.dtype)


def one_hot(x, num_classes, name=None):
    """float32 rows; an index outside [0, num_classes) gives a row of
    zeros (the reference's jax.nn.one_hot), where torch's one_hot
    raises."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.long().unsqueeze(-1) == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """(1 - epsilon) label + epsilon prior_dist, the prior uniform over
    the last axis unless given."""
    if prior_dist is not None:
        return (1.0 - epsilon) * label + epsilon * prior_dist
    return (1.0 - epsilon) * label + epsilon / label.shape[-1]


_PAD_MODES = ("constant", "reflect", "replicate", "circular")


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",  # noqa: A002
        name=None):
    """The reference's flat-list convention: a list of 2 * x.dim() numbers
    pads every axis, first axis first, (lo, hi) each; a shorter list pads
    the spatial axes LAST axis first, [left, right, top, bottom] = W then
    H, as torch does. Under a channel-last ``data_format`` (NHWC, NLC,
    NDHWC) the spatial axes are 1..k, not the trailing ones, so C is never
    padded there."""
    pads = [int(p) for p in pad]
    nd = x.dim()
    if len(pads) == 2 * nd:
        width = [(pads[2 * i], pads[2 * i + 1]) for i in range(nd)]
    else:
        k = len(pads) // 2
        width = [(0, 0)] * nd
        channel_last = data_format in ("NHWC", "NDHWC", "NLC")
        spatial = list(range(1, 1 + k)) if channel_last \
            else list(range(nd - k, nd))
        for j in range(k):
            width[spatial[k - 1 - j]] = (pads[2 * j], pads[2 * j + 1])
    if mode not in _PAD_MODES:
        raise ValueError(f"pad mode must be one of {_PAD_MODES}, got "
                         f"{mode!r}")
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    # torch pads only trailing axes in these modes, behind at least one
    # batch axis: move the padded axes last, fold the rest into one
    axes = [i for i, w in enumerate(width) if w != (0, 0)]
    if not axes:
        return x
    rest = [i for i in range(nd) if i not in axes]
    moved = x.permute(*rest, *axes)
    folded = moved.reshape(1, -1, *moved.shape[len(rest):])
    flat = [p for a in reversed(axes) for p in width[a]]
    out = torch.nn.functional.pad(folded, flat, mode=mode)
    out = out.reshape(*moved.shape[:len(rest)], *out.shape[2:])
    inverse = [0] * nd
    for pos, a in enumerate(rest + axes):
        inverse[a] = pos
    return out.permute(*inverse)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


# -- interpolate: jax.image.resize / scale_and_translate, written out ------

def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}
_MODES = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
          "trilinear": "linear", "bicubic": "cubic", "area": "linear"}


def _weight_mat(in_size, out_size, inv_scale, translation, kernel, device):
    """The (in_size, out_size) f32 matrix that samples output pixel o at
    input coordinate (o + 0.5 - translation) * inv_scale - 0.5, the
    kernel widened by inv_scale when it exceeds 1 (antialiasing), each
    column normalised to sum 1 and zero where the sample lies outside the
    input (jax's compute_weight_mat)."""
    f32 = torch.float32
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
              * inv_scale - translation * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=f32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _contract(v, axis, w):
    """v with ``axis`` (length in) mapped through w (in, out)."""
    moved = v.movedim(axis, -1)
    return torch.matmul(moved, w.to(v.dtype)).movedim(-1, axis)


def _resize_nearest(v, axes, out_spatial):
    for ax, n in zip(axes, out_spatial):
        m = v.shape[ax]
        if m == n:
            continue
        offsets = torch.floor(
            (torch.arange(n, dtype=torch.float32, device=v.device) + 0.5)
            * m / n).long()
        v = v.index_select(ax, offsets)
    return v


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes to ``size`` (or floor(in * scale_factor)).

    - ``nearest``: input index floor((o + 0.5) * in / out) (torch's
      ``nearest-exact``).
    - ``linear``/``bilinear``/``trilinear`` and ``bicubic``: half-pixel
      centres, a triangle or Keys' cubic (a = -0.5) kernel, antialiased
      when downsampling (jax.image.resize); with ``align_corners`` output
      o samples input o (in - 1) / (out - 1), through the same kernels
      (jax.image.scale_and_translate).
    - ``area`` is the antialiased ``linear`` resize, as in the reference,
      not a box average (ROADMAP C-ref-15).

    The reference never reads ``align_mode``: ``align_mode=1`` on a
    linear mode without ``align_corners``, and ``align_corners`` with
    ``nearest``, raise instead of being ignored (ROADMAP C-ref-15)."""
    if mode not in _MODES:
        raise ValueError(f"interpolate mode must be one of "
                         f"{sorted(_MODES)}, got {mode!r}")
    method = _MODES[mode]
    if method == "nearest" and align_corners:
        raise NotImplementedError(
            "interpolate(mode='nearest', align_corners=True): the "
            "reference ignores align_corners for nearest, so the port "
            "refuses it (ROADMAP C-ref-15)")
    if method == "linear" and align_mode == 1 and not align_corners:
        raise NotImplementedError(
            "interpolate(align_mode=1): the reference never reads "
            "align_mode and always uses half-pixel centres, so the port "
            "refuses it (ROADMAP C-ref-15)")
    x, = amp_cast("interpolate", x)
    channel_last = data_format in ("NHWC", "NLC", "NDHWC")
    nsp = x.dim() - 2
    axes = list(range(1, 1 + nsp)) if channel_last \
        else list(range(2, 2 + nsp))
    in_spatial = [x.shape[a] for a in axes]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.reshape(-1).tolist()
        sizes = size if isinstance(size, (list, tuple)) else [size]
        out_spatial = [int(s.item() if isinstance(s, torch.Tensor) else s)
                       for s in sizes]
    else:
        if isinstance(scale_factor, (int, float)):
            scale_factor = [scale_factor] * nsp
        out_spatial = [int(np.floor(i * s))
                       for i, s in zip(in_spatial, scale_factor)]
    if method == "nearest":
        return _resize_nearest(x, axes, out_spatial)
    v = x if x.is_floating_point() else x.to(torch.float32)
    kernel = _KERNELS[method]
    f32 = torch.float32
    for ax, m, n in zip(axes, in_spatial, out_spatial):
        if align_corners:
            s = 1.0 if n <= 1 or m <= 1 else (n - 1.0) / (m - 1.0)
            s32 = torch.tensor(s, dtype=f32, device=v.device)
            inv = 1.0 / s32
            t = torch.tensor(0.5 - 0.5 * s, dtype=f32, device=v.device)
        else:
            if m == n:
                continue
            scale = n / m if n else 1.0
            inv = torch.tensor(1.0 / scale, dtype=f32, device=v.device)
            t = torch.zeros((), dtype=f32, device=v.device)
        v = _contract(v, ax, _weight_mat(m, n, inv, t, kernel, v.device))
    return v


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    """(N, C r^2, H, W) -> (N, C, H r, W r) (or the NHWC equivalent)."""
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        out = x.reshape(n, c // (r * r), r, r, h, w)
        return out.permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r),
                                                     h * r, w * r)
    n, h, w, c = x.shape
    out = x.reshape(n, h, w, r, r, c // (r * r))
    return out.permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r,
                                                 c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        out = x.reshape(n, c, h // r, r, w // r, r)
        return out.permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r,
                                                     w // r)
    n, h, w, c = x.shape
    out = x.reshape(n, h // r, r, w // r, r, c)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(n, h // r, w // r,
                                                 c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    """Channel g * (C / groups) + i moves to i * groups + g."""
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)


def _pair(v):
    if isinstance(v, (int, np.integer)):
        return [int(v), int(v)]
    return [int(i) for i in v]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: (N, C, H, W) -> (N, C kh kw, L), channel-major rows.
    ``paddings``: one int, [ph, pw] or [top, left, bottom, right]."""
    if isinstance(paddings, (int, np.integer)):
        paddings = [int(paddings)] * 2
    paddings = [int(p) for p in paddings]
    if len(paddings) == 4:
        top, left, bottom, right = paddings
        x = torch.nn.functional.pad(x, [left, right, top, bottom])
        paddings = [0, 0]
    return torch.nn.functional.unfold(
        x, _pair(kernel_sizes), dilation=_pair(dilations),
        padding=paddings, stride=_pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, unfold's adjoint: overlapping patches add up."""
    return torch.nn.functional.fold(
        x, _pair(output_sizes), _pair(kernel_sizes),
        dilation=_pair(dilations), padding=_pair(paddings),
        stride=_pair(strides))


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """sum(x1 x2) / max(|x1| |x2|, eps) along ``axis``."""
    num = (x1 * x2).sum(dim=axis)
    den = torch.sqrt((x1 * x1).sum(dim=axis)) \
        * torch.sqrt((x2 * x2).sum(dim=axis))
    return num / torch.clamp(den, min=eps)


def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] . weight[o] . x2[b] (+ bias[o])."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def class_center_sample(label, num_classes, num_samples, group=None):
    """Raises, as the reference does (its sampling of class centres is
    parameter-server oriented and out of its scope,
    paddle_tpu/nn/functional/common.py)."""
    raise NotImplementedError(
        "class_center_sample is parameter-server oriented and out of "
        "scope, as in the reference")
