"""Vision transforms (port of paddle_tpu/vision/transforms/__init__.py):
numpy, CHW or HWC, on the host.

The same code as the reference, apart from ``Resize``: the reference
calls ``jax.image.resize(..., method="linear")``, and the port computes
the same linear resize with numpy (``_linear_weights``): a half-pixel
triangle kernel, widened by the scale factor on an axis that shrinks
(jax's antialiasing), with each output's weights normalised to sum to
one. Enlarging, that is bilinear interpolation with half-pixel centres
(``torch.nn.functional.interpolate(mode="bilinear",
align_corners=False)``). The random transforms draw from numpy's global
generator in the reference's order, so one ``np.random.seed`` gives the
same crops and flips in both packages.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Compose", "ToTensor", "Normalize", "Resize", "RandomCrop",
           "CenterCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
           "Transpose", "normalize", "to_tensor", "resize", "hflip"]


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor:
    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and arr.shape[-1] in (1, 3, 4) and self.data_format == "CHW":
            if arr.shape[0] not in (1, 3, 4):
                arr = arr.transpose(2, 0, 1)
        if arr.max() > 2.0:
            arr = arr / 255.0
        return arr


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def __call__(self, img):
        arr = np.asarray(img, dtype=np.float32)
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        return (arr - self.mean.reshape(shape)) / self.std.reshape(shape)


def _chw(arr):
    return arr.ndim == 3 and arr.shape[0] in (1, 3, 4)


def _linear_weights(n_in, n_out):
    """(n_in, n_out) float32 weights of a linear resize along one axis:
    jax.image's ``compute_weight_mat`` with a triangle kernel, no
    translation and antialiasing on."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    # one rounding of (i + 0.5) * inv_scale - 0.5, as the fused
    # multiply-add of jax's compiled resize gives (the product of two
    # float32s is exact in float64)
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              .astype(np.float64) * np.float64(inv_scale) - 0.5
              ).astype(np.float32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize_linear(arr, size, chw):
    """``arr`` (float32, CHW or HWC) resized to ``size`` = (h, w). Each
    axis whose length changes is contracted with its weights, in float64,
    and the result is cast to float32."""
    h_axis, w_axis = (1, 2) if chw else (0, 1)
    out = arr.astype(np.float64)
    for axis, n_out in ((h_axis, size[0]), (w_axis, size[1])):
        n_in = out.shape[axis]
        if n_in == n_out:
            continue
        w = _linear_weights(n_in, n_out).astype(np.float64)
        out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1,
                          axis)
    return out.astype(np.float32)


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img, dtype=np.float32)
        return _resize_linear(arr, self.size, _chw(arr))


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img)
        h_axis, w_axis = (1, 2) if _chw(arr) else (0, 1)
        h, w = arr.shape[h_axis], arr.shape[w_axis]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        sl = [slice(None)] * arr.ndim
        sl[h_axis] = slice(i, i + th)
        sl[w_axis] = slice(j, j + tw)
        return arr[tuple(sl)]


class RandomCrop:
    def __init__(self, size, padding=None, pad_if_needed=False):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        h_axis, w_axis = (1, 2) if _chw(arr) else (0, 1)
        if self.padding:
            pads = [(0, 0)] * arr.ndim
            pads[h_axis] = (self.padding, self.padding)
            pads[w_axis] = (self.padding, self.padding)
            arr = np.pad(arr, pads)
        h, w = arr.shape[h_axis], arr.shape[w_axis]
        th, tw = self.size
        i = np.random.randint(0, max(h - th, 0) + 1)
        j = np.random.randint(0, max(w - tw, 0) + 1)
        sl = [slice(None)] * arr.ndim
        sl[h_axis] = slice(i, i + th)
        sl[w_axis] = slice(j, j + tw)
        return arr[tuple(sl)]


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        arr = np.asarray(img)
        if np.random.rand() < self.prob:
            axis = 2 if _chw(arr) else 1
            return np.flip(arr, axis=axis).copy()
        return arr


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        arr = np.asarray(img)
        if np.random.rand() < self.prob:
            axis = 1 if _chw(arr) else 0
            return np.flip(arr, axis=axis).copy()
        return arr


class Transpose:
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    arr = np.asarray(img)
    axis = 2 if _chw(arr) else 1
    return np.flip(arr, axis=axis).copy()


class BaseTransform:
    """transforms.BaseTransform parity: keys-aware transform base; subclasses
    implement _apply_image (and optionally _apply_* per key)."""

    def __init__(self, keys=None):
        self.keys = keys or ("image",)

    def _apply_image(self, image):
        raise NotImplementedError

    def __call__(self, inputs):
        if not isinstance(inputs, (list, tuple)):
            return self._apply_image(inputs)
        outs = []
        for key, data in zip(self.keys, inputs):
            fn = getattr(self, f"_apply_{key}", None)
            outs.append(fn(data) if fn else data)
        return tuple(outs)


def _hwc_view(arr):
    """Return (hwc_array, was_chw): transforms operate in HWC internally."""
    if _chw(arr):
        return np.transpose(arr, (1, 2, 0)), True
    return arr, False


def _restore(arr, was_chw):
    return np.transpose(arr, (2, 0, 1)) if was_chw else arr


def crop(img, top, left, height, width):
    arr = np.asarray(img)
    a, was = _hwc_view(arr)
    out = a[top:top + height, left:left + width]
    return _restore(out, was)


def center_crop(img, output_size):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    arr = np.asarray(img)
    a, was = _hwc_view(arr)
    h, w = a.shape[:2]
    th, tw = output_size
    top = max((h - th) // 2, 0)
    left = max((w - tw) // 2, 0)
    return _restore(a[top:top + th, left:left + tw], was)


def vflip(img):
    arr = np.asarray(img)
    a, was = _hwc_view(arr)
    return _restore(a[::-1].copy(), was)


def pad(img, padding, fill=0, padding_mode="constant"):
    arr = np.asarray(img)
    a, was = _hwc_view(arr)
    if isinstance(padding, int):
        pl = pr = pt = pb = padding
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    mode = {"constant": "constant", "edge": "edge",
            "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    out = np.pad(a, ((pt, pb), (pl, pr), (0, 0)) if a.ndim == 3
                 else ((pt, pb), (pl, pr)), mode=mode, **kw)
    return _restore(out, was)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotation via inverse affine sampling (host-side numpy). expand=True
    enlarges the canvas to the rotated bounding box (reference semantics;
    expand requires rotation about the image center)."""
    orig_dtype = np.asarray(img).dtype
    arr = np.asarray(img, np.float32)
    a, was = _hwc_view(arr)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w = a.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None \
        else (center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    if expand:
        # epsilon guards against float noise (90deg: cos ~ 6e-17)
        oh = int(np.ceil(abs(h * cos) + abs(w * sin) - 1e-6))
        ow = int(np.ceil(abs(w * cos) + abs(h * sin) - 1e-6))
        ocy, ocx = (oh - 1) / 2.0, (ow - 1) / 2.0
    else:
        oh, ow, ocy, ocx = h, w, cy, cx
    yy, xx = np.meshgrid(np.arange(oh), np.arange(ow), indexing="ij")
    xs = cos * (xx - ocx) + sin * (yy - ocy) + cx
    ys = -sin * (xx - ocx) + cos * (yy - ocy) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full((yy.shape[0], yy.shape[1], a.shape[2]), fill,
                  dtype=a.dtype)
    out[valid] = a[yi[valid], xi[valid]]
    if out.shape[-1] == 1 and arr.ndim == 2:
        out = out[:, :, 0]
    return _restore(out.astype(orig_dtype), was)


def to_grayscale(img, num_output_channels=1):
    orig_dtype = np.asarray(img).dtype
    arr = np.asarray(img, np.float32)
    a, was = _hwc_view(arr)
    if a.ndim == 3 and a.shape[-1] >= 3:
        g = (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2])
    else:
        g = a[..., 0] if a.ndim == 3 else a
    out = np.repeat(g[..., None], num_output_channels, axis=-1)
    return _restore(out.astype(orig_dtype), was)


def adjust_brightness(img, brightness_factor):
    orig_dtype = np.asarray(img).dtype
    arr = np.asarray(img, np.float32)
    hi = 255.0 if arr.max() > 2.0 else 1.0
    return np.clip(arr * brightness_factor, 0, hi).astype(orig_dtype)


def adjust_contrast(img, contrast_factor):
    orig_dtype = np.asarray(img).dtype
    arr = np.asarray(img, np.float32)
    hi = 255.0 if arr.max() > 2.0 else 1.0
    mean = arr.mean()
    return np.clip((arr - mean) * contrast_factor + mean, 0,
                   hi).astype(orig_dtype)


def adjust_saturation(img, saturation_factor):
    orig_dtype = np.asarray(img).dtype
    arr = np.asarray(img, np.float32)
    a, was = _hwc_view(arr)
    hi = 255.0 if arr.max() > 2.0 else 1.0
    gray = to_grayscale(a, 3) if not was else _hwc_view(
        to_grayscale(_restore(a, was), 3))[0]
    out = np.clip(a * saturation_factor + gray * (1 - saturation_factor),
                  0, hi)
    return _restore(out.astype(orig_dtype), was)


def adjust_hue(img, hue_factor):
    """Hue shift in HSV space (|hue_factor| <= 0.5)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    orig_dtype = np.asarray(img).dtype
    arr = np.asarray(img, np.float32)
    a, was = _hwc_view(arr)
    hi = 255.0 if arr.max() > 2.0 else 1.0
    x = a / hi
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx, mn = x.max(-1), x.min(-1)
    diff = mx - mn + 1e-12
    h = np.zeros_like(mx)
    m = mx == r
    h[m] = ((g - b) / diff)[m] % 6
    m = mx == g
    h[m] = ((b - r) / diff + 2)[m]
    m = mx == b
    h[m] = ((r - g) / diff + 4)[m]
    h = (h / 6.0 + hue_factor) % 1.0
    s = np.where(mx > 0, diff / (mx + 1e-12), 0)
    v = mx
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(np.int64) % 6
    out = np.zeros_like(x)
    for idx, (rr, gg, bb) in enumerate(
            [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
             (v, p, q)]):
        m = i == idx
        out[..., 0][m] = rr[m]
        out[..., 1][m] = gg[m]
        out[..., 2][m] = bb[m]
    return _restore((out * hi).astype(orig_dtype), was)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _factor(self):
        v = self.value
        lo, hi = (max(0, 1 - v), 1 + v) if np.isscalar(v) else v
        return np.random.uniform(lo, hi)

    def _apply_image(self, img):
        return adjust_brightness(img, self._factor())


class ContrastTransform(BrightnessTransform):
    def _apply_image(self, img):
        return adjust_contrast(img, self._factor())


class SaturationTransform(BrightnessTransform):
    def _apply_image(self, img):
        return adjust_saturation(img, self._factor())


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        v = self.value
        lo, hi = (-v, v) if np.isscalar(v) else v
        return adjust_hue(img, np.random.uniform(lo, hi))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self._ts = []
        if brightness:
            self._ts.append(BrightnessTransform(brightness))
        if contrast:
            self._ts.append(ContrastTransform(contrast))
        if saturation:
            self._ts.append(SaturationTransform(saturation))
        if hue:
            self._ts.append(HueTransform(hue))

    def _apply_image(self, img):
        order = np.random.permutation(len(self._ts))
        for i in order:
            img = self._ts[i]._apply_image(img)
        return img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self._args = (padding, fill, padding_mode)

    def _apply_image(self, img):
        return pad(img, *self._args)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        self.degrees = (-degrees, degrees) if np.isscalar(degrees) \
            else tuple(degrees)
        self._kw = dict(interpolation=interpolation, expand=expand,
                        center=center, fill=fill)

    def _apply_image(self, img):
        return rotate(img, np.random.uniform(*self.degrees), **self._kw)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.n = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.n)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        arr = np.asarray(img)
        a, was = _hwc_view(arr)
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                top = np.random.randint(0, h - ch + 1)
                left = np.random.randint(0, w - cw + 1)
                patch = a[top:top + ch, left:left + cw]
                return self._resize(_restore(patch, was))
        return self._resize(center_crop(_restore(a, was), min(h, w)))


__all__ += ["BaseTransform", "RandomResizedCrop", "BrightnessTransform",
            "SaturationTransform", "ContrastTransform", "HueTransform",
            "ColorJitter", "Pad", "RandomRotation", "Grayscale", "vflip",
            "pad", "rotate", "to_grayscale", "crop", "center_crop",
            "adjust_brightness", "adjust_contrast", "adjust_saturation",
            "adjust_hue"]
