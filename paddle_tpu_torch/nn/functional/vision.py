"""affine_grid, grid_sample and temporal_shift (port of
paddle_tpu/nn/functional/vision.py).

The reference's arithmetic, written out in torch ops rather than
``torch.nn.functional.grid_sample`` (whose ``align_corners`` defaults to
False where the reference's defaults to True, and whose reflection and
rounding rules are its own): the grid is unnormalised, folded by the
padding mode, and the corners are gathered from the flattened spatial
axis with zeros outside the input; the bilinear weights stay in the
differentiable path, so gradients reach both ``x`` and the grid.
Coordinates are computed in float32 whatever the input's dtype. Only
``bilinear``/``nearest`` and ``zeros``/``border``/``reflection`` exist,
as in the reference.
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["affine_grid", "grid_sample", "temporal_shift"]


def _base_coords(size, align_corners, device):
    if align_corners:
        return torch.linspace(-1.0, 1.0, size, dtype=torch.float32,
                              device=device)
    return (torch.arange(size, device=device, dtype=torch.float32) * 2 + 1) \
        / size - 1.0


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta: (N, 2, 3) affine matrices; out_shape: [N, C, H, W] (a list,
    a tuple or a tensor). Returns the (N, H, W, 2) sampling grid of
    normalised (x, y) coordinates."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, h, w = [int(v) for v in out_shape]
    theta, = amp_cast("affine_grid", theta)
    gy, gx = torch.meshgrid(_base_coords(h, align_corners, theta.device),
                            _base_coords(w, align_corners, theta.device),
                            indexing="ij")
    # a multiply-add per coordinate, exact in f32 (no matmul unit)
    t = theta.float()[:, :, :, None, None]
    ox = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2]
    oy = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2]
    return torch.stack([ox, oy], dim=-1).to(theta.dtype)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x: (N, C, H, W); grid: (N, Hg, Wg, 2) normalised (x, y) in [-1, 1].
    Returns (N, C, Hg, Wg)."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample: unsupported mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(
            f"grid_sample: unsupported padding_mode {padding_mode!r}")
    x, grid = amp_cast("grid_sample", x, grid)
    n, c, h, w = x.shape

    def unnormalize(coord, size):
        if align_corners:
            return (coord + 1.0) / 2.0 * (size - 1)
        return ((coord + 1.0) * size - 1.0) / 2.0

    def reflect(ix, size):
        if align_corners:
            span = 2.0 * (size - 1) if size > 1 else 1.0
            ix = ix.abs() % span
            return torch.where(ix > (size - 1), span - ix, ix)
        span = 2.0 * size
        ix = ((ix + 0.5) % span).abs()
        ix = torch.where(ix > size, span - ix, ix)
        return (ix - 0.5).clamp(0, size - 1)

    g = grid.float()
    ix = unnormalize(g[..., 0], w)                    # (N, Hg, Wg)
    iy = unnormalize(g[..., 1], h)
    if padding_mode == "border":
        ix = ix.clamp(0, w - 1)
        iy = iy.clamp(0, h - 1)
    elif padding_mode == "reflection":
        ix = reflect(ix, w)
        iy = reflect(iy, h)
    flat = x.reshape(n, c, h * w)

    def gather(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, 1, -1)
        got = flat.gather(2, idx.expand(n, c, -1)).reshape(
            (n, c) + tuple(yi.shape[1:]))
        return torch.where(valid[:, None], got, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))

    if mode == "nearest":
        return gather(torch.round(iy).long(), torch.round(ix).long())
    x0, y0 = torch.floor(ix), torch.floor(iy)
    wx1 = (ix - x0).to(x.dtype)
    wy1 = (iy - y0).to(x.dtype)
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    x0, y0 = x0.long(), y0.long()
    x1, y1 = x0 + 1, y0 + 1
    return (gather(y0, x0) * (wy0 * wx0)[:, None]
            + gather(y0, x1) * (wy0 * wx1)[:, None]
            + gather(y1, x0) * (wy1 * wx0)[:, None]
            + gather(y1, x1) * (wy1 * wx1)[:, None])


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM's temporal shift of an (N * T, C, H, W) input: the first
    ``shift_ratio`` of the channels move one step back in time, the next
    as many one step forward, zeros fill in, the rest stay."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"temporal_shift: bad data_format {data_format!r}")
    x, = amp_cast("temporal_shift", x)
    v = x if data_format == "NCHW" else x.movedim(-1, 1)
    nt, c, h, w = v.shape
    r = v.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    back = torch.cat([r[:, 1:, :c1], torch.zeros_like(r[:, :1, :c1])], dim=1)
    fwd = torch.cat([torch.zeros_like(r[:, :1, c1:c2]), r[:, :-1, c1:c2]],
                    dim=1)
    out = torch.cat([back, fwd, r[:, :, c2:]], dim=2).reshape(nt, c, h, w)
    return out if data_format == "NCHW" else out.movedim(1, -1)
