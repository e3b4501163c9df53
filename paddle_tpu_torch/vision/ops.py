"""Vision and detection ops (port of paddle_tpu/vision/ops.py).

Every op is PyTorch on the input's device, as the reference's are jnp;
``nms``, ``read_file`` and ``decode_jpeg`` are host code in both. The
reference's conventions, kept here so that results agree (ROADMAP
C-ref-19):

- The bilinear sampler under ``deform_conv2d`` and ``roi_align`` gives
  each of a point's four corners zero weight when that corner lies
  outside [0, H - 1] x [0, W - 1] (the DCN convention). Upstream Paddle's
  RoIAlign clamps a sample in (-1, 0] to 0 instead.
- ``roi_align`` takes 2 samples a bin when ``sampling_ratio <= 0``
  (upstream Paddle takes ceil(roi / bin)).
- ``nms`` orders the boxes by a stable descending sort of the scores
  (the reference's numpy argsort is not stable: ties may fall either way
  there); ``nms_padded`` sorts stably in both packages.
- ``nms(categories=...)`` is never read by the reference: it raises here
  (ROADMAP C-ref-17).

RoIs map to their images on the device (``_roi_batch_index``: a
searchsorted over the cumulative ``boxes_num``), with no host read.
``roi_pool`` and ``psroi_pool`` gather each bin through a window as large
as the largest bin of the call, whose extent they read on the host (one
sync a call), RoIs in chunks that bound the gathered memory; ``nms_padded`` and the other ops read nothing on the host,
so a CUDA graph can capture them.
"""
from __future__ import annotations

import io

import numpy as np
import torch

from .. import nn as _nn
from ..core.device import resolve_device

__all__ = ["nms", "nms_padded", "box_iou", "deform_conv2d", "DeformConv2D",
           "roi_align", "RoIAlign", "roi_pool", "RoIPool", "psroi_pool",
           "PSRoIPool", "yolo_box", "yolo_loss", "read_file", "decode_jpeg"]


def _pairwise_iou(b1, b2, eps=0.0):
    """(N, 4) x (M, 4) -> (N, M) IoU of xyxy boxes."""
    area1 = (b1[:, 2] - b1[:, 0]) * (b1[:, 3] - b1[:, 1])
    area2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    lt = torch.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = torch.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter + eps)


def box_iou(boxes1, boxes2):
    return _pairwise_iou(boxes1, boxes2)


def _class_shift(b, category_idxs):
    """Boxes of each class moved into a coordinate range of their own, so
    that boxes of different classes never overlap (multiclass NMS)."""
    cat = category_idxs.to(b.dtype)
    span = b.abs().max() + 1.0
    return b + (cat * 2.0 * span)[:, None]


def nms_padded(boxes, scores, iou_threshold=0.3, max_output_size=None,
               category_idxs=None):
    """Fixed-size NMS: ``(indices, num_valid)``. ``indices`` (int32) has
    exactly ``max_output_size`` entries (default: the number of boxes),
    the kept boxes' indices in descending score order, then -1;
    ``num_valid`` (int32, 0-d) counts the kept ones, at most
    ``max_output_size``. ``category_idxs`` makes it class-aware.

    The greedy pass is sequential over the sorted boxes: box i is kept
    when no kept box before it overlaps it past the threshold. Each step
    is two device ops over the running count of kept overlaps, and
    nothing is read on the host, so a CUDA graph captures the whole call.
    """
    n = boxes.shape[0]
    k = int(max_output_size) if max_output_size is not None else n
    dev = boxes.device
    if n == 0:
        return (torch.full((k,), -1, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    b = boxes
    if category_idxs is not None:
        b = _class_shift(b, category_idxs)
    order = torch.argsort(-scores, stable=True)
    bs = b[order]
    idx = torch.arange(n, device=dev)
    # over[i, j]: box i, if kept, suppresses the later box j (the IoU
    # matrix is symmetric)
    over = ((_pairwise_iou(bs, bs, eps=1e-12) > float(iou_threshold))
            & (idx[:, None] < idx[None, :])).to(torch.float32)
    hits = torch.zeros(n, dtype=torch.float32, device=dev)
    for i in range(n):
        hits.addcmul_(over[i], (hits[i] == 0).to(torch.float32))
    keep = hits == 0
    priority = torch.where(keep, n - idx, -1)
    slots = torch.argsort(-priority, stable=True)[:min(k, n)]
    out_idx = torch.where(keep[slots], order[slots], -1).to(torch.int32)
    if k > n:
        out_idx = torch.cat([out_idx, torch.full(
            (k - n,), -1, dtype=torch.int32, device=dev)])
    num_valid = keep.sum().clamp(max=k).to(torch.int32)
    return out_idx, num_valid


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS with a result of dynamic length: the kept indices
    (int64) in descending score order, on the boxes' device. The loop
    runs on the host over numpy, as the reference's does, for CUDA
    tensors too (a copy to the host and back); it refuses to run while a
    CUDA graph is being captured, where ``nms_padded`` is the op to use.
    Ties of score keep the lower index first (a stable sort)."""
    if categories is not None:
        raise NotImplementedError(
            "categories: the reference accepts it but never reads it "
            "(ROADMAP C-ref-17); the port does not diverge silently")
    if boxes.is_cuda and torch.cuda.is_current_stream_capturing():
        raise TypeError(
            "nms returns a dynamic-length index list and cannot run inside "
            "a captured graph; use paddle.vision.ops.nms_padded "
            "(fixed-size, capturable) in compiled detection pipelines")
    b = boxes.detach().cpu().numpy()
    s = (scores.detach().cpu().numpy() if scores is not None
         else np.arange(len(b), 0, -1, dtype=np.float32))
    if category_idxs is not None:
        cat = category_idxs.detach().cpu().numpy().astype(b.dtype)
        span = float(np.abs(b).max()) + 1.0
        b = b + (cat * 2.0 * span)[:, None]
    order = np.argsort(-s, kind="stable")
    keep = []
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        xx1 = np.maximum(b[i, 0], b[order[1:], 0])
        yy1 = np.maximum(b[i, 1], b[order[1:], 1])
        xx2 = np.minimum(b[i, 2], b[order[1:], 2])
        yy2 = np.minimum(b[i, 3], b[order[1:], 3])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        iou = inter / (area[i] + area[order[1:]] - inter)
        order = order[1:][iou <= iou_threshold]
    keep = np.asarray(keep, dtype=np.int64)
    if top_k is not None:
        keep = keep[:top_k]
    return torch.as_tensor(keep, device=boxes.device)


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _bilinear_gather(table, base, py, px, H, W):
    """Bilinear samples of a channels-last table (rows of C values, one
    row a pixel; image b's pixel (y, x) at row base + y * W + x) at the
    fractional points (py, px) of any shape S: returns (*S, C). A corner
    outside [0, H - 1] x [0, W - 1] has weight 0."""
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    dy = py - y0
    dx = px - x0
    out = 0.0
    for oy, wy in ((y0, 1.0 - dy), (y0 + 1.0, dy)):
        for ox, wx in ((x0, 1.0 - dx), (x0 + 1.0, dx)):
            valid = (oy >= 0) & (oy <= H - 1) & (ox >= 0) & (ox <= W - 1)
            iy = oy.clamp(0, H - 1).long()
            ix = ox.clamp(0, W - 1).long()
            w = torch.where(valid, wy * wx, torch.zeros_like(wy))
            out = out + table[base + iy * W + ix] * w[..., None]
    return out


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=1,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 (``mask=None``) and v2. x (N, Cin, H, W);
    offset (N, 2 * dg * kh * kw, Hout, Wout), (dy, dx) interleaved per
    kernel point; mask (N, dg * kh * kw, Hout, Wout); weight (Cout,
    Cin / groups, kh, kw). The bilinear samples form an im2col tensor,
    contracted with the weight by one grouped matmul; the bias is added
    after. ``deformable_groups`` and ``groups`` are independent."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    kh, kw = int(weight.shape[2]), int(weight.shape[3])
    dg, G = int(deformable_groups), int(groups)
    N, Cin, H, W = x.shape
    Cout = weight.shape[0]
    Hout = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wout = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    K, L = kh * kw, Hout * Wout
    dev = x.device
    oy = (torch.arange(Hout, device=dev) * sh - ph)[None, :, None]
    ox = (torch.arange(Wout, device=dev) * sw - pw)[None, None, :]
    ky = (torch.arange(kh, device=dev) * dh).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * dw).repeat(kh)
    base_y = (oy + ky[:, None, None]).to(x.dtype)          # (K, Hout, 1)
    base_x = (ox + kx[:, None, None]).to(x.dtype)          # (K, 1, Wout)
    o = offset.reshape(N, dg, K, 2, Hout, Wout)
    py = base_y + o[:, :, :, 0]                            # (N, dg, K, ...)
    px = base_x + o[:, :, :, 1]
    cg = Cin // dg
    # one image of cg channels per (n, deformable group), channels-last
    table = x.reshape(N * dg, cg, H * W).transpose(1, 2).reshape(-1, cg)
    base = (torch.arange(N * dg, device=dev) * (H * W)).reshape(N, dg, 1,
                                                                1, 1)
    cols = _bilinear_gather(table, base, py, px, H, W)   # (N,dg,K,Ho,Wo,cg)
    if mask is not None:
        cols = cols * mask.reshape(N, dg, K, Hout, Wout, 1)
    # (N, Cin, K, L) -> (N, G, Cin / G * K, L), against w (G, Cout / G, .)
    cols = cols.reshape(N, dg, K, L, cg).permute(0, 1, 4, 2, 3) \
        .reshape(N, G, (Cin // G) * K, L)
    wg = weight.reshape(G, Cout // G, (Cin // G) * K)
    out = torch.matmul(wg, cols).reshape(N, Cout, Hout, Wout)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def _div(a, n):
    """``a / n`` as a true division on ``a``'s device. PyTorch's CUDA
    kernel multiplies by the reciprocal of a Python number, one ulp off
    the host's quotient: a bin bound's floor or ceil turns that ulp into
    another bin, and a sample position's into another bilinear value."""
    return a / torch.full((), n, dtype=a.dtype, device=a.device)


def _roi_batch_index(boxes_num, n_rois):
    """The image of each RoI (boxes stacked image after image), on the
    device: a searchsorted over the cumulative counts."""
    ends = torch.cumsum(boxes_num, 0)
    return torch.searchsorted(
        ends, torch.arange(n_rois, device=ends.device, dtype=ends.dtype),
        right=True)


def _channels_last_table(x):
    """x (N, C, H, W) as (N * H * W, C): one row a pixel."""
    N, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(N * H * W, C)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign: boxes (R, 4) xyxy stacked over the batch, boxes_num (N,)
    RoIs an image; returns (R, C, ph, pw). Each bin averages sr x sr
    bilinear samples, sr = ``sampling_ratio``, or 2 when it is <= 0
    (ROADMAP C-ref-19)."""
    ph, pw = _pair(output_size)
    sr = int(sampling_ratio) if sampling_ratio and sampling_ratio > 0 else 2
    N, C, H, W = x.shape
    R = boxes.shape[0]
    dev = x.device
    bidx = _roi_batch_index(boxes_num, R)
    b = boxes * spatial_scale - (0.5 if aligned else 0.0)
    w_ = b[:, 2] - b[:, 0]
    h_ = b[:, 3] - b[:, 1]
    if not aligned:
        w_ = w_.clamp(min=1.0)
        h_ = h_.clamp(min=1.0)
    gy = _div(torch.arange(ph * sr, device=dev, dtype=x.dtype) + 0.5, sr)
    gx = _div(torch.arange(pw * sr, device=dev, dtype=x.dtype) + 0.5, sr)
    py = b[:, 1, None] + _div(h_, ph)[:, None] * gy[None]    # (R, ph * sr)
    px = b[:, 0, None] + _div(w_, pw)[:, None] * gx[None]    # (R, pw * sr)
    s = _bilinear_gather(_channels_last_table(x),
                         (bidx * (H * W))[:, None, None],
                         py[:, :, None].expand(R, ph * sr, pw * sr),
                         px[:, None, :].expand(R, ph * sr, pw * sr), H, W)
    s = s.reshape(R, ph, sr, pw, sr, C).mean(dim=(2, 4))
    return s.permute(0, 3, 1, 2)


# the most elements one gather of bin windows holds (256 MiB of f32)
_GATHER_ELEMS = 1 << 26


def _bin_reduce(table, row_base, hs, he, ws, we, H, W, reduce):
    """``reduce(values, inside)`` over the window of every bin: values
    (r, ph, pw, Eh, Ew, C) gathered from a table of pixel rows (bin (r, i,
    j)'s pixel (y, x) at row row_base[r, i, j] + y * W + x), inside (r, ph,
    pw, Eh, Ew) whether each lies in the bin [hs, he) x [ws, we); the
    window is as large as the call's largest bin (one host read), and the
    RoIs go in chunks of at most _GATHER_ELEMS gathered values. Returns
    (R, ph, pw, C)."""
    hs, he, ws, we = (v.long() for v in (hs, he, ws, we))
    (R, ph), pw, C = hs.shape, ws.shape[1], table.shape[1]
    if R == 0:
        return table.new_zeros((0, ph, pw, C))
    eh, ew = (max(e, 1) for e in torch.stack(
        [(he - hs).max(), (we - ws).max()]).tolist())
    th = torch.arange(eh, device=hs.device)
    tw = torch.arange(ew, device=hs.device)
    chunk = max(1, _GATHER_ELEMS // (ph * pw * eh * ew * C))
    outs = []
    for r0 in range(0, R, chunk):
        sl = slice(r0, r0 + chunk)
        rows = hs[sl, :, None] + th                      # (r, ph, Eh)
        cols = ws[sl, :, None] + tw                      # (r, pw, Ew)
        inside = (rows < he[sl, :, None])[:, :, None, :, None] \
            & (cols < we[sl, :, None])[:, None, :, None, :]
        idx = row_base[sl] + rows.clamp(max=H - 1)[:, :, None, :, None] * W \
            + cols.clamp(max=W - 1)[:, None, :, None, :]
        outs.append(reduce(table[idx], inside))
    return torch.cat(outs)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """RoIPool: the max over Caffe-style quantized bins (rounded box
    corners, floor/ceil bin bounds, possibly overlapping); an empty bin
    gives 0. Returns (R, C, ph, pw)."""
    ph, pw = _pair(output_size)
    N, C, H, W = x.shape
    R = boxes.shape[0]
    bidx = _roi_batch_index(boxes_num, R)
    x1, y1, x2, y2 = torch.round(boxes * spatial_scale).unbind(1)
    rh = (y2 - y1 + 1).clamp(min=1.0)
    rw = (x2 - x1 + 1).clamp(min=1.0)

    def bounds(extent, nbins, start):
        i = torch.arange(nbins, device=x.device, dtype=x.dtype)
        size = _div(extent, nbins)
        lo = torch.floor(i * size[:, None]) + start[:, None]
        hi = torch.ceil((i + 1) * size[:, None]) + start[:, None]
        return lo, hi

    hs, he = (v.clamp(0, H) for v in bounds(rh, ph, y1))
    ws, we = (v.clamp(0, W) for v in bounds(rw, pw, x1))
    neg_inf = torch.full((), float("-inf"), dtype=x.dtype, device=x.device)

    def bin_max(vals, inside):
        return torch.where(inside[..., None], vals, neg_inf).amax(dim=(3, 4))
    out = _bin_reduce(_channels_last_table(x),
                      (bidx * (H * W))[:, None, None, None, None],
                      hs, he, ws, we, H, W, bin_max)     # (R, ph, pw, C)
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return out.permute(0, 3, 1, 2)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Position-sensitive RoI pooling: x has C = out_channels * ph * pw
    channels; output (R, out_channels, ph, pw), where (c, i, j) averages
    input channel c * ph * pw + i * pw + j over bin (i, j). A C that is
    not a multiple of ph * pw raises."""
    ph, pw = _pair(output_size)
    N, C, H, W = x.shape
    if C % (ph * pw):
        raise ValueError(
            f"psroi_pool needs input channels = output channels * "
            f"{ph} * {pw}, got {C}")
    oc = C // (ph * pw)
    R = boxes.shape[0]
    bidx = _roi_batch_index(boxes_num, R)
    r = torch.round(boxes)
    x1, y1 = r[:, 0] * spatial_scale, r[:, 1] * spatial_scale
    x2 = (r[:, 2] + 1.0) * spatial_scale
    y2 = (r[:, 3] + 1.0) * spatial_scale
    bin_h = _div((y2 - y1).clamp(min=0.1), ph)
    bin_w = _div((x2 - x1).clamp(min=0.1), pw)
    i = torch.arange(ph, device=x.device, dtype=x.dtype)[None]
    j = torch.arange(pw, device=x.device, dtype=x.dtype)[None]
    hs = torch.floor(y1[:, None] + i * bin_h[:, None]).clamp(0, H)
    he = torch.ceil(y1[:, None] + (i + 1) * bin_h[:, None]).clamp(0, H)
    ws = torch.floor(x1[:, None] + j * bin_w[:, None]).clamp(0, W)
    we = torch.ceil(x1[:, None] + (j + 1) * bin_w[:, None]).clamp(0, W)
    # one table per bin position: (N, ph * pw, H * W) rows of oc channels
    table = x.reshape(N, oc, ph * pw, H * W).permute(0, 2, 3, 1) \
        .reshape(-1, oc)
    pos = (torch.arange(ph, device=x.device)[:, None] * pw
           + torch.arange(pw, device=x.device)[None, :])     # (ph, pw)
    row_base = ((bidx[:, None, None] * (ph * pw) + pos) * (H * W))
    tot = _bin_reduce(
        table, row_base[..., None, None], hs, he, ws, we, H, W,
        lambda vals, inside: (vals * inside[..., None].to(x.dtype))
        .sum(dim=(3, 4)))
    area = ((he - hs)[:, :, None] * (we - ws)[:, None, :])[..., None]
    out = torch.where(area > 0, tot / area.clamp(min=1.0),
                      torch.zeros_like(tot))
    return out.permute(0, 3, 1, 2)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.005,
             downsample_ratio=32, clip_bbox=True, name=None, scale_x_y=1.0):
    """YOLOv3 head decode: x (N, na * (5 + class_num), H, W), img_size
    (N, 2) as (h, w). Returns boxes (N, na * H * W, 4) xyxy in image
    coordinates and scores (N, na * H * W, class_num), anchor-major (a *
    H * W + i * W + j). A box whose confidence is under ``conf_thresh``
    is zeroed; with ``clip_bbox`` boxes are clipped to img_size - 1."""
    anchors = np.asarray(anchors, dtype=np.float32).reshape(-1, 2)
    na = anchors.shape[0]
    N, _, H, W = x.shape
    dt, dev = x.dtype, x.device
    p = x.reshape(N, na, 5 + class_num, H, W)
    gx = torch.arange(W, dtype=dt, device=dev)[None, None, None, :]
    gy = torch.arange(H, dtype=dt, device=dev)[None, None, :, None]
    bias = -0.5 * (scale_x_y - 1.0)
    cx = (torch.sigmoid(p[:, :, 0]) * scale_x_y + bias + gx) / W
    cy = (torch.sigmoid(p[:, :, 1]) * scale_x_y + bias + gy) / H
    aw = torch.tensor(anchors[:, 0], dtype=dt, device=dev)[None, :, None,
                                                           None]
    ah = torch.tensor(anchors[:, 1], dtype=dt, device=dev)[None, :, None,
                                                           None]
    bw = torch.exp(p[:, :, 2]) * aw / (downsample_ratio * W)
    bh = torch.exp(p[:, :, 3]) * ah / (downsample_ratio * H)
    conf = torch.sigmoid(p[:, :, 4])
    conf = torch.where(conf < conf_thresh, torch.zeros_like(conf), conf)
    probs = torch.sigmoid(p[:, :, 5:]) * conf[:, :, None]
    imh = img_size[:, 0].to(dt)[:, None, None, None]
    imw = img_size[:, 1].to(dt)[:, None, None, None]
    x1 = (cx - bw / 2) * imw
    y1 = (cy - bh / 2) * imh
    x2 = (cx + bw / 2) * imw
    y2 = (cy + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros((), dtype=dt, device=dev)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(N, -1, 4)
    boxes = torch.where((conf <= 0).reshape(N, -1, 1),
                        torch.zeros_like(boxes), boxes)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, -1, class_num)
    return boxes, scores


def _bce(logit, label):
    return logit.clamp(min=0) - logit * label \
        + torch.log1p(torch.exp(-logit.abs()))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=False, name=None, scale_x_y=1.0):
    """YOLOv3 training loss, (N,) per image. Each ground-truth box (cx, cy,
    w, h relative to the input) takes its best anchor by wh-IoU; if that
    anchor is one of this head's (``anchor_mask``), its targets go to its
    cell. A box with zero width or height is padding and goes nowhere.
    Objectness negatives whose best IoU with a box exceeds
    ``ignore_thresh`` are ignored. BCE on xy, L1 on wh (both scaled by
    (2 - w * h) * gt_score; gt_score defaults to ones), BCE on objectness
    and on the (optionally smoothed) classes."""
    all_anchors = np.asarray(anchors, dtype=np.float32).reshape(-1, 2)
    amask = [int(a) for a in np.asarray(anchor_mask).reshape(-1)]
    head = all_anchors[amask]
    na = len(amask)
    N, _, H, W = x.shape
    B = gt_box.shape[1]
    dt, dev = x.dtype, x.device
    gtb = gt_box.to(dt)
    gts = (torch.ones((N, B), dtype=dt, device=dev) if gt_score is None
           else gt_score.to(dt))
    p = x.reshape(N, na, 5 + class_num, H, W)
    in_w, in_h = W * downsample_ratio, H * downsample_ratio
    gw = gtb[:, :, 2] * in_w
    gh = gtb[:, :, 3] * in_h
    aw = torch.tensor(all_anchors[:, 0], dtype=dt, device=dev)
    ah = torch.tensor(all_anchors[:, 1], dtype=dt, device=dev)
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None],
                                                             ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    best = torch.argmax(inter / union.clamp(min=1e-9), dim=-1)    # (N, B)
    local = torch.full_like(best, -1)
    for li, gi in enumerate(amask):
        local = torch.where(best == gi, torch.full_like(best, li), local)
    valid = (gtb[:, :, 2] > 0) & (gtb[:, :, 3] > 0) & (local >= 0)
    gi = (gtb[:, :, 0] * W).to(torch.int32).clamp(0, W - 1).long()
    gj = (gtb[:, :, 1] * H).to(torch.int32).clamp(0, H - 1).long()
    la = local.clamp(0, na - 1)
    # padding and unassigned boxes go to a spare anchor slot, dropped
    la_s = torch.where(valid, la, torch.full_like(la, na))
    nidx = torch.arange(N, device=dev)[:, None].expand(N, B)

    def scatter(vals):
        v = torch.where(valid.reshape(valid.shape + (1,) * (vals.ndim - 2)),
                        vals, torch.zeros_like(vals))
        g = torch.zeros((N, na + 1, H, W) + vals.shape[2:], dtype=dt,
                        device=dev)
        return g.index_put((nidx, la_s, gj, gi), v)[:, :na]

    tx = gtb[:, :, 0] * W - gi
    ty = gtb[:, :, 1] * H - gj
    haw = torch.tensor(head[:, 0], dtype=dt, device=dev)
    hah = torch.tensor(head[:, 1], dtype=dt, device=dev)
    tw = torch.log(gw.clamp(min=1e-9) / haw[la])
    th = torch.log(gh.clamp(min=1e-9) / hah[la])
    tscale = (2.0 - gtb[:, :, 2] * gtb[:, :, 3]) * gts
    obj = scatter(torch.ones_like(tx))
    txg, tyg, twg, thg, tsg = (scatter(v) for v in (tx, ty, tw, th, tscale))
    onehot = (gt_label.long()[..., None]
              == torch.arange(class_num, device=dev)).to(dt) \
        * valid[..., None].to(dt)
    if use_label_smooth:
        delta = 1.0 / max(class_num, 1)
        onehot = onehot * (1.0 - delta) + delta / class_num \
            * valid[..., None].to(dt)
    clsg = scatter(onehot)                               # (N, na, H, W, cls)
    # the ignore mask: predicted boxes (decoded as yolo_box does) whose
    # best IoU with a ground-truth box exceeds ignore_thresh
    b_xy = -0.5 * (scale_x_y - 1.0)
    gx_ = torch.arange(W, dtype=dt, device=dev)[None, None, None, :]
    gy_ = torch.arange(H, dtype=dt, device=dev)[None, None, :, None]
    px = (torch.sigmoid(p[:, :, 0]) * scale_x_y + b_xy + gx_) / W
    py = (torch.sigmoid(p[:, :, 1]) * scale_x_y + b_xy + gy_) / H
    pw_ = torch.exp(p[:, :, 2].clamp(-10, 10)) * haw[None, :, None,
                                                     None] / in_w
    ph_ = torch.exp(p[:, :, 3].clamp(-10, 10)) * hah[None, :, None,
                                                     None] / in_h
    g = gtb[:, :, None, None, None, :]                   # (N, B, 1, 1, 1, 4)
    gx1, gx2 = g[..., 0] - g[..., 2] / 2, g[..., 0] + g[..., 2] / 2
    gy1, gy2 = g[..., 1] - g[..., 3] / 2, g[..., 1] + g[..., 3] / 2
    px1, px2 = (px - pw_ / 2)[:, None], (px + pw_ / 2)[:, None]
    py1, py2 = (py - ph_ / 2)[:, None], (py + ph_ / 2)[:, None]
    iw = (torch.minimum(px2, gx2) - torch.maximum(px1, gx1)).clamp(min=0)
    ih = (torch.minimum(py2, gy2) - torch.maximum(py1, gy1)).clamp(min=0)
    inter = iw * ih
    uni = (pw_ * ph_)[:, None] + g[..., 2] * g[..., 3] - inter
    iou = torch.where(g[..., 2] > 0, inter / uni.clamp(min=1e-9),
                      torch.zeros_like(inter))
    best_iou = iou.amax(dim=1)                           # (N, na, H, W)
    noobj = (1.0 - obj) * (best_iou <= ignore_thresh).to(dt)
    # xy labels live in sigmoid space: the decode is sigmoid(t) * s + bias
    txg_l = ((txg - b_xy) / scale_x_y).clamp(0.0, 1.0)
    tyg_l = ((tyg - b_xy) / scale_x_y).clamp(0.0, 1.0)
    lxy = (_bce(p[:, :, 0], txg_l) + _bce(p[:, :, 1], tyg_l)) * tsg * obj
    lwh = ((p[:, :, 2] - twg).abs() + (p[:, :, 3] - thg).abs()) * tsg * obj
    lobj = _bce(p[:, :, 4], obj) * (obj + noobj)
    lcls = (_bce(p[:, :, 5:].permute(0, 1, 3, 4, 2), clsg)
            * obj[..., None]).sum(-1)
    return (lxy + lwh + lobj + lcls).sum(dim=(1, 2, 3))


class DeformConv2D(_nn.Layer):
    """The deformable conv layer: holds weight and bias; offset (and the
    mask, for v2) are inputs of ``forward``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, **factory):
        super().__init__(**factory)
        kh, kw = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        self.weight = self.create_parameter(
            [out_channels, in_channels // groups, kh, kw], attr=weight_attr)
        self.bias = self.create_parameter([out_channels], attr=bias_attr,
                                          is_bias=True)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self._stride,
                             self._padding, self._dilation,
                             self._deformable_groups, self._groups, mask)


class RoIAlign(_nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0, **factory):
        super().__init__(**factory)
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num, aligned=True):
        return roi_align(x, boxes, boxes_num, self._output_size,
                         self._spatial_scale, aligned=aligned)


class RoIPool(_nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0, **factory):
        super().__init__(**factory)
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._output_size,
                        self._spatial_scale)


class PSRoIPool(_nn.Layer):
    def __init__(self, output_size, spatial_scale=1.0, **factory):
        super().__init__(**factory)
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._output_size,
                          self._spatial_scale)


def read_file(filename, name=None):
    """A file's bytes as a uint8 tensor on the current device (the card by
    default)."""
    with open(filename, "rb") as f:
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return torch.as_tensor(data.copy(), device=resolve_device(None))


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode a JPEG byte tensor to (C, H, W) uint8 on the host with
    Pillow, on ``x``'s device; ``mode`` "rgb" or "gray" converts. Without
    Pillow it raises, as the reference does."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decode_jpeg requires Pillow on the host") from e
    raw = bytes(x.detach().cpu().numpy().astype(np.uint8))
    img = Image.open(io.BytesIO(raw))
    if mode.lower() == "rgb":
        img = img.convert("RGB")
    elif mode.lower() in ("gray", "grey", "l"):
        img = img.convert("L")
    arr = np.asarray(img, dtype=np.uint8)
    arr = arr[None] if arr.ndim == 2 else np.transpose(arr, (2, 0, 1))
    return torch.as_tensor(arr.copy(), device=x.device)
