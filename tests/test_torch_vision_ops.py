"""paddle.vision.ops of the PyTorch/CUDA port against the JAX reference on
the host: every op and layer on the same seeded inputs, with the grads of
deform_conv2d, roi_align, roi_pool, psroi_pool and yolo_loss. Gathers,
pools and losses agree within 1e-5 (f32, other summation orders); indices
and counts are equal. The C-ref-19 pins hold the reference's bilinear
border rule and its fixed sampling ratio, and nms's stable tie rule; the
C-ref-17 pin holds nms's unread ``categories``.
"""
import io

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.vision import ops as rops
from paddle_tpu_torch.vision import ops as pops

TOL = 1e-5


def rt(a, grad=False):
    t = ref.to_tensor(np.asarray(a))
    if grad:
        t.stop_gradient = False
    return t


def tt(a, grad=False):
    t = torch.tensor(np.asarray(a))
    return t.requires_grad_() if grad else t


def val(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = val(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= tol * scale, \
        float(np.abs(got - want).max())


def both_with_grads(fn_ref, fn_pt, args, grad_idx, seed=0):
    """Each package's output and the grads of sum(out * w) with respect to
    the arguments at ``grad_idx``."""
    ra = [rt(a, i in grad_idx) for i, a in enumerate(args)]
    pa = [tt(a, i in grad_idx) for i, a in enumerate(args)]
    rout, pout = fn_ref(*ra), fn_pt(*pa)
    w = np.random.RandomState(seed).randn(*val(rout).shape).astype("float32")
    (rout * rt(w)).sum().backward()
    (pout * torch.tensor(w)).sum().backward()
    return (rout, pout, [val(ra[i].grad) for i in grad_idx],
            [pa[i].grad for i in grad_idx])


def test_box_iou():
    rng = np.random.RandomState(0)
    xy = rng.rand(7, 2).astype("float32") * 8
    b1 = np.concatenate([xy, xy + rng.rand(7, 2).astype("float32") * 4 + .2],
                        1)
    b2 = b1[::-1].copy() + 0.5
    close(pops.box_iou(tt(b1), tt(b2)), rops.box_iou(rt(b1), rt(b2)))


# -- NMS ---------------------------------------------------------------------
def boxes_scores(n=24, seed=0):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2).astype("float32") * 8
    wh = rng.rand(n, 2).astype("float32") * 4 + 0.2
    return (np.concatenate([xy, xy + wh], axis=1),
            rng.permutation(n).astype("float32") / n)   # distinct scores


@pytest.mark.parametrize("thr", [0.2, 0.4, 0.7])
@pytest.mark.parametrize("classes", [False, True])
def test_nms_matches_reference(thr, classes):
    b, s = boxes_scores(seed=int(thr * 10))
    cat = (np.random.RandomState(3).randint(0, 3, len(b)).astype("int64")
           if classes else None)
    kw = {"category_idxs": rt(cat)} if classes else {}
    want = val(rops.nms(rt(b), thr, rt(s), **kw))
    got = pops.nms(tt(b), thr, tt(s),
                   **({"category_idxs": tt(cat)} if classes else {}))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # top_k, and the default scores (earlier boxes first)
    np.testing.assert_array_equal(
        pops.nms(tt(b), thr, tt(s), top_k=3).numpy(),
        val(rops.nms(rt(b), thr, rt(s), top_k=3)))
    np.testing.assert_array_equal(pops.nms(tt(b), thr).numpy(),
                                  val(rops.nms(rt(b), thr)))


def test_nms_categories_raises_and_tie_rule():
    """C-ref-17: ``categories`` is never read by the reference. C-ref-19:
    equal scores keep the lower index first (a stable sort)."""
    b, _ = boxes_scores(n=4)
    with pytest.raises(NotImplementedError, match="C-ref-17"):
        pops.nms(tt(b), 0.5, categories=[0, 1])
    far = np.asarray([[0, 0, 1, 1], [5, 5, 6, 6], [0, 0, 1, 1],
                      [9, 9, 10, 10]], "float32")
    got = pops.nms(tt(far), 0.5, tt(np.ones(4, "float32")))
    np.testing.assert_array_equal(got.numpy(), [0, 1, 3])


@pytest.mark.parametrize("k,thr,classes",
                         [(None, 0.4, False), (8, 0.4, False),
                          (40, 0.3, False), (10, 0.5, True)])
def test_nms_padded_matches_reference(k, thr, classes):
    b, s = boxes_scores(seed=5)
    cat = np.random.RandomState(4).randint(0, 4, len(b)).astype("int64")
    rk = {"category_idxs": rt(cat)} if classes else {}
    pk = {"category_idxs": tt(cat)} if classes else {}
    ridx, rnv = rops.nms_padded(rt(b), rt(s), thr, k, **rk)
    pidx, pnv = pops.nms_padded(tt(b), tt(s), thr, k, **pk)
    assert pidx.dtype == pnv.dtype == torch.int32 and pnv.dim() == 0
    np.testing.assert_array_equal(pidx.numpy(), val(ridx))
    assert int(pnv) == int(val(rnv))
    host = pops.nms(tt(b), thr, tt(s), **pk).numpy()
    np.testing.assert_array_equal(pidx.numpy()[:int(pnv)],
                                  host[:len(pidx)])


def test_nms_padded_edge_cases():
    """tests/test_vision_ops.py::test_padded_contract_edge_cases on the
    port: k past n pads with -1; no boxes give all padding."""
    b, s = boxes_scores(n=2, seed=9)
    idx, nv = pops.nms_padded(tt(b), tt(s), iou_threshold=0.5,
                              max_output_size=5)
    assert idx.shape == (5,) and (idx[int(nv):] == -1).all()
    ridx, _ = rops.nms_padded(rt(b), rt(s), 0.5, 5)
    np.testing.assert_array_equal(idx.numpy(), val(ridx))
    idx0, nv0 = pops.nms_padded(tt(np.zeros((0, 4), "float32")),
                                tt(np.zeros((0,), "float32")),
                                max_output_size=4)
    assert idx0.tolist() == [-1, -1, -1, -1] and int(nv0) == 0


# -- deformable conv ---------------------------------------------------------
@pytest.mark.parametrize("dg,groups,v2,stride,dil", [
    (1, 1, False, 1, 1), (2, 1, True, 1, 1), (1, 2, True, 2, 1),
    (2, 2, False, 1, 2), (4, 2, True, 1, 1)])
def test_deform_conv2d_and_grads(dg, groups, v2, stride, dil):
    rng = np.random.RandomState(dg * 10 + groups)
    N, Cin, Cout, H, W, k, pad = 2, 8, 6, 7, 6, 3, 1
    Ho = (H + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    Wo = (W + 2 * pad - (dil * (k - 1) + 1)) // stride + 1
    args = [rng.randn(N, Cin, H, W).astype("float32"),
            (rng.randn(N, 2 * dg * k * k, Ho, Wo) * 1.5).astype("float32"),
            rng.randn(Cout, Cin // groups, k, k).astype("float32"),
            rng.randn(Cout).astype("float32")]
    if v2:
        args.append(rng.uniform(0, 1, (N, dg * k * k, Ho, Wo))
                    .astype("float32"))
    kw = dict(stride=stride, padding=pad, dilation=dil,
              deformable_groups=dg, groups=groups)

    def run(mod):
        return lambda x, o, w, b, *m: mod.deform_conv2d(
            x, o, w, b, mask=m[0] if m else None, **kw)
    grads = list(range(len(args)))
    rout, pout, rg, pg = both_with_grads(run(rops), run(pops), args, grads)
    close(pout, rout)
    for g_p, g_r in zip(pg, rg):
        close(g_p, g_r)


def test_deform_conv2d_layer_matches_reference():
    rng = np.random.RandomState(7)
    rl = rops.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2)
    pl = pops.DeformConv2D(4, 6, 3, padding=1, deformable_groups=2,
                           device="cpu")
    sd = {k: np.asarray(v._val) for k, v in rl.state_dict().items()}
    assert sorted(sd) == sorted(pl.state_dict()) == ["bias", "weight"]
    assert pl.set_state_dict(sd) == ([], [])
    x = rng.randn(1, 4, 5, 5).astype("float32")
    off = (rng.randn(1, 36, 5, 5) * 0.5).astype("float32")
    close(pl(tt(x), tt(off)), rl(rt(x), rt(off)))


# -- RoI ops -----------------------------------------------------------------
def roi_case(seed=3, C=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, C, 10, 12).astype("float32")
    boxes = np.asarray([[1.0, 1.0, 6.0, 7.0], [0.0, 0.0, 11.5, 9.5],
                        [2.2, 3.1, 4.9, 4.0], [3.0, 2.0, 9.0, 8.0],
                        [5.5, 0.5, 11.9, 9.9]], "float32")
    return x, boxes, np.asarray([2, 3], "int32")


@pytest.mark.parametrize("aligned,sr,scale", [(True, 2, 1.0), (False, 2, 1.0),
                                              (True, 3, 0.5), (False, -1, 0.8)])
def test_roi_align_and_grads(aligned, sr, scale):
    x, boxes, bn = roi_case()

    def run(mod):
        return lambda xv, bx, n: mod.roi_align(xv, bx, n, (3, 2), scale, sr,
                                               aligned)
    rout, pout, rg, pg = both_with_grads(run(rops), run(pops),
                                         [x, boxes, bn], [0, 1])
    close(pout, rout)
    for g_p, g_r in zip(pg, rg):
        close(g_p, g_r)


def test_roi_align_reference_conventions_pinned():
    """C-ref-19: a box on the border keeps the DCN zero-weight corners (not
    upstream Paddle's clamp of a sample in (-1, 0] to 0), and
    sampling_ratio <= 0 takes 2 samples a bin."""
    x = np.arange(16, dtype="float32").reshape(1, 1, 4, 4) + 1.0
    box = np.asarray([[-0.5, -0.5, 0.5, 0.5]], "float32")
    n = np.asarray([1], "int32")
    got = pops.roi_align(tt(x), tt(box), tt(n), 1, aligned=False,
                         sampling_ratio=2)
    close(got, rops.roi_align(rt(x), rt(box), rt(n), 1, aligned=False,
                              sampling_ratio=2))
    # samples at -0.25 and 0.25 on each axis: a corner at -1 weighs 0, so
    # the (-0.25, -0.25) sample is 0.5625 * x[0, 0], not x[0, 0]
    want = (0.5625 * 1 + 0.75 * (0.25 * 2 + 0.75 * 1)
            + 0.75 * (0.25 * 5 + 0.75 * 1)
            + (0.0625 * 6 + 0.1875 * 2 + 0.1875 * 5 + 0.5625 * 1)) / 4
    assert abs(float(got) - want) < 1e-6
    xx, boxes, bn = roi_case()
    a = pops.roi_align(tt(xx), tt(boxes), tt(bn), 2, sampling_ratio=-1)
    b = pops.roi_align(tt(xx), tt(boxes), tt(bn), 2, sampling_ratio=2)
    assert torch.equal(a, b)


@pytest.mark.parametrize("scale,size", [(1.0, (2, 3)), (0.5, 3), (0.7, 1)])
def test_roi_pool_and_grads(scale, size):
    x, boxes, bn = roi_case(4)

    def run(mod):
        return lambda xv, bx, n: mod.roi_pool(xv, bx, n, size, scale)
    rout, pout, rg, pg = both_with_grads(run(rops), run(pops),
                                         [x, boxes, bn], [0])
    close(pout, rout)
    close(pg[0], rg[0])


@pytest.mark.parametrize("scale,size", [(1.0, (2, 2)), (0.5, (3, 2))])
def test_psroi_pool_and_grads(scale, size):
    ph, pw = (size, size) if isinstance(size, int) else size
    x, boxes, bn = roi_case(5, C=3 * ph * pw)

    def run(mod):
        return lambda xv, bx, n: mod.psroi_pool(xv, bx, n, size, scale)
    rout, pout, rg, pg = both_with_grads(run(rops), run(pops),
                                         [x, boxes, bn], [0])
    assert pout.shape == (5, 3, ph, pw)
    close(pout, rout)
    close(pg[0], rg[0])


def test_bin_gathers_in_chunks_match_one_gather(monkeypatch):
    """roi_pool and psroi_pool gather the RoIs in chunks that bound the
    window's memory: chunks of one RoI give the one-gather result, and no
    RoIs give an empty result."""
    x, boxes, bn = roi_case(8, C=12)
    want = [pops.roi_pool(tt(x), tt(boxes), tt(bn), (2, 3), 0.7),
            pops.psroi_pool(tt(x), tt(boxes), tt(bn), 2, 0.5)]
    monkeypatch.setattr(pops, "_GATHER_ELEMS", 1)
    got = [pops.roi_pool(tt(x), tt(boxes), tt(bn), (2, 3), 0.7),
           pops.psroi_pool(tt(x), tt(boxes), tt(bn), 2, 0.5)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    empty = pops.roi_pool(tt(x), tt(boxes[:0]), tt(bn * 0), 2)
    assert empty.shape == (0, 12, 2, 2)


def test_psroi_pool_refuses_wrong_channels():
    x, boxes, bn = roi_case(5, C=10)
    with pytest.raises(ValueError, match="channels"):
        pops.psroi_pool(tt(x), tt(boxes), tt(bn), 2)


def test_roi_layers_match_reference():
    x, boxes, bn = roi_case(6, C=8)
    for rl, pl in ((rops.RoIAlign((2, 2), 0.5), pops.RoIAlign((2, 2), 0.5)),
                   (rops.RoIPool(2, 0.5), pops.RoIPool(2, 0.5)),
                   (rops.PSRoIPool(2, 1.0), pops.PSRoIPool(2, 1.0))):
        close(pl(tt(x), tt(boxes), tt(bn)), rl(rt(x), rt(boxes), rt(bn)))
    close(pops.RoIAlign(2)(tt(x), tt(boxes), tt(bn), aligned=False),
          rops.RoIAlign(2)(rt(x), rt(boxes), rt(bn), aligned=False))


# -- YOLOv3 ------------------------------------------------------------------
@pytest.mark.parametrize("clip,thr,sxy", [(True, 0.0, 1.0), (True, 0.5, 1.05),
                                          (False, 0.3, 1.2)])
def test_yolo_box_matches_reference(clip, thr, sxy):
    rng = np.random.RandomState(4)
    N, H, W, cls, anchors = 2, 4, 5, 3, [10, 13, 16, 30, 33, 23]
    x = rng.randn(N, 3 * (5 + cls), H, W).astype("float32")
    img = np.asarray([[128, 160], [96, 64]], "int32")
    rb, rs = rops.yolo_box(rt(x), rt(img), anchors, cls, conf_thresh=thr,
                           downsample_ratio=32, clip_bbox=clip,
                           scale_x_y=sxy)
    pb, ps = pops.yolo_box(tt(x), tt(img), anchors, cls, conf_thresh=thr,
                           downsample_ratio=32, clip_bbox=clip,
                           scale_x_y=sxy)
    close(pb, rb)
    close(ps, rs)


def yolo_case(seed=5, N=2, H=4, W=4, cls=3, B=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, 3 * (5 + cls), H, W).astype("float32")
    gtb = np.zeros((N, B, 4), "float32")
    # distinct cells per image; the last box of each image is padding
    cells = [(0.3, 0.4), (0.7, 0.6), (0.1, 0.9), (0.55, 0.2)]
    for n in range(N):
        for b, (cx, cy) in enumerate(cells[:B - 1]):
            gtb[n, b] = [cx, cy, 0.05 + 0.3 * rng.rand(),
                         0.05 + 0.3 * rng.rand()]
    gtl = rng.randint(0, cls, (N, B)).astype("int64")
    score = rng.uniform(0.5, 1.0, (N, B)).astype("float32")
    return x, gtb, gtl, score


@pytest.mark.parametrize("smooth,score,sxy,mask", [
    (False, False, 1.0, [0, 1, 2]), (True, True, 1.1, [0, 1, 2]),
    (False, True, 1.0, [3, 4, 5])])
def test_yolo_loss_and_grads(smooth, score, sxy, mask):
    x, gtb, gtl, gts = yolo_case()
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    args = [x, gtb, gtl] + ([gts] if score else [])

    def run(mod):
        return lambda xv, b, lab, *s: mod.yolo_loss(
            xv, b, lab, anchors, mask, 3, ignore_thresh=0.5,
            downsample_ratio=32, gt_score=s[0] if s else None,
            use_label_smooth=smooth, scale_x_y=sxy)
    rout, pout, rg, pg = both_with_grads(run(rops), run(pops), args, [0])
    assert pout.shape == (2,)
    close(pout, rout)
    close(pg[0], rg[0])


# -- file IO -----------------------------------------------------------------
def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(0)
    img = (rng.rand(12, 10, 3) * 255).astype("uint8")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    path = tmp_path / "x.jpg"
    path.write_bytes(buf.getvalue())
    before = pt.get_device()
    pt.set_device("cpu")
    try:
        raw = pops.read_file(str(path))
    finally:
        pt.set_device(before)
    want = rops.read_file(str(path))
    assert raw.dtype == torch.uint8
    np.testing.assert_array_equal(raw.numpy(), val(want))
    for mode in ("unchanged", "rgb", "gray"):
        got = pops.decode_jpeg(raw, mode=mode)
        np.testing.assert_array_equal(got.numpy(),
                                      val(rops.decode_jpeg(want, mode=mode)))
    assert pops.decode_jpeg(raw, mode="gray").shape == (1, 12, 10)
