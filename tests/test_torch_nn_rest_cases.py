"""The cases of the rest of nn's parity checks, shared by
tests/test_torch_nn_rest.py (the port against the reference on the
host) and chip_smoke.py's nn_rest_cases lane (the port on the card
against the port on the host).

As in tests/test_torch_nn_cases.py, a case calls a package ``P``
(paddle_tpu or paddle_tpu_torch) on tensors made with ``P.to_tensor``
from fixed numpy arrays, and layers take their weights from seeded numpy
arrays through ``set_state_dict``. The cases cover the 1-D and 3-D and
the transposed convolutions and their layers, every pooling (masks and
unpooling included) and pooling layer, group/instance/local-response
norms and their layers, BatchNorm3D, SpectralNorm and nn.utils'
weight_norm/spectral_norm with ``u`` and ``v`` carried, vision.py's
samplers, sparse_attention and gather_tree.

The reference's transposed convolution is the adjoint with the kernel
flipped along every spatial axis (ROADMAP C-ref-16): its cases hand the
reference the flipped kernel (``adjoint_weight``), so both packages
compute the adjoint of the same convolution. This module imports
neither package and no JAX.
"""
import numpy as np

from test_torch_nn_cases import Case, load, weights_for

_R = np.random.RandomState(12)


def _f(*shape, scale=1.0):
    return (scale * _R.randn(*shape)).astype("float32")


CASES = []
INTERP_TOL = {"rtol": 1e-5, "atol": 1e-5}
# cuDNN sums a 3-D window's 54-108 products in its own order: on an H100
# (f32, TF32 off) up to 1.1e-5 from the host at outputs up to 34 (3.4e-7
# of the largest); atol is 1e-6 of the largest output
CONV3D_TOL = {"rtol": 1e-6, "atol": 3e-5}


def case(cid, fn, *arrays, post=None, tol=None):
    CASES.append(Case(cid, fn, list(arrays), post, tol))


def F(P):
    return P.nn.functional


def is_reference(P):
    return P.__name__ == "paddle_tpu"


def adjoint_weight(P, w):
    """The kernel ``P``'s transposed convolution takes to compute the
    adjoint of the convolution by ``w``: ``w`` itself in the port, ``w``
    flipped along its spatial axes in the reference (C-ref-16)."""
    if not is_reference(P):
        return w
    return P.flip(w, axis=list(range(2, len(w.shape))))


def load_transposed(P, layer, seed=0):
    """A transposed conv layer with seeded weights, flipped for the
    reference (``adjoint_weight``)."""
    arrays = weights_for(layer, seed)
    if is_reference(P):
        w = arrays["weight"]
        arrays["weight"] = np.ascontiguousarray(
            np.flip(w, axis=tuple(range(2, w.ndim))))
    layer.set_state_dict({k: P.to_tensor(v) for k, v in arrays.items()})
    return layer


# -- convolutions (nn/functional/conv.py) --------------------------------------
X1 = _f(2, 4, 11)
X3 = _f(2, 4, 5, 6, 7)
for cid, kw, w in [
        ("conv1d", {}, _f(6, 4, 3)),
        ("conv1d-stride_pad_dilation",
         {"stride": 2, "padding": 2, "dilation": 2}, _f(6, 4, 3)),
        ("conv1d-groups", {"groups": 2, "padding": 1}, _f(6, 2, 3)),
        ("conv1d-same", {"stride": 2, "padding": "SAME"}, _f(6, 4, 4)),
        ("conv1d-valid", {"padding": "VALID"}, _f(6, 4, 5)),
        ("conv1d-lo_hi", {"padding": [1, 3]}, _f(6, 4, 3))]:
    case(cid, lambda P, x, w, b, kw=kw: F(P).conv1d(x, w, b, **kw),
         X1, w, _f(6))
case("conv1d-nlc", lambda P, x, w: F(P).conv1d(
    x, w, padding=1, data_format="NLC"), _f(2, 9, 4), _f(5, 4, 3))
for cid, kw, w in [
        ("conv3d", {"padding": 1}, _f(3, 4, 3, 3, 3)),
        ("conv3d-stride_same", {"stride": 2, "padding": "SAME"},
         _f(3, 4, 2, 3, 3)),
        ("conv3d-groups_dilation", {"groups": 2, "dilation": (1, 2, 1),
                                    "padding": [0, 1, 1, 2, 0, 0]},
         _f(4, 2, 2, 2, 3))]:
    case(cid, lambda P, x, w, b, kw=kw: F(P).conv3d(x, w, b, **kw),
         X3, w, _f(w.shape[0]), tol=CONV3D_TOL)
case("conv3d-ndhwc", lambda P, x, w: F(P).conv3d(
    x, w, stride=(1, 2, 1), padding=1, data_format="NDHWC"),
    _f(2, 4, 5, 6, 3), _f(2, 3, 3, 3, 3), tol=CONV3D_TOL)

# transposed: the adjoint, the reference given the flipped kernel
TRANSPOSED = [
    ("conv1d_transpose", 1, {}, (4, 3, 3)),
    ("conv1d_transpose-stride_pad_opad",
     1, {"stride": 3, "padding": 1, "output_padding": 2}, (4, 3, 4)),
    ("conv1d_transpose-groups_dilation",
     1, {"groups": 2, "dilation": 2, "padding": [2, 0]}, (4, 2, 3)),
    ("conv1d_transpose-same", 1, {"stride": 2, "padding": "SAME"},
     (4, 3, 3)),
    ("conv1d_transpose-valid_small_kernel",
     1, {"stride": 3, "padding": "VALID"}, (4, 3, 2)),
    ("conv2d_transpose", 2, {}, (4, 3, 3, 2)),
    ("conv2d_transpose-stride_pad",
     2, {"stride": 2, "padding": 1}, (4, 3, 3, 2)),
    ("conv2d_transpose-opad_dilation",
     2, {"stride": (2, 3), "padding": (1, 0), "output_padding": (1, 2),
         "dilation": (2, 1)}, (4, 3, 3, 3)),
    ("conv2d_transpose-groups",
     2, {"groups": 2, "stride": 2, "padding": [1, 0, 0, 2]}, (4, 2, 3, 2)),
    ("conv2d_transpose-same", 2, {"stride": 2, "padding": "SAME"},
     (4, 3, 4, 3)),
    ("conv3d_transpose",
     3, {"stride": 2, "padding": 1, "output_padding": 1}, (4, 2, 3, 2, 3)),
    ("conv3d_transpose-groups_valid",
     3, {"groups": 2, "padding": "VALID"}, (4, 1, 2, 2, 2)),
]
XT = {1: _f(2, 4, 7), 2: _f(2, 4, 5, 6), 3: _f(1, 4, 3, 4, 5)}
for cid, n, kw, wshape in TRANSPOSED:
    w = _f(*wshape)
    case(cid, lambda P, x, w, b, n=n, kw=kw: getattr(
        F(P), f"conv{n}d_transpose")(x, adjoint_weight(P, w), b, **kw),
        XT[n], w, _f(wshape[1] * kw.get("groups", 1)), tol=INTERP_TOL)
case("conv2d_transpose-nhwc", lambda P, x, w: F(P).conv2d_transpose(
    x, adjoint_weight(P, w), stride=2, padding=1, output_padding=1,
    data_format="NHWC"), _f(2, 5, 4, 4), _f(4, 3, 3, 3), tol=INTERP_TOL)
case("conv1d_transpose-nlc", lambda P, x, w: F(P).conv1d_transpose(
    x, adjoint_weight(P, w), stride=2, data_format="NLC"),
    _f(2, 6, 4), _f(4, 2, 3), tol=INTERP_TOL)

# -- conv layers (nn/layer/conv.py) ------------------------------------------------
case("Conv1D", lambda P, x: load(P, P.nn.Conv1D(4, 6, 3, stride=2,
                                                 padding=1), 1)(x), X1)
case("Conv1D-nlc", lambda P, x: load(P, P.nn.Conv1D(
    4, 5, 3, groups=1, data_format="NLC"), 2)(x), _f(2, 9, 4))
case("Conv3D", lambda P, x: load(P, P.nn.Conv3D(4, 3, 3, padding=1,
                                                 groups=1), 3)(x), X3,
     tol=CONV3D_TOL)
case("Conv1DTranspose", lambda P, x: load_transposed(P, P.nn.Conv1DTranspose(
    4, 6, 3, 2, 1, 1, 2, 1), 4)(x), XT[1], tol=INTERP_TOL)
case("Conv2DTranspose", lambda P, x: load_transposed(P, P.nn.Conv2DTranspose(
    4, 6, 3, stride=2, padding=1, output_padding=1), 5)(x), XT[2],
    tol=INTERP_TOL)
case("Conv2DTranspose-groups", lambda P, x: load_transposed(
    P, P.nn.Conv2DTranspose(4, 4, (2, 3), 2, 0, 0, 1, 2), 6)(x), XT[2],
    tol=INTERP_TOL)
case("Conv3DTranspose", lambda P, x: load_transposed(P, P.nn.Conv3DTranspose(
    4, 2, 2, stride=2), 7)(x), XT[3], tol=INTERP_TOL)
case("test_nn-conv_layer_shapes", lambda P, x: [
    list(P.nn.Conv2D(3, 8, 3, stride=2, padding=1)(x).shape)],
    _f(2, 3, 8, 8))

# -- pooling (nn/functional/pooling.py) -------------------------------------------
P1, P2, P3 = _f(2, 3, 10), _f(2, 3, 7, 9), _f(2, 3, 6, 5, 7)
for cid, fn, x in [
        ("max_pool1d", lambda P, x: F(P).max_pool1d(x, 3, 2, 1), P1),
        ("max_pool1d-same", lambda P, x: F(P).max_pool1d(
            x, 4, 3, "SAME"), P1),
        ("max_pool1d-nlc", lambda P, x: F(P).max_pool1d(
            x, 2, data_format="NLC"), _f(2, 8, 3)),
        ("max_pool3d", lambda P, x: F(P).max_pool3d(x, 2, 2), P3),
        ("max_pool3d-pad", lambda P, x: F(P).max_pool3d(
            x, 3, (1, 2, 2), [0, 1, 1, 1, 2, 0]), P3),
        ("max_pool3d-ndhwc", lambda P, x: F(P).max_pool3d(
            x, 2, data_format="NDHWC"), _f(1, 4, 4, 6, 3)),
        ("avg_pool1d", lambda P, x: F(P).avg_pool1d(x, 3, 2, 1), P1),
        ("avg_pool1d-inclusive", lambda P, x: F(P).avg_pool1d(
            x, 3, 2, 1, exclusive=False), P1),
        ("avg_pool1d-same", lambda P, x: F(P).avg_pool1d(
            x, 4, 3, "SAME"), P1),
        ("avg_pool3d", lambda P, x: F(P).avg_pool3d(x, 2), P3),
        ("avg_pool3d-pad", lambda P, x: F(P).avg_pool3d(
            x, 3, 2, 1), P3),
        ("avg_pool3d-pad_inclusive", lambda P, x: F(P).avg_pool3d(
            x, 3, 2, 1, exclusive=False), P3),
        ("avg_pool3d-ndhwc", lambda P, x: F(P).avg_pool3d(
            x, 2, padding="SAME", data_format="NDHWC"), _f(1, 5, 4, 6, 3)),
        ("avg_pool2d-nhwc_pad", lambda P, x: F(P).avg_pool2d(
            x, 3, 2, [1, 0, 0, 1], data_format="NHWC"), _f(2, 7, 6, 3)),
        ("adaptive_avg_pool1d", lambda P, x: F(P).adaptive_avg_pool1d(
            x, 4), P1),
        ("adaptive_avg_pool3d", lambda P, x: F(P).adaptive_avg_pool3d(
            x, (4, 2, 3)), P3),
        ("adaptive_avg_pool3d-ndhwc", lambda P, x: F(P).adaptive_avg_pool3d(
            x, 2, data_format="NDHWC"), _f(1, 4, 5, 6, 3)),
        ("adaptive_max_pool1d", lambda P, x: F(P).adaptive_max_pool1d(
            x, 3), P1),
        ("adaptive_max_pool2d", lambda P, x: F(P).adaptive_max_pool2d(
            x, (3, 4)), P2),
        ("adaptive_max_pool2d-even", lambda P, x: F(P).adaptive_max_pool2d(
            x, 2), _f(1, 2, 6, 4)),
        ("adaptive_max_pool3d", lambda P, x: F(P).adaptive_max_pool3d(
            x, (4, 3, 2)), P3)]:
    case(cid, fn, x)

# masks: int32 flat indices into the unpadded extent, the first maximum on
# ties (the repeated values make ties)
TIES = np.repeat(np.repeat(_f(1, 2, 3, 3), 2, axis=2), 2, axis=3)
for cid, fn, x in [
        ("max_pool2d-mask", lambda P, x: F(P).max_pool2d(
            x, 2, return_mask=True), P2),
        ("max_pool2d-mask_overlap_pad", lambda P, x: F(P).max_pool2d(
            x, 3, 2, 1, return_mask=True), P2),
        ("max_pool2d-mask_ties", lambda P, x: F(P).max_pool2d(
            x, 3, 1, [1, 1, 0, 2], return_mask=True), TIES),
        ("max_pool1d-mask", lambda P, x: F(P).max_pool1d(
            x, 3, 2, 1, return_mask=True), P1),
        ("max_pool3d-mask", lambda P, x: F(P).max_pool3d(
            x, 2, (2, 1, 2), return_mask=True), P3)]:
    case(cid, fn, x)


def _unpool2d(P, x, **kw):
    out, mask = F(P).max_pool2d(x, 2, return_mask=True)
    return [mask, F(P).max_unpool2d(out, mask, 2, **kw)]


case("max_unpool2d", _unpool2d, _f(2, 3, 8, 6))
case("max_unpool2d-output_size", lambda P, x: _unpool2d(
    P, x, output_size=[9, 7]), _f(2, 3, 9, 7))
case("max_unpool1d", lambda P, x: F(P).max_unpool1d(
    *F(P).max_pool1d(x, 3, 3, return_mask=True), 3), _f(2, 3, 12))
case("max_unpool1d-stride_pad", lambda P, x: F(P).max_unpool1d(
    *F(P).max_pool1d(x, 4, 2, 1, return_mask=True), 4, 2, 1), _f(1, 2, 10))
case("MaxUnPool2D", lambda P, x: P.nn.MaxUnPool2D(3, 2, 1)(
    *F(P).max_pool2d(x, 3, 2, 1, return_mask=True)), _f(1, 2, 9, 9))

# -- pooling layers (nn/layer/pooling.py) -------------------------------------------
for cid, fn, x in [
        ("MaxPool1D", lambda P, x: P.nn.MaxPool1D(3, 2, 1)(x), P1),
        ("MaxPool2D", lambda P, x: P.nn.MaxPool2D(3, 2, 1)(x), P2),
        ("MaxPool3D", lambda P, x: P.nn.MaxPool3D(2, 1)(x), P3),
        ("AvgPool1D", lambda P, x: P.nn.AvgPool1D(4, 2, 2)(x), P1),
        ("AvgPool2D", lambda P, x: P.nn.AvgPool2D(2)(x), P2),
        ("AvgPool3D", lambda P, x: P.nn.AvgPool3D(3, 2, 1)(x), P3),
        ("AvgPool3D-ndhwc", lambda P, x: P.nn.AvgPool3D(
            2, data_format="NDHWC")(x), _f(1, 4, 4, 6, 3)),
        ("AdaptiveAvgPool1D", lambda P, x: P.nn.AdaptiveAvgPool1D(3)(x), P1),
        ("AdaptiveAvgPool3D", lambda P, x: P.nn.AdaptiveAvgPool3D(
            (2, 3, 4))(x), P3),
        ("AdaptiveMaxPool1D", lambda P, x: P.nn.AdaptiveMaxPool1D(4)(x), P1),
        ("AdaptiveMaxPool2D", lambda P, x: P.nn.AdaptiveMaxPool2D(
            (4, 5))(x), P2),
        ("AdaptiveMaxPool3D", lambda P, x: P.nn.AdaptiveMaxPool3D(
            3)(x), P3)]:
    case(cid, fn, x)

# -- norms (nn/functional/norm.py, nn/layer/norm.py) ------------------------------
N4, N3, N5 = _f(2, 6, 4, 5, scale=2.0), _f(3, 4, 7), _f(2, 4, 3, 4, 2)
for cid, fn, arrays in [
        ("instance_norm", lambda P, x: F(P).instance_norm(x), (N4,)),
        ("instance_norm-affine", lambda P, x, w, b: F(P).instance_norm(
            x, weight=w, bias=b, eps=1e-3), (N4, _f(6), _f(6))),
        ("instance_norm-nhwc", lambda P, x, w, b: F(P).instance_norm(
            x, weight=w, bias=b, data_format="NHWC"),
         (_f(2, 4, 5, 6), _f(6), _f(6))),
        ("instance_norm-ncl", lambda P, x: F(P).instance_norm(x), (N3,)),
        ("group_norm", lambda P, x, w, b: F(P).group_norm(
            x, 3, 1e-5, w, b), (N4, _f(6), _f(6))),
        ("group_norm-nhwc", lambda P, x, w, b: F(P).group_norm(
            x, 2, 1e-4, w, b, data_format="NHWC"),
         (_f(2, 4, 5, 6), _f(6), _f(6))),
        ("group_norm-3d_no_affine", lambda P, x: F(P).group_norm(x, 4),
         (N5,)),
        ("local_response_norm", lambda P, x: F(P).local_response_norm(
            x, 5), (N4,)),
        ("local_response_norm-even_size", lambda P, x:
         F(P).local_response_norm(x, 4, alpha=0.1, beta=0.5, k=2.0), (N4,)),
        ("local_response_norm-nhwc", lambda P, x: F(P).local_response_norm(
            x, 3, alpha=0.2, data_format="NHWC"), (_f(2, 4, 5, 6),)),
        ("local_response_norm-ncl", lambda P, x: F(P).local_response_norm(
            x, 3, alpha=0.3), (N3,))]:
    case(cid, fn, *arrays)


def _bn3d(P, x):
    bn = load(P, P.nn.BatchNorm3D(4), 8)
    y = bn(x)
    bn.eval()
    return [y, bn(x), bn._mean, bn._variance]


case("BatchNorm3D-train_eval", _bn3d, N5)
case("GroupNorm", lambda P, x: load(P, P.nn.GroupNorm(2, 6), 9)(x), N4)
case("GroupNorm-nhwc", lambda P, x: load(P, P.nn.GroupNorm(
    3, 6, data_format="NHWC"), 10)(x), _f(2, 3, 4, 6))
case("InstanceNorm1D", lambda P, x: load(P, P.nn.InstanceNorm1D(4), 11)(x),
     N3)
case("InstanceNorm2D", lambda P, x: load(P, P.nn.InstanceNorm2D(6), 12)(x),
     N4)
case("InstanceNorm3D", lambda P, x: load(P, P.nn.InstanceNorm3D(
    4, epsilon=1e-3), 13)(x), N5)
case("InstanceNorm2D-no_affine", lambda P, x: P.nn.InstanceNorm2D(
    6, weight_attr=False)(x), N4)
case("LocalResponseNorm", lambda P, x: P.nn.LocalResponseNorm(
    3, 0.01, 0.6, 1.5)(x), N4)


def _spectral(P, w, dim, iters):
    """SpectralNorm with u and v carried from seeded arrays; the output
    and the u, v the forward wrote back."""
    sn = load(P, P.nn.SpectralNorm(list(w.shape), dim=dim,
                                   power_iters=iters), 14)
    return [sn(w), sn.weight_u, sn.weight_v]


case("SpectralNorm", lambda P, w: _spectral(P, w, 0, 1), _f(4, 6))
case("SpectralNorm-dim1_iters3", lambda P, w: _spectral(P, w, 1, 3),
     _f(3, 5, 2))

# -- nn.utils (nn/utils/__init__.py) -------------------------------------------------


def _weight_norm(P, x, dim):
    lin = load(P, P.nn.Linear(4, 3), 15)
    P.nn.utils.weight_norm(lin, "weight", dim=dim)
    y = lin(x)
    params = {n: p for n, p in lin.named_parameters()}
    P.nn.utils.remove_weight_norm(lin, "weight")
    return [y, params["weight_g"], params["weight_v"], lin(x),
            sorted(n for n, _ in lin.named_parameters())]


case("weight_norm", lambda P, x: _weight_norm(P, x, 0), _f(2, 4))
case("weight_norm-dim1", lambda P, x: _weight_norm(P, x, 1), _f(2, 4))
case("weight_norm-dim_none", lambda P, x: _weight_norm(P, x, None), _f(2, 4))


def _spectral_hook(P, x, u, v):
    lin = load(P, P.nn.Linear(6, 5), 16)
    P.nn.utils.spectral_norm(lin, "weight", n_power_iterations=2)
    lin.weight_spectral_norm.set_state_dict({"weight_u": u, "weight_v": v})
    y = lin(x)
    return [y, lin.weight_spectral_norm.weight_u,
            lin.weight_spectral_norm.weight_v]


case("spectral_norm", _spectral_hook, _f(3, 6), _f(6), _f(5))

# -- vision (nn/functional/vision.py) ------------------------------------------------
THETA = np.array([[[0.9, -0.2, 0.1], [0.3, 1.1, -0.05]],
                  [[1.2, 0.0, -0.3], [0.1, 0.8, 0.2]]], "float32")
case("affine_grid", lambda P, t: F(P).affine_grid(t, [2, 3, 5, 7]), THETA,
     tol=INTERP_TOL)
case("affine_grid-no_align", lambda P, t: F(P).affine_grid(
    t, [2, 3, 4, 6], align_corners=False), THETA, tol=INTERP_TOL)
GS_X = _f(2, 3, 6, 5)
GS_GRID = (_R.rand(2, 4, 7, 2).astype("float32") * 2.4 - 1.2)
for mode in ("bilinear", "nearest"):
    for pad in ("zeros", "border", "reflection"):
        for align in (True, False):
            case(f"grid_sample-{mode}_{pad}_{'align' if align else 'half'}",
                 lambda P, x, g, m=mode, p=pad, a=align: F(P).grid_sample(
                     x, g, mode=m, padding_mode=p, align_corners=a),
                 GS_X, GS_GRID, tol=INTERP_TOL)
case("grid_sample-affine", lambda P, x, t: F(P).grid_sample(
    x, F(P).affine_grid(t, [2, 3, 6, 5])), GS_X, THETA, tol=INTERP_TOL)
case("temporal_shift", lambda P, x: F(P).temporal_shift(x, 3, 0.25),
     _f(6, 8, 2, 3))
case("temporal_shift-nhwc", lambda P, x: F(P).temporal_shift(
    x, 2, 0.2, data_format="NHWC"), _f(4, 3, 2, 10))


# -- sparse_attention (nn/functional/sparse_attention.py) -------------------------------
def _csr(b, h, s, keep, empty_row=None, pad=0):
    offsets = np.zeros((b, h, s + 1), np.int32)
    lanes = []
    for bi in range(b):
        for hi in range(h):
            cols = []
            for r in range(s):
                sel = np.flatnonzero(_R.rand(s) < keep)
                if r == empty_row:
                    sel = sel[:0]
                cols.append(sel.astype(np.int32))
                offsets[bi, hi, r + 1] = offsets[bi, hi, r] + sel.size
            lanes.append(np.concatenate(cols))
    nnz = max(c.size for c in lanes) + pad
    columns = np.zeros((b, h, nnz), np.int32)
    for i, c in enumerate(lanes):
        columns[i // h, i % h, :c.size] = c
    return offsets, columns


SA = [_f(2, 2, 8, 4) for _ in range(3)]
case("sparse_attention", lambda P, q, k, v, o, c: F(P).sparse_attention(
    q, k, v, o, c), *SA, *_csr(2, 2, 8, 0.5))
case("sparse_attention-empty_row_and_padding",
     lambda P, q, k, v, o, c: F(P).sparse_attention(q, k, v, o, c),
     *SA, *_csr(2, 2, 8, 0.3, empty_row=3, pad=5))

# -- gather_tree (nn/functional/__init__.py) ------------------------------------------
case("gather_tree", lambda P, i, p: F(P).gather_tree(i, p),
     _R.randint(0, 20, (5, 3, 4)).astype("int64"),
     _R.randint(0, 4, (5, 3, 4)).astype("int64"))
case("test_new_ops-gather_tree", lambda P, i, p: F(P).gather_tree(i, p),
     np.array([[[2, 5]], [[3, 6]], [[4, 7]]], "int64"),
     np.array([[[0, 0]], [[0, 0]], [[1, 0]]], "int64"))
