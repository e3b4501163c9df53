"""The rest of nn in the PyTorch/CUDA port (the 1-D, 3-D and transposed
convolutions, every pooling with masks and unpooling, the group,
instance, local-response and spectral norms, vision.py's samplers,
sparse_attention, gather_tree and nn.utils) against the JAX reference on
the host.

Every case of tests/test_torch_nn_rest_cases.py runs through both
packages on the same numpy inputs and weights: floats within rtol 1e-6 /
atol 1e-6, 1e-5 for the transposed convolutions, affine_grid and
grid_sample (the case says so), integers and bools exactly. Beside them:
the transposed convolutions against the vjp of the reference's own
convolution (ROADMAP C-ref-16) and against the reference's kernel-flip,
one test per argument the reference never reads (C-ref-17), gradients
against the reference's autograd, the reference's own tests of these
modules run through both packages, and the SpectralNorm vectors against
every optimizer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.core.dispatch import unwrap
from paddle_tpu.core.tensor import Tensor as RefTensor
from test_torch_nn_rest_cases import CASES
from test_torch_tensor_ops import assert_same, run_case

torch.set_num_threads(1)

DEFAULT_TOL = {"rtol": 1e-6, "atol": 1e-6}
BOTH = pytest.mark.parametrize("P", [ref, pt], ids=["ref", "port"])


@pytest.fixture(autouse=True)
def _global_state():
    """Each test on the host, from seed 0, and the process-wide state of
    both packages (device, default dtype, global initializer) put back
    after it."""
    before = pt.get_device()
    dtypes = ref.get_default_dtype(), pt.get_default_dtype()
    inits = (ref.nn.initializer._global_initializer(False),
             ref.nn.initializer._global_initializer(True),
             pt.nn.initializer._global_initializer(False),
             pt.nn.initializer._global_initializer(True))
    pt.set_device("cpu")
    ref.seed(0)
    pt.seed(0)
    yield
    pt.set_device(before)
    ref.set_default_dtype(dtypes[0])
    pt.set_default_dtype(dtypes[1])
    ref.nn.initializer.set_global_initializer(*inits[:2])
    pt.nn.initializer.set_global_initializer(*inits[2:])


@pytest.mark.parametrize("c", CASES, ids=[c.id for c in CASES])
def test_nn_rest_case_matches_reference(c):
    want = run_case(ref, c)
    got = run_case(pt, c)
    assert_same(got, want, {**DEFAULT_TOL, **c.tol}, c.id)


# -- C-ref-16: the transposed convolutions are the adjoint ----------------------------
ADJOINT = [
    (1, {}, (2, 4, 9), (6, 4, 3)),
    (1, {"stride": 3, "padding": 1}, (2, 4, 10), (6, 4, 4)),
    (1, {"stride": 2, "padding": [2, 1], "dilation": 2, "groups": 2},
     (1, 4, 10), (6, 2, 3)),
    (2, {}, (2, 3, 6, 7), (4, 3, 3, 2)),
    (2, {"stride": 2, "padding": 1}, (2, 3, 7, 8), (4, 3, 3, 3)),
    (2, {"stride": (2, 3), "padding": (1, 0), "dilation": (2, 1)},
     (1, 3, 11, 9), (4, 3, 3, 3)),
    (2, {"stride": 2, "padding": [1, 0, 0, 2], "groups": 3}, (2, 6, 7, 6),
     (6, 2, 3, 2)),
    (2, {"stride": 2, "padding": 1}, (1, 2, 8, 8), (3, 2, 3, 3)),
    (3, {"stride": 2, "padding": 1}, (1, 4, 6, 5, 6), (2, 4, 3, 2, 3)),
    (3, {"groups": 2, "dilation": (1, 2, 1)}, (1, 4, 5, 7, 4),
     (4, 2, 2, 2, 2)),
]


def _output_padding(n, kw, x_shape, w_shape):
    """The output_padding that gives the transposed convolution the
    length of the convolution's input: what the convolution's stride
    left over."""
    stride = np.broadcast_to(kw.get("stride", 1), (n,))
    dilation = np.broadcast_to(kw.get("dilation", 1), (n,))
    pad = np.asarray(kw.get("padding", 0)).ravel()
    padded = pad.reshape(n, 2).sum(1) if pad.size == 2 * n \
        else 2 * np.broadcast_to(pad, (n,))
    eff = (np.asarray(w_shape[2:]) - 1) * dilation + 1
    return tuple(int(v) for v in
                 (np.asarray(x_shape[2:]) + padded - eff) % stride)


@pytest.mark.parametrize("n,kw,x_shape,w_shape", ADJOINT,
                         ids=[f"{n}d-{i}" for i, (n, *_) in
                              enumerate(ADJOINT)])
def test_transposed_conv_is_the_vjp_of_the_reference_conv(n, kw, x_shape,
                                                          w_shape):
    """conv{n}d_transpose(g, w) = the vjp of x -> reference conv{n}d(x, w)
    at cotangent g, x of the transposed result's shape, with the
    output_padding the convolution's stride left over (C-ref-16: the
    port computes Paddle's adjoint, not the reference's unflipped
    correlation)."""
    rng = np.random.RandomState(21)
    w = rng.randn(*w_shape).astype("float32")
    conv = getattr(ref.nn.functional, f"conv{n}d")

    def f(x):
        return unwrap(conv(RefTensor(x), RefTensor(jnp.asarray(w)), **kw))
    y, vjp = jax.vjp(f, jnp.zeros(x_shape, jnp.float32))
    g = rng.randn(*y.shape).astype("float32")
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = getattr(pt.nn.functional, f"conv{n}d_transpose")(
        torch.tensor(g), torch.tensor(w), **kw,
        output_padding=_output_padding(n, kw, x_shape, w_shape))
    assert tuple(got.shape) == x_shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_reference_transposed_conv_is_the_port_with_the_kernel_flipped():
    """The reference's conv2d_transpose(x, w) is the port's with w flipped
    along both spatial axes, and differs from it with w as it is
    (C-ref-16), for an asymmetric kernel at stride 2, padding 1,
    grouped."""
    rng = np.random.RandomState(22)
    x = rng.randn(2, 4, 5, 6).astype("float32")
    w = rng.randn(4, 3, 3, 2).astype("float32")
    kw = {"stride": 2, "padding": 1, "groups": 2}
    want = ref.nn.functional.conv2d_transpose(
        ref.to_tensor(x), ref.to_tensor(w), **kw).numpy()
    flipped = pt.nn.functional.conv2d_transpose(
        torch.tensor(x), torch.tensor(w).flip(2, 3), **kw).numpy()
    as_is = pt.nn.functional.conv2d_transpose(
        torch.tensor(x), torch.tensor(w), **kw).numpy()
    np.testing.assert_allclose(flipped, want, rtol=1e-5, atol=1e-5)
    assert np.abs(as_is - want).max() > 1.0


# -- C-ref-17: arguments the reference never reads raise ------------------------------
F = pt.nn.functional
T1, T2, T3 = torch.zeros(1, 2, 8), torch.zeros(1, 2, 6, 6), \
    torch.zeros(1, 2, 4, 4, 4)
UNREAD = {
    "conv1d_transpose-output_size": lambda: F.conv1d_transpose(
        T1, torch.zeros(2, 3, 3), output_size=[10]),
    "conv2d_transpose-output_size": lambda: F.conv2d_transpose(
        T2, torch.zeros(2, 3, 3, 3), stride=2, output_size=[13, 13]),
    "conv3d_transpose-output_size": lambda: F.conv3d_transpose(
        T3, torch.zeros(2, 3, 2, 2, 2), output_size=[5, 5, 5]),
    "Conv2DTranspose-output_size": lambda: pt.nn.Conv2DTranspose(
        2, 3, 3)(T2, output_size=[8, 8]),
    "conv2d_transpose-output_padding_with_same": lambda:
        F.conv2d_transpose(T2, torch.zeros(2, 3, 3, 3), stride=2,
                           padding="SAME", output_padding=1),
    "adaptive_max_pool1d-return_mask": lambda: F.adaptive_max_pool1d(
        T1, 4, return_mask=True),
    "adaptive_max_pool2d-return_mask": lambda: F.adaptive_max_pool2d(
        T2, 3, return_mask=True),
    "adaptive_max_pool3d-return_mask": lambda: F.adaptive_max_pool3d(
        T3, 2, return_mask=True),
    "AdaptiveMaxPool2D-return_mask": lambda: pt.nn.AdaptiveMaxPool2D(
        3, return_mask=True),
    "instance_norm-running_mean": lambda: F.instance_norm(
        T2, running_mean=torch.zeros(2)),
    "instance_norm-running_var": lambda: F.instance_norm(
        T2, running_var=torch.ones(2)),
    "instance_norm-use_input_stats": lambda: F.instance_norm(
        T2, use_input_stats=False),
    "instance_norm-momentum": lambda: F.instance_norm(T2, momentum=0.5),
    "InstanceNorm2D-momentum": lambda: pt.nn.InstanceNorm2D(2, momentum=0.1),
    "max_pool1d-ceil_mode": lambda: F.max_pool1d(T1, 3, ceil_mode=True),
    "max_pool3d-ceil_mode": lambda: F.max_pool3d(T3, 3, ceil_mode=True),
    "avg_pool1d-ceil_mode": lambda: F.avg_pool1d(T1, 3, ceil_mode=True),
    "avg_pool3d-ceil_mode": lambda: F.avg_pool3d(T3, 3, ceil_mode=True),
    "AvgPool3D-ceil_mode": lambda: pt.nn.AvgPool3D(3, ceil_mode=True)(T3),
    "avg_pool3d-divisor_override": lambda: F.avg_pool3d(
        T3, 2, divisor_override=3),
    "MaxPool2D-return_mask": lambda: pt.nn.MaxPool2D(2, return_mask=True),
    "AvgPool2D-exclusive": lambda: pt.nn.AvgPool2D(2, exclusive=False),
    "Conv1D-padding_mode": lambda: pt.nn.Conv1D(2, 2, 3,
                                                padding_mode="reflect"),
    "Conv3D-padding_mode": lambda: pt.nn.Conv3D(2, 2, 3,
                                                padding_mode="circular"),
}


@pytest.mark.parametrize("name", sorted(UNREAD))
def test_argument_the_reference_never_reads_raises(name):
    tag = "C-ref-4" if "padding_mode" in name or "ceil_mode" in name \
        else "C-ref-17"
    with pytest.raises(NotImplementedError, match=tag):
        UNREAD[name]()


def test_return_mask_refusals_mirror_the_reference():
    x = np.zeros((1, 2, 6, 6), "float32")
    for P in (ref, pt):
        t = P.to_tensor(x)
        with pytest.raises(NotImplementedError):
            P.nn.functional.max_pool2d(t, 2, ceil_mode=True,
                                       return_mask=True)
        with pytest.raises(ValueError):
            P.nn.functional.max_pool2d(t, 2, padding="SAME",
                                       return_mask=True)
        with pytest.raises(ValueError):
            P.nn.functional.max_pool2d(t, 2, return_mask=True,
                                       data_format="NHWC")


@BOTH
def test_sparse_attention_masks_raise(P):
    q = P.to_tensor(np.zeros((1, 1, 4, 2), "float32"))
    off = P.to_tensor(np.arange(0, 5, dtype="int32").reshape(1, 1, 5))
    col = P.to_tensor(np.arange(4, dtype="int32").reshape(1, 1, 4))
    for kw in ({"key_padding_mask": q}, {"attn_mask": q}):
        with pytest.raises(NotImplementedError):
            P.nn.functional.sparse_attention(q, q, q, off, col, **kw)


# -- gradients against the reference's autograd ----------------------------------------
def _grad_case(name, fn, *shapes, seed=0):
    return pytest.param(fn, shapes, seed, id=name)


GRADS = [
    _grad_case("conv1d", lambda F, x, w: F.conv1d(x, w, stride=2, padding=1),
               (2, 4, 9), (3, 4, 3)),
    _grad_case("conv3d", lambda F, x, w: F.conv3d(x, w, padding="SAME"),
               (1, 2, 4, 5, 3), (3, 2, 2, 3, 2)),
    _grad_case("max_pool3d", lambda F, x: F.max_pool3d(x, 2, 1, 1),
               (1, 2, 4, 3, 5)),
    _grad_case("max_pool2d-mask", lambda F, x: F.max_pool2d(
        x, 3, 2, 1, return_mask=True)[0], (1, 2, 7, 7)),
    _grad_case("avg_pool1d", lambda F, x: F.avg_pool1d(x, 3, 2, 1),
               (2, 3, 9)),
    _grad_case("adaptive_max_pool2d", lambda F, x: F.adaptive_max_pool2d(
        x, (3, 2)), (1, 2, 7, 5)),
    _grad_case("instance_norm", lambda F, x, w, b: F.instance_norm(
        x, weight=w, bias=b), (2, 3, 4, 5), (3,), (3,)),
    _grad_case("group_norm", lambda F, x, w, b: F.group_norm(
        x, 2, 1e-5, w, b), (2, 4, 3, 5), (4,), (4,)),
    _grad_case("local_response_norm", lambda F, x: F.local_response_norm(
        x, 3, alpha=0.5), (2, 5, 3, 3)),
    _grad_case("grid_sample", lambda F, x, g: F.grid_sample(
        x, g * 1.1, padding_mode="border"), (1, 2, 5, 4), (1, 3, 6, 2)),
    _grad_case("affine_grid", lambda F, t: F.affine_grid(t, [1, 1, 3, 4]),
               (1, 2, 3)),
    _grad_case("temporal_shift", lambda F, x: F.temporal_shift(x, 2),
               (4, 8, 2, 2)),
]


@pytest.mark.parametrize("fn,shapes,seed", GRADS)
def test_grad_matches_reference(fn, shapes, seed):
    rng = np.random.RandomState(seed + 30)
    arrays = [rng.randn(*s).astype("float32") for s in shapes]
    rx = [ref.to_tensor(a, stop_gradient=False) for a in arrays]
    ry = fn(ref.nn.functional, *rx)
    wgt = rng.randn(*ry.shape).astype("float32")
    ref.sum(ry * ref.to_tensor(wgt)).backward()
    px = [torch.tensor(a, requires_grad=True) for a in arrays]
    py = fn(pt.nn.functional, *px)
    (py * torch.tensor(wgt)).sum().backward()
    for i, (p, r) in enumerate(zip(px, rx)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r.grad._val),
                                   rtol=1e-4, atol=1e-5, err_msg=str(i))


def test_conv_transpose_grad_matches_reference_with_the_flipped_kernel():
    """The grads of the port's conv2d_transpose(x, w) are the reference's
    for the flipped kernel (C-ref-16), w's grad flipped back."""
    rng = np.random.RandomState(34)
    x = rng.randn(1, 3, 4, 5).astype("float32")
    w = rng.randn(3, 2, 3, 2).astype("float32")
    kw = {"stride": 2, "padding": 1, "output_padding": 1}
    rx = ref.to_tensor(x, stop_gradient=False)
    rw = ref.to_tensor(np.ascontiguousarray(w[:, :, ::-1, ::-1]),
                       stop_gradient=False)
    ry = ref.nn.functional.conv2d_transpose(rx, rw, **kw)
    wgt = rng.randn(*ry.shape).astype("float32")
    ref.sum(ry * ref.to_tensor(wgt)).backward()
    px = torch.tensor(x, requires_grad=True)
    pw = torch.tensor(w, requires_grad=True)
    py = pt.nn.functional.conv2d_transpose(px, pw, **kw)
    (py * torch.tensor(wgt)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(rx.grad._val),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pw.grad.flip(2, 3).numpy(),
                               np.asarray(rw.grad._val), rtol=1e-4,
                               atol=1e-5)


def test_sparse_attention_grad_matches_reference():
    rng = np.random.RandomState(33)
    b, h, s, d = 1, 2, 6, 4
    arrays = [rng.randn(b, h, s, d).astype("float32") for _ in range(3)]
    off = np.tile(np.arange(0, s * 3 + 1, 3, dtype=np.int32), (b, h, 1))
    cols = rng.randint(0, s, (b, h, s * 3)).astype(np.int32)
    wgt = rng.randn(b, h, s, d).astype("float32")
    rx = [ref.to_tensor(a, stop_gradient=False) for a in arrays]
    ry = ref.nn.functional.sparse_attention(*rx, ref.to_tensor(off),
                                            ref.to_tensor(cols))
    ref.sum(ry * ref.to_tensor(wgt)).backward()
    px = [torch.tensor(a, requires_grad=True) for a in arrays]
    py = pt.nn.functional.sparse_attention(*px, torch.tensor(off),
                                           torch.tensor(cols))
    (py * torch.tensor(wgt)).sum().backward()
    for p, r in zip(px, rx):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r.grad._val),
                                   rtol=1e-5, atol=1e-6)


# -- SpectralNorm's u and v are skipped by every optimizer -----------------------------
@pytest.mark.parametrize("name", [n for n in pt.optimizer.__all__
                                  if n not in ("Optimizer", "lr")])
def test_every_optimizer_skips_the_spectral_norm_vectors(name):
    """weight_u and weight_v take no gradient: an optimizer given every
    parameter of the layer updates the weight and leaves u and v as the
    forward wrote them."""
    lin = pt.nn.Linear(4, 3)
    pt.nn.utils.spectral_norm(lin, "weight")
    sn = lin.weight_spectral_norm
    opt = getattr(pt.optimizer, name)(learning_rate=0.1,
                                      parameters=lin.parameters())
    lin(torch.ones(2, 4)).square().sum().backward()
    u, v = sn.weight_u.clone(), sn.weight_v.clone()
    w = lin.weight_orig.detach().clone()
    opt.step()
    assert sn.weight_u.grad is None and sn.weight_v.grad is None
    assert torch.equal(sn.weight_u, u) and torch.equal(sn.weight_v, v)
    assert not torch.equal(lin.weight_orig, w)


def test_spectral_norm_hook_keeps_the_weight_trainable():
    """The reference's hook drops the weight from the layer's parameters,
    so an optimizer over ``layer.parameters()`` never trains it; the port
    keeps it as ``weight_orig`` (C-ref-18)."""
    rl = ref.nn.Linear(4, 3)
    ref.nn.utils.spectral_norm(rl, "weight")
    assert "weight" not in dict(rl.named_parameters())
    pl = pt.nn.Linear(4, 3)
    pt.nn.utils.spectral_norm(pl, "weight")
    names = sorted(n for n, _ in pl.named_parameters())
    assert names == ["bias", "weight_orig", "weight_spectral_norm.weight_u",
                     "weight_spectral_norm.weight_v"]


# -- the reference's own tests of these modules, through both packages ----------------
@BOTH
def test_affine_grid_identity_roundtrip(P):
    theta = P.to_tensor(
        np.tile(np.array([[1, 0, 0], [0, 1, 0]], "float32"), (2, 1, 1)))
    grid = P.nn.functional.affine_grid(theta, [2, 3, 5, 7])
    assert list(grid.shape) == [2, 5, 7, 2]
    x = np.random.RandomState(1).randn(2, 3, 5, 7).astype("float32")
    out = P.nn.functional.grid_sample(P.to_tensor(x), grid)
    np.testing.assert_allclose(np.asarray(out.numpy()), x, atol=2e-5)


@BOTH
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_matches_torch(P, mode, padding_mode, align_corners):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 6, 5).astype("float32")
    grid = (rng.rand(2, 4, 7, 2).astype("float32") * 2.4 - 1.2)
    want = torch.nn.functional.grid_sample(
        torch.tensor(x), torch.tensor(grid), mode=mode,
        padding_mode=padding_mode, align_corners=align_corners).numpy()
    got = P.nn.functional.grid_sample(
        P.to_tensor(x), P.to_tensor(grid), mode=mode,
        padding_mode=padding_mode, align_corners=align_corners).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_grid_sample_gradient_flows():
    x = torch.tensor(np.random.RandomState(2).randn(1, 2, 4, 4)
                     .astype("float32"), requires_grad=True)
    theta = torch.tensor([[[1, 0, 0.1], [0, 1, -0.1]]], requires_grad=True)
    out = F.grid_sample(x, F.affine_grid(theta, [1, 2, 4, 4]))
    out.sum().backward()
    assert float(x.grad.abs().sum()) > 0
    assert float(theta.grad.abs().sum()) > 0


@BOTH
def test_temporal_shift_oracle(P):
    x = np.arange(2 * 2 * 4, dtype="float32").reshape(4, 4, 1, 1)
    out = P.nn.functional.temporal_shift(P.to_tensor(x), seg_num=2,
                                         shift_ratio=0.25).numpy()
    r = x.reshape(2, 2, 4, 1, 1)
    want = np.zeros_like(r)
    want[:, :-1, :1] = r[:, 1:, :1]
    want[:, 1:, 1:2] = r[:, :-1, 1:2]
    want[:, :, 2:] = r[:, :, 2:]
    np.testing.assert_allclose(out, want.reshape(4, 4, 1, 1))


@BOTH
def test_max_pool2d_mask_and_unpool_roundtrip(P):
    x = np.random.RandomState(3).randn(2, 3, 8, 8).astype("float32")
    out, mask = P.nn.functional.max_pool2d(P.to_tensor(x), 2,
                                           return_mask=True)
    to, tm = torch.nn.functional.max_pool2d(torch.tensor(x), 2,
                                            return_indices=True)
    np.testing.assert_allclose(out.numpy(), to.numpy())
    np.testing.assert_array_equal(mask.numpy(), tm.numpy())
    rec = P.nn.functional.max_unpool2d(out, mask, 2)
    trec = torch.nn.functional.max_unpool2d(to, tm, 2)
    np.testing.assert_allclose(rec.numpy(), trec.numpy())


@BOTH
def test_max_unpool2d_layer_and_1d(P):
    x = np.random.RandomState(4).randn(1, 2, 6).astype("float32")
    out, mask = P.nn.functional.max_pool1d(P.to_tensor(x), 2,
                                           return_mask=True)
    rec = P.nn.functional.max_unpool1d(out, mask, 2).numpy()
    assert rec.shape == (1, 2, 6)
    nz = rec != 0
    np.testing.assert_allclose(rec[nz], x[nz])
    x2 = np.random.RandomState(5).randn(1, 1, 4, 4).astype("float32")
    o2, m2 = P.nn.functional.max_pool2d(P.to_tensor(x2), 2,
                                        return_mask=True)
    assert list(P.nn.MaxUnPool2D(2)(o2, m2).shape) == [1, 1, 4, 4]


@BOTH
def test_spectral_norm(P):
    P.seed(0)
    sn = P.nn.SpectralNorm([4, 6], dim=0, power_iters=8)
    w = np.random.RandomState(0).randn(4, 6).astype("float32") * 3
    out = np.asarray(sn(P.to_tensor(w)).numpy())
    s = np.linalg.svd(w, compute_uv=False)[0]
    np.testing.assert_allclose(np.linalg.svd(out, compute_uv=False)[0], 1.0,
                               rtol=0.05)
    np.testing.assert_allclose(out * s, w, rtol=0.05, atol=0.05)


@BOTH
def test_nn_utils_weight_norm(P):
    lin = P.nn.Linear(4, 3)
    P.nn.utils.weight_norm(lin, "weight", dim=0)
    x = P.to_tensor(np.random.RandomState(0).randn(2, 4).astype("float32"))
    y1 = np.asarray(lin(x).detach().numpy() if P is pt else lin(x).numpy())
    names = [n for n, _ in lin.named_parameters()]
    assert "weight_g" in names and "weight_v" in names
    P.nn.utils.remove_weight_norm(lin, "weight")
    y2 = lin(x)
    y2 = y2.detach().numpy() if P is pt else y2.numpy()
    np.testing.assert_allclose(y1, y2, rtol=1e-5)


@BOTH
def test_nn_utils_spectral_norm_contracts(P):
    lin = P.nn.Linear(6, 5)
    w0 = np.asarray(lin.weight.detach().numpy() if P is pt
                    else lin.weight.numpy()) * 4.0
    lin.set_state_dict({"weight": P.to_tensor(w0)})
    P.nn.utils.spectral_norm(lin, "weight", n_power_iterations=8)
    w = lin.weight.detach().numpy() if P is pt else lin.weight.numpy()
    np.testing.assert_allclose(np.linalg.svd(w, compute_uv=False)[0], 1.0,
                               rtol=0.1)


def _np_sparse_attention(q, k, v, offset, columns):
    b, h, s, d = q.shape
    out = np.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            logits = (q[bi, hi] @ k[bi, hi].T) / np.sqrt(d)
            mask = np.zeros((s, s), dtype=bool)
            off = offset[bi, hi]
            for r in range(s):
                mask[r, columns[bi, hi][off[r]:off[r + 1]]] = True
            logits = np.where(mask, logits, -1e30)
            e = np.exp(logits - logits.max(-1, keepdims=True))
            p = np.where(mask.any(-1, keepdims=True),
                         e / e.sum(-1, keepdims=True), 0.0)
            out[bi, hi] = p @ v[bi, hi]
    return out


@BOTH
def test_sparse_attention_docstring_example(P):
    q = np.array([[[[0, 1], [2, 3], [0, 1], [2, 3]]]], dtype=np.float32)
    offset = np.array([[[0, 2, 4, 6, 8]]], dtype=np.int32)
    columns = np.array([[[0, 1, 0, 1, 2, 3, 2, 3]]], dtype=np.int32)
    out = P.nn.functional.sparse_attention(
        P.to_tensor(q), P.to_tensor(q), P.to_tensor(q),
        P.to_tensor(offset), P.to_tensor(columns))
    expect = np.array([[[[1.60885942, 2.60885954], [1.99830270, 2.99830270],
                         [1.60885942, 2.60885954],
                         [1.99830270, 2.99830270]]]], dtype=np.float32)
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-5, atol=1e-6)


@BOTH
def test_sparse_attention_vs_numpy_oracle_full_csr(P):
    rng = np.random.RandomState(7)
    b, h, s, d = 2, 3, 8, 4
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    offset = np.tile(np.arange(0, s * s + 1, s, dtype=np.int32), (b, h, 1))
    columns = np.tile(np.tile(np.arange(s, dtype=np.int32), s), (b, h, 1))
    out = P.nn.functional.sparse_attention(
        P.to_tensor(q), P.to_tensor(k), P.to_tensor(v),
        P.to_tensor(offset), P.to_tensor(columns))
    np.testing.assert_allclose(out.numpy(), _np_sparse_attention(
        q, k, v, offset, columns), rtol=1e-4, atol=1e-5)
