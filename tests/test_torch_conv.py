"""The conv net layers of the port against the JAX reference on the host.

conv2d, pad, the poolings and batch_norm (and the Conv2D / BatchNorm2D
layers) take the same numpy inputs, made from a seeded RandomState,
through paddle_tpu and paddle_tpu_torch on the CPU in f32. Outputs and
grads are held to 1e-5 relative + 1e-5 absolute (the two frameworks sum
a conv's products in different orders); pad, max pooling and the layers'
state-dict names exactly; running statistics after two steps to 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import nn as pnn

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
STATS = dict(rtol=1e-6, atol=1e-6)


def _ref_grad(fn, *arrays):
    """fn's output through the reference, and the grads of sum(out * w)
    (w a fixed random weighting) with respect to each input."""
    ts = [paddle.to_tensor(a) for a in arrays]
    for t in ts:
        t.stop_gradient = False
    out = fn(*ts)
    w = np.random.RandomState(99).randn(*out.shape).astype("float32")
    (out * paddle.to_tensor(w)).sum().backward()
    return np.asarray(out.numpy()), [np.asarray(t.grad.numpy()) for t in ts]


def _port_grad(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    w = np.random.RandomState(99).randn(*out.shape).astype("float32")
    (out * torch.tensor(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


CONV_CASES = [
    # (kernel, stride, padding, dilation, groups)
    (3, 1, 1, 1, 1),
    (3, 2, 1, 1, 1),
    (1, 2, 0, 1, 1),
    (3, (2, 1), (1, 0), 1, 1),
    (3, 2, [0, 1, 1, 2], 1, 1),          # asymmetric [lo, hi] pairs
    (3, 2, [[1, 0], [2, 1]], 1, 1),      # nested [lo, hi] pairs
    (4, 2, "SAME", 1, 1),                # lax pads the odd pad at the end
    (3, 3, "SAME", 1, 1),
    (3, 1, "VALID", 1, 1),
    (3, 1, 2, 2, 1),                     # dilation
    (3, 2, "SAME", 2, 1),
    (3, 1, 1, 1, 2),                     # groups
    (1, 1, 0, 1, 4),
]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[str(c) for c in CONV_CASES])
def test_conv2d_matches_reference(fmt, case):
    k, stride, padding, dilation, groups = case
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 11, 10).astype("float32")
    w = (rng.randn(8, 4 // groups, k, k) * 0.3).astype("float32")
    b = rng.randn(8).astype("float32")
    if fmt == "NHWC":
        x = _nhwc(x)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=fmt)
    want, want_g = _ref_grad(lambda *t: RF.conv2d(*t, **kw), x, w, b)
    got, got_g = _port_grad(lambda *t: PF.conv2d(*t, **kw), x, w, b)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **F32)
    for g, r, name in zip(got_g, want_g, "xwb"):
        np.testing.assert_allclose(g, r, err_msg=name, **F32)


def test_conv2d_nhwc_output_is_a_channels_last_view():
    """NHWC runs as an NCHW-shaped tensor with channels_last strides: the
    output is a view of the conv's channels_last result, not a copy."""
    x = torch.randn(2, 9, 9, 4)
    w = torch.randn(6, 4, 3, 3).contiguous(memory_format=torch.channels_last)
    out = PF.conv2d(x, w, padding=1, data_format="NHWC")
    assert out.shape == (2, 9, 9, 6) and out.is_contiguous()
    assert out.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)


PAD_SPATIAL = [([1, 2], "NCHW"), ([1, 2, 3, 0], "NCHW"),
               ([4, 2, 4, 2], "NHWC"), ([1, 0, 2, 1], "NHWC")]
# every mode on the spatial lists; a full-rank list (every axis, first
# axis first) in constant mode, since torch pads only trailing axes in the
# others
PAD_CASES = [(p, f, m) for p, f in PAD_SPATIAL
             for m in ("constant", "reflect", "replicate", "circular")] + \
    [([0, 0, 1, 1, 2, 0, 0, 3], "NCHW", "constant")]


@pytest.mark.parametrize("pads,fmt,mode", PAD_CASES,
                         ids=[f"{p}-{f}-{m}" for p, f, m in PAD_CASES])
def test_pad_matches_reference(pads, fmt, mode):
    x = np.random.RandomState(1).randn(2, 5, 6, 7).astype("float32")
    kw = dict(mode=mode, data_format=fmt)
    if mode == "constant":
        kw["value"] = 0.5
    want = RF.pad(paddle.to_tensor(x), pads, **kw).numpy()
    got = PF.pad(torch.tensor(x), pads, **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


def test_pad_nhwc_never_pads_channels():
    x = torch.zeros(1, 4, 4, 3)
    assert PF.pad(x, [4, 2, 4, 2], data_format="NHWC").shape == (1, 10, 10, 3)
    assert PF.pad(x, [4, 2, 4, 2], data_format="NCHW").shape == (1, 4, 10, 9)


POOL_CASES = [
    # (kernel, stride, padding)
    (2, 2, 0), (3, 2, 1), (3, 1, 1), (3, 2, "SAME"), (2, 1, "VALID"),
    (3, 2, [1, 0, 0, 1]), ((3, 2), (2, 1), (1, 0)),
]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", POOL_CASES, ids=[str(c) for c in POOL_CASES])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pool2d_matches_reference(kind, case, fmt):
    """max pooling pads with -inf; avg pooling counts only the input's
    elements where explicit padding is nonzero (exclusive) and the whole
    window under "SAME", as the reference does."""
    k, stride, padding = case
    x = np.random.RandomState(2).randn(2, 3, 9, 8).astype("float32")
    if fmt == "NHWC":
        x = _nhwc(x)
    kw = dict(kernel_size=k, stride=stride, padding=padding, data_format=fmt)
    ref_fn = getattr(RF, f"{kind}_pool2d")
    port_fn = getattr(PF, f"{kind}_pool2d")
    want, want_g = _ref_grad(lambda t: ref_fn(t, **kw), x)
    got, got_g = _port_grad(lambda t: port_fn(t, **kw), x)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got_g[0], want_g[0], **F32)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("size", [(1, 1), (3, 3), (4, 3), 5])
def test_adaptive_avg_pool2d_matches_reference(size, fmt):
    """(3, 3) of 9 x 8 divides H only, (4, 3) neither axis, 5 neither:
    windows of unequal size, the reference's floor/ceil rule."""
    x = np.random.RandomState(3).randn(2, 3, 9, 8).astype("float32")
    if fmt == "NHWC":
        x = _nhwc(x)
    want, want_g = _ref_grad(
        lambda t: RF.adaptive_avg_pool2d(t, size, data_format=fmt), x)
    got, got_g = _port_grad(
        lambda t: PF.adaptive_avg_pool2d(t, size, data_format=fmt), x)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got_g[0], want_g[0], **F32)


@pytest.mark.parametrize("fn", ["max_pool2d", "avg_pool2d"])
def test_ceil_mode_raises(fn):
    """The reference accepts ceil_mode=True but pools as with False
    (ROADMAP C-ref-4); the port refuses it rather than diverge."""
    with pytest.raises(NotImplementedError, match="C-ref-4"):
        getattr(PF, fn)(torch.zeros(1, 1, 5, 5), 2, 2, ceil_mode=True)
    with pytest.raises(NotImplementedError, match="C-ref-4"):
        pnn.MaxPool2D(2, 2, ceil_mode=True, device="cpu")(
            torch.zeros(1, 1, 5, 5))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_training_two_steps_matches_reference(fmt):
    """Outputs, the grads of x, weight and bias, and the running statistics
    after two steps at paddle's momentum 0.9 (running = 0.9 running + 0.1
    batch, the variance unbiased), which torch's momentum would invert."""
    rng = np.random.RandomState(4)
    xs = [(rng.randn(4, 5, 6, 3) * 2 + 1).astype("float32")
          for _ in range(2)]
    if fmt == "NHWC":
        xs = [_nhwc(x) for x in xs]
    w = (rng.rand(5) + 0.5).astype("float32")
    b = rng.randn(5).astype("float32")
    rm0 = rng.randn(5).astype("float32")
    rv0 = (rng.rand(5) + 0.5).astype("float32")
    r_rm, r_rv = paddle.to_tensor(rm0), paddle.to_tensor(rv0)
    p_rm, p_rv = torch.tensor(rm0), torch.tensor(rv0)
    for x in xs:
        want, want_g = _ref_grad(lambda xt, wt, bt: RF.batch_norm(
            xt, r_rm, r_rv, wt, bt, training=True, momentum=0.9,
            data_format=fmt), x, w, b)
        got, got_g = _port_grad(lambda xt, wt, bt: PF.batch_norm(
            xt, p_rm, p_rv, wt, bt, training=True, momentum=0.9,
            data_format=fmt), x, w, b)
        np.testing.assert_allclose(got, want, **F32)
        for g, r, name in zip(got_g, want_g, "xwb"):
            np.testing.assert_allclose(g, r, err_msg=name, **F32)
    np.testing.assert_allclose(p_rm.numpy(), r_rm.numpy(), **STATS)
    np.testing.assert_allclose(p_rv.numpy(), r_rv.numpy(), **STATS)
    # the moving average of the first step, by hand
    n = xs[0].size // 5
    axes = (0, 2, 3) if fmt == "NCHW" else (0, 1, 2)
    m1 = 0.9 * rm0 + 0.1 * xs[0].mean(axis=axes)
    v1 = 0.9 * rv0 + 0.1 * xs[0].var(axis=axes) * n / (n - 1)
    m2 = 0.9 * m1 + 0.1 * xs[1].mean(axis=axes)
    v2 = 0.9 * v1 + 0.1 * xs[1].var(axis=axes) * n / (n - 1)
    np.testing.assert_allclose(p_rm.numpy(), m2, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p_rv.numpy(), v2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_eval_matches_reference(fmt):
    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 5, 6).astype("float32")
    if fmt == "NHWC":
        x = _nhwc(x)
    w, b = rng.rand(4).astype("float32") + 0.5, rng.randn(4).astype("float32")
    rm, rv = rng.randn(4).astype("float32"), rng.rand(4).astype("float32") + 1
    want, want_g = _ref_grad(lambda xt, wt, bt: RF.batch_norm(
        xt, paddle.to_tensor(rm), paddle.to_tensor(rv), wt, bt,
        training=False, data_format=fmt), x, w, b)
    p_rm, p_rv = torch.tensor(rm), torch.tensor(rv)
    got, got_g = _port_grad(lambda xt, wt, bt: PF.batch_norm(
        xt, p_rm, p_rv, wt, bt, training=False, data_format=fmt), x, w, b)
    np.testing.assert_allclose(got, want, **F32)
    for g, r, name in zip(got_g, want_g, "xwb"):
        np.testing.assert_allclose(g, r, err_msg=name, **F32)
    assert torch.equal(p_rm, torch.tensor(rm)) and \
        torch.equal(p_rv, torch.tensor(rv))


def test_batch_norm_updates_bf16_buffers_in_place():
    """The running statistics are written into the buffers themselves (a
    captured step replays into the same memory), in the buffers' dtype."""
    rm = torch.zeros(3, dtype=torch.bfloat16)
    rv = torch.ones(3, dtype=torch.bfloat16)
    ptrs = (rm.data_ptr(), rv.data_ptr())
    x = torch.randn(4, 3, 5, 5).bfloat16() + 2
    PF.batch_norm(x, rm, rv, training=True)
    assert (rm.data_ptr(), rv.data_ptr()) == ptrs
    assert rm.dtype == rv.dtype == torch.bfloat16
    assert (rm > 0.1).all() and not torch.equal(rv, torch.ones_like(rv))


def test_layers_state_dict_names_match_reference():
    paddle.seed(0)
    ref = paddle.nn.Sequential(
        paddle.nn.Conv2D(3, 4, 3, padding=1), paddle.nn.BatchNorm2D(4),
        paddle.nn.ReLU(), paddle.nn.MaxPool2D(2, 2),
        paddle.nn.Conv2D(4, 2, 1, bias_attr=False),
        paddle.nn.AdaptiveAvgPool2D(1))
    f = dict(device="cpu")
    port = pnn.Sequential(
        pnn.Conv2D(3, 4, 3, padding=1, **f), pnn.BatchNorm2D(4, **f),
        pnn.ReLU(**f), pnn.MaxPool2D(2, 2, **f),
        pnn.Conv2D(4, 2, 1, bias_attr=False, **f),
        pnn.AdaptiveAvgPool2D(1, **f))
    assert sorted(port.state_dict()) == sorted(ref.state_dict()) == [
        "0.bias", "0.weight", "1._mean", "1._variance", "1.bias",
        "1.weight", "4.weight"]
    arrays = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    pt.load_numpy_state_dict(port, arrays)
    x = np.random.RandomState(6).randn(2, 3, 8, 8).astype("float32")
    ref.eval()
    port.eval()
    np.testing.assert_allclose(port(torch.tensor(x)).detach().numpy(),
                               ref(paddle.to_tensor(x)).numpy(), **F32)


def test_sequential_names_from_pairs_and_slices():
    f = dict(device="cpu")
    seq = pnn.Sequential([("conv", pnn.Conv2D(1, 2, 1, **f)),
                          ("act", pnn.ReLU(**f))])
    assert list(dict(seq.named_children())) == ["conv", "act"]
    seq = pnn.Sequential(pnn.ReLU(**f), pnn.Conv2D(1, 2, 1, **f),
                         pnn.ReLU(**f))
    assert isinstance(seq[1:], pnn.Sequential) and len(seq[1:]) == 2
    assert isinstance(seq[1], pnn.Conv2D)


@pytest.mark.parametrize("groups", [1, 2])
def test_conv2d_init_range_from_the_generator(groups):
    """Weight and bias start at U(-1/sqrt(fan_in), +1/sqrt(fan_in)), fan_in
    = in / groups * kh * kw, drawn from the layer's generator: the same
    seed gives the same weights on every device."""
    def make(seed):
        return pnn.Conv2D(8, 16, 3, groups=groups, device="cpu",
                          generator=pt.make_generator(seed))
    a, b, c = make(0), make(0), make(1)
    bound = 1.0 / np.sqrt(8 // groups * 9)
    for t in (a.weight, a.bias):
        assert t.abs().max().item() <= bound
        assert t.abs().max().item() > 0.9 * bound
    assert torch.equal(a.weight, b.weight) and torch.equal(a.bias, b.bias)
    assert not torch.equal(a.weight, c.weight)
    assert a.weight.shape == (16, 8 // groups, 3, 3)
    assert a._stride == [1, 1] and a._dilation == [1, 1]
    assert a._groups == groups and a._data_format == "NCHW"


def test_conv2d_nhwc_keeps_its_weight_channels_last():
    conv = pnn.Conv2D(3, 4, 3, data_format="NHWC", device="cpu")
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    assert conv.bfloat16().weight.is_contiguous(
        memory_format=torch.channels_last)


def test_batchnorm_layers_buffers_and_bf16_cast():
    bn = pnn.BatchNorm2D(6, device="cpu")
    assert [n for n, _ in bn.named_buffers()] == ["_mean", "_variance"]
    assert torch.equal(bn._mean, torch.zeros(6))
    assert torch.equal(bn._variance, torch.ones(6))
    bn.bfloat16()
    assert bn._mean.dtype == bn._variance.dtype == torch.bfloat16
    assert bn.weight.dtype == torch.bfloat16
    bn1 = pnn.BatchNorm1D(4, device="cpu")
    out = bn1(torch.randn(8, 4))
    assert out.shape == (8, 4) and not torch.equal(bn1._mean,
                                                   torch.zeros(4))
    assert isinstance(pnn.BatchNorm(4, device="cpu"), pnn.layer.norm
                      ._BatchNormBase)
