"""The port's fused [ReLU ->] Conv2D -> BatchNorm op against the reference's
and against the port's own unfused composition, on the host.

Mirrors tests/test_fused_conv_bn.py. The reference's op is forced onto its
custom_vjp (FLAGS_fusion_policy=always: on the CPU its measured policy
would pick plain autodiff). f32 tolerances: against the reference, the
output and every grad 1e-5 relative + 1e-5 absolute (sums in another
order), running statistics 1e-6; against the port's unfused composition
the forward is equal to the bit (the same association) and the grads
within 1e-5 of the largest grad (the backward sums in another order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.fused_conv_bn import fused_conv_bn as ref_fused_conv_bn

import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.ops import fused_conv_bn as fcb
from paddle_tpu_torch.ops.fused_conv_bn import fused_conv_bn

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
STATS = dict(rtol=1e-6, atol=1e-6)
# the port's fused grads against its unfused ones: max |a - b| over max |b|
UNFUSED_GRAD_TOL = 1e-5


@pytest.fixture
def fusion_always():
    prev = paddle.get_flags(["FLAGS_fusion_policy"])
    paddle.set_flags({"FLAGS_fusion_policy": "always"})
    yield
    paddle.set_flags(prev)


def _inputs(fmt, k, seed=0, cin=6, cout=8, gamma_zero=None):
    rng = np.random.RandomState(seed)
    x = (rng.randn(2, cin, 12, 12) * 2 + 0.5).astype("float32")
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = (rng.randn(cout, cin, k, k) * 0.2).astype("float32")
    g = (rng.rand(cout) + 0.5).astype("float32")
    if gamma_zero is not None:
        g[gamma_zero] = 0.0
    b = (rng.randn(cout) * 0.1).astype("float32")
    return x, w, g, b


def _loss_weights(shape):
    return np.random.RandomState(7).randn(*shape).astype("float32")


def _port(arrays, fused, dtype=torch.float32, **kw):
    """y, the grads of x, w, gamma, beta and the running statistics after
    one call, fused or through F.relu -> F.conv2d -> F.batch_norm."""
    x, w, g, b = [torch.tensor(a).to(dtype).requires_grad_()
                  if i < 2 else torch.tensor(a).requires_grad_()
                  for i, a in enumerate(arrays)]
    cout = w.shape[0]
    rm, rv = torch.zeros(cout), torch.ones(cout)
    act, fmt = kw.pop("act_input", False), kw["data_format"]
    if fused:
        y = fused_conv_bn(x, w, g, b, rm, rv, training=True,
                          act_input=act, **kw)
    else:
        z = PF.conv2d(PF.relu(x) if act else x, w, None, **kw)
        y = PF.batch_norm(z, rm, rv, g, b, training=True, data_format=fmt)
    (torch.tanh(y.float() * 0.1) * torch.tensor(
        _loss_weights(y.shape))).sum().backward()
    return {"y": y.detach().float().numpy(),
            **{n: t.grad.float().numpy() for n, t in zip("xwgb",
                                                        (x, w, g, b))},
            "rm": rm.numpy(), "rv": rv.numpy()}


def _ref(arrays, **kw):
    x, w, g, b = [paddle.to_tensor(a) for a in arrays]
    for t in (x, w, g, b):
        t.stop_gradient = False
    cout = arrays[1].shape[0]
    rm = paddle.to_tensor(np.zeros(cout, "float32"))
    rv = paddle.to_tensor(np.ones(cout, "float32"))
    y = ref_fused_conv_bn(x, w, g, b, rm, rv, training=True, **kw)
    out = (y.astype("float32") * 0.1).tanh() * paddle.to_tensor(
        _loss_weights(y.shape))
    out.sum().backward()
    return {"y": np.asarray(y.numpy()),
            **{n: np.asarray(t.grad.numpy())
               for n, t in zip("xwgb", (x, w, g, b))},
            "rm": np.asarray(rm.numpy()), "rv": np.asarray(rv.numpy())}


def _assert_close_to_max(got, want, tol, name):
    gap = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
    assert gap <= tol, (name, gap)


CASES = [(1, 1, 0), (3, 1, 1), (3, 2, 1), (4, 2, "SAME"), (3, 2, [0, 1, 1, 0])]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,stride,pad", CASES,
                         ids=[str(c) for c in CASES])
@pytest.mark.parametrize("act_in", [False, True])
def test_fused_matches_reference_fused(fusion_always, fmt, k, stride, pad,
                                       act_in):
    arrays = _inputs(fmt, k)
    kw = dict(stride=stride, padding=pad, data_format=fmt, act_input=act_in)
    want = _ref(arrays, **kw)
    got = _port(arrays, True, **kw)
    for key in ("y", "x", "w", "g", "b"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **F32)
    for key in ("rm", "rv"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **STATS)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("k,stride,pad", CASES,
                         ids=[str(c) for c in CASES])
@pytest.mark.parametrize("act_in", [False, True])
def test_fused_matches_unfused_composition(fmt, k, stride, pad, act_in):
    arrays = _inputs(fmt, k)
    kw = dict(stride=stride, padding=pad, data_format=fmt, act_input=act_in)
    fused, plain = _port(arrays, True, **kw), _port(arrays, False, **kw)
    np.testing.assert_array_equal(fused["y"], plain["y"])
    for key in ("x", "w", "g", "b"):
        _assert_close_to_max(fused[key], plain[key], UNFUSED_GRAD_TOL, key)
    np.testing.assert_array_equal(fused["rm"], plain["rm"])
    np.testing.assert_array_equal(fused["rv"], plain["rv"])


@pytest.mark.parametrize("act_in", [False, True])
def test_function_saves_no_conv_output(act_in):
    """The Function's residuals are (x, w, gamma, beta, inv, y): the input
    and the weight as given, per-channel vectors, and its own output y;
    neither the conv output z nor relu(x)."""
    x, w, g, b = (torch.tensor(a).requires_grad_()
                  for a in _inputs("NCHW", 3))
    y = fused_conv_bn(x, w, g, b, torch.zeros(8), torch.ones(8),
                      training=True, padding=1, act_input=act_in)
    saved = y.grad_fn.saved_tensors
    assert isinstance(y.grad_fn, fcb._FusedConvBNFn._backward_cls)
    assert len(saved) == 6
    assert saved[0].data_ptr() == x.data_ptr()
    assert saved[1].data_ptr() == w.data_ptr()
    assert saved[5].data_ptr() == y.data_ptr()
    assert [tuple(t.shape) for t in saved[2:5]] == [(8,)] * 3
    with torch.no_grad():
        z = torch.nn.functional.conv2d(torch.relu(x) if act_in else x, w,
                                       padding=1)
    act_shaped = [t for t in saved if t.shape == z.shape]
    assert len(act_shaped) == 1 and act_shaped[0].data_ptr() == y.data_ptr()
    assert not any(t.shape == z.shape and torch.equal(t, z) for t in saved)
    assert not any(t.shape == x.shape and torch.equal(t, torch.relu(x))
                   and act_in for t in saved[1:])


def test_gamma_zero_routes_through_plain_autograd():
    """An exactly zero gamma channel would be frozen by the custom backward
    (x_hat cannot be rebuilt there): the guard routes the call through
    plain autograd of the same forward, so that channel learns, and the
    grads equal the unfused composition's."""
    arrays = _inputs("NCHW", 3, gamma_zero=3)
    kw = dict(stride=1, padding=1, data_format="NCHW")
    got = _port(arrays, True, **kw)
    want = _port(arrays, False, **kw)
    for key in ("x", "w", "g", "b"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   rtol=1e-4, atol=1e-5)
    assert got["g"][3] != 0.0


def test_gamma_zero_band_in_the_function_gives_exact_zeros():
    """The custom backward itself (reached when the guard's cached verdict
    says the weight is live): channels with |gamma| <= 1e-6 get dgamma = 0
    and no garbage in dx."""
    x, w, g, b = (torch.tensor(a).requires_grad_()
                  for a in _inputs("NCHW", 3, gamma_zero=3))
    cfg = ((1, 1), (1, 1), None, (1, 1), 1, False, False)
    y, _, _ = fcb._FusedConvBNFn.apply(x, w, g, b, cfg, 1e-5)
    torch.tanh(y).sum().backward()
    assert g.grad[3].item() == 0.0
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() < 1e3
    assert torch.isfinite(b.grad[3])


def test_degenerate_verdict_is_cached_on_the_parameter():
    """The guard syncs the host once per parameter, so a captured step
    reads a cached verdict."""
    x, w, g, b = (torch.tensor(a).requires_grad_()
                  for a in _inputs("NCHW", 1))
    g = torch.nn.Parameter(g.detach())
    fused_conv_bn(x, w, g, b, training=True)
    assert g._degen_cache == (fcb._GAMMA_TOL, False)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("act_in", [False, True])
def test_eval_folds_running_statistics(fusion_always, fmt, act_in):
    """Eval folds the running statistics into a scale and shift after the
    conv: it matches the reference's eval branch and the unfused
    composition with BatchNorm in eval, and leaves the statistics alone."""
    x, w, g, b = _inputs(fmt, 3, seed=1)
    rng = np.random.RandomState(2)
    rm = (rng.randn(8) * 0.2).astype("float32")
    rv = (rng.rand(8) + 0.5).astype("float32")
    kw = dict(stride=1, padding=1, data_format=fmt, act_input=act_in)
    want = ref_fused_conv_bn(*[paddle.to_tensor(a)
                               for a in (x, w, g, b, rm, rv)],
                             training=False, **kw).numpy()
    p_rm, p_rv = torch.tensor(rm), torch.tensor(rv)
    got = fused_conv_bn(*[torch.tensor(a) for a in (x, w, g, b)], p_rm,
                        p_rv, training=False, **kw)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    xt = torch.tensor(x)
    z = PF.conv2d(PF.relu(xt) if act_in else xt, torch.tensor(w), None,
                  stride=1, padding=1, data_format=fmt)
    plain = PF.batch_norm(z, p_rm, p_rv, torch.tensor(g), torch.tensor(b),
                          training=False, data_format=fmt)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32)
    assert torch.equal(p_rm, torch.tensor(rm))
    assert torch.equal(p_rv, torch.tensor(rv))


def test_bf16_statistics_in_f32_beat_the_unfused_composition():
    """bf16 inputs: the fused op computes batch statistics and the BN
    backward in f32, so its output and grads sit closer to the f32 truth
    than the unfused composition, which reduces in bf16 (the reference's
    own test)."""
    arrays = _inputs("NCHW", 3)
    kw = dict(stride=1, padding=1, data_format="NCHW", act_input=True)
    truth = _port(arrays, True, **kw)
    fused = _port(arrays, True, dtype=torch.bfloat16, **kw)
    plain = _port(arrays, False, dtype=torch.bfloat16, **kw)
    for key in ("y", "x", "w", "g"):
        t = truth[key]
        denom = np.abs(t).max() + 1e-6
        e_fused = np.abs(fused[key] - t).max() / denom
        e_plain = np.abs(plain[key] - t).max() / denom
        assert e_fused < 0.10, (key, e_fused)
        assert e_fused <= e_plain + 0.01, (key, e_fused, e_plain)


def test_bf16_matches_reference_fused(fusion_always):
    """bf16 x and w (f32 gamma, beta, statistics): the same op in both
    packages, to a few bf16 ulps of the output and grads."""
    arrays = _inputs("NHWC", 3)
    kw = dict(stride=2, padding=1, data_format="NHWC", act_input=True)
    got = _port(arrays, True, dtype=torch.bfloat16, **kw)
    x, w, g, b = arrays
    import ml_dtypes
    bf = [a.astype(ml_dtypes.bfloat16) for a in (x, w)]
    want = _ref([*bf, g, b], **kw)
    for key in ("y", "x", "w", "g", "b"):
        _assert_close_to_max(got[key], np.asarray(want[key], np.float32),
                             2 ** -6, key)
