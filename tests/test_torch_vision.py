"""The conv net slice of the port against the JAX reference on the host.

ResNet-18, ResNet-50 and LeNet are built by paddle_tpu, their weights and
running statistics carried into paddle_tpu_torch by name, and the same
numpy images and labels (from a seeded RandomState) run one training step
through both in f32.

- ResNet-18 (2 x 3 x 64 x 64, 3 classes), NCHW and NHWC, both stems,
  fused conv + BN and not: logits and loss within 1e-5 relative, every
  grad within 1e-4 relative L2, the moved running statistics within 1e-6.
- ResNet-50, the same input. At 2 x 64 x 64 its deepest BatchNorms
  normalize over 8 to 32 values a channel, and a training step's grads
  are ill-conditioned in f32: the port's f32 grads are a median 3.3% and
  up to 5.6% (relative L2) from the same step in f64, the reference's a
  median 3.8% and up to 5.8%. No f32 implementation meets a flat 1e-4
  there, so the training step is held to R50_NOISE_FACTOR x the port's own
  f32 noise (its f32 result against the same port in f64) over the whole
  model, plus the flat bounds: this catches a wiring fault, which moves
  grads by O(1), but not a 1% one. The flat bounds hold in eval mode,
  where BatchNorm uses the running statistics and the network is well
  conditioned: from the reference's weights and moved statistics after
  its step, the eval logits within 1e-5 and every grad within 1e-4. On the
  host the reference's fused op takes plain autodiff of the same forward
  (its measured policy), so one reference run serves the port's fused and
  unfused models.

Also: NHWC against NCHW and the space-to-depth stem against the plain one
on the port alone (in f64, where they agree to rounding), LeNet, a ResNet-18 training under to_static +
run_steps, the state dict's names, and .pdparams files between the
packages in f32 and bf16.
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.vision import models as pmodels

torch.set_num_threads(1)

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
STATS = dict(rtol=1e-6, atol=1e-6)
R50_NOISE_FACTOR = 2.0


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _batch(fmt, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 3, 64, 64).astype("float32")
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return x, np.array([0, classes - 1], "int64")


def _step_result(logits, loss, model, numpy_of):
    return {"logits": numpy_of(logits), "loss": float(loss),
            "grads": {n: numpy_of(p.grad)
                      for n, p in model.named_parameters()},
            "stats": {k: numpy_of(v) for k, v in model.state_dict().items()
                      if k.endswith(("_mean", "_variance"))}}


def _ref_numpy(t):
    return np.asarray(t.numpy())


def _reference(depth, fmt, stem, fused, eval_step=False):
    """The reference model's arrays, and its logits, loss, grads and
    running statistics after one training-mode forward and backward; with
    ``eval_step``, also the arrays after that step (the moved statistics)
    and an eval-mode forward and backward from them."""
    paddle.seed(0)
    ref = getattr(paddle.vision.models, f"resnet{depth}")(
        num_classes=3, data_format=fmt, stem=stem, fused_conv_bn=fused)
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    x, y = _batch(fmt)
    logits = ref(paddle.to_tensor(x))
    loss = RF.cross_entropy(logits, paddle.to_tensor(y))
    loss.backward()
    train = _step_result(logits, loss, ref, _ref_numpy)
    if not eval_step:
        return arrays, train
    moved = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    ref.clear_gradients()
    ref.eval()
    logits = ref(paddle.to_tensor(x))
    loss = RF.cross_entropy(logits, paddle.to_tensor(y))
    loss.backward()
    return arrays, train, moved, _step_result(logits, loss, ref, _ref_numpy)


def _port(depth, fmt, stem, fused, arrays, dtype=torch.float32,
          train=True):
    port = getattr(pmodels, f"resnet{depth}")(
        num_classes=3, data_format=fmt, stem=stem, fused_conv_bn=fused,
        device="cpu")
    pt.load_numpy_state_dict(port, arrays)
    port.to(dtype).train(train)
    x, y = _batch(fmt)
    logits = port(torch.tensor(x, dtype=dtype))
    loss = PF.cross_entropy(logits, torch.tensor(y))
    loss.backward()
    return _step_result(logits, loss.detach(), port,
                        lambda t: t.detach().double().numpy())


R18_CASES = [(fmt, stem, fused) for fmt in ("NCHW", "NHWC")
             for stem in ("conv", "space_to_depth") for fused in (False, True)]


@pytest.mark.parametrize("fmt,stem,fused", R18_CASES,
                         ids=[f"{f}-{s}-{'fused' if u else 'unfused'}"
                              for f, s, u in R18_CASES])
def test_resnet18_step_matches_reference(fmt, stem, fused):
    arrays, want = _reference(18, fmt, stem, fused)
    got = _port(18, fmt, stem, fused, arrays)
    assert _rel_l2(got["logits"], want["logits"]) <= LOSS_RTOL
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, g in want["grads"].items():
        assert _rel_l2(got["grads"][name], g) <= GRAD_RTOL, name
    assert sorted(got["stats"]) == sorted(want["stats"])
    assert len(want["stats"]) == 2 * 20
    for name, s in want["stats"].items():
        np.testing.assert_allclose(got["stats"][name], s, err_msg=name,
                                   **STATS)


_R50_REFERENCE = {}
R50_CASES = [("NHWC", "space_to_depth", True), ("NCHW", "conv", False)]


def _r50_reference(key):
    if key not in _R50_REFERENCE:
        _R50_REFERENCE[key] = _reference(50, *key, eval_step=True)
    return _R50_REFERENCE[key]


@pytest.mark.parametrize("port_fused", [True, False],
                         ids=["port-fused", "port-unfused"])
@pytest.mark.parametrize("fmt,stem,fused", R50_CASES,
                         ids=[f"{f}-{s}" for f, s, _ in R50_CASES])
def test_resnet50_step_matches_reference(fmt, stem, fused, port_fused):
    arrays, want, _, _ = _r50_reference((fmt, stem, fused))
    got = _port(50, fmt, stem, port_fused, arrays)
    exact = _port(50, fmt, stem, port_fused, arrays, torch.float64)
    noise = max(_rel_l2(got["grads"][n], exact["grads"][n])
                for n in exact["grads"])
    loss_noise = abs(got["loss"] - exact["loss"]) / abs(exact["loss"])
    logits_noise = _rel_l2(got["logits"], exact["logits"])
    stats_noise = max(np.abs(got["stats"][n] - exact["stats"][n]).max()
                      for n in exact["stats"])
    k = R50_NOISE_FACTOR
    assert _rel_l2(got["logits"], want["logits"]) <= \
        k * logits_noise + LOSS_RTOL
    assert abs(got["loss"] - want["loss"]) <= \
        (k * loss_noise + LOSS_RTOL) * abs(want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    assert len(want["grads"]) == 161
    for name, g in want["grads"].items():
        assert _rel_l2(got["grads"][name], g) <= k * noise + GRAD_RTOL, \
            (name, noise)
    for name, s in want["stats"].items():
        gap = np.abs(got["stats"][name] - s).max()
        assert gap <= k * stats_noise + STATS["atol"], (name, gap)


@pytest.mark.parametrize("port_fused", [True, False],
                         ids=["port-fused", "port-unfused"])
@pytest.mark.parametrize("fmt,stem,fused", R50_CASES,
                         ids=[f"{f}-{s}" for f, s, _ in R50_CASES])
def test_resnet50_eval_step_matches_reference(fmt, stem, fused, port_fused):
    """Eval mode from the reference's weights and moved statistics after
    its training step (the fused path's folded statistics, or BatchNorm in
    eval): logits, loss and every grad at the flat bounds."""
    _, _, moved, want = _r50_reference((fmt, stem, fused))
    got = _port(50, fmt, stem, port_fused, moved, train=False)
    assert _rel_l2(got["logits"], want["logits"]) <= LOSS_RTOL
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    for name, g in want["grads"].items():
        assert _rel_l2(got["grads"][name], g) <= GRAD_RTOL, name
    for name, s in want["stats"].items():
        assert np.array_equal(got["stats"][name], s), name


def test_resnet_nhwc_matches_nchw():
    """data_format="NHWC" is the same network channels-last (tests/
    test_vision_models.py's check, on the port): the NCHW and NHWC models
    share their weights (OIHW in both layouts) and a training step agrees
    to f64 rounding. In f64, because in f32 a ReLU input within rounding
    of 0 can flip its mask between the two orders of summation (it does
    for this draw, moving the early layers' grads by ~3e-3)."""
    m_nchw = pmodels.resnet18(num_classes=7, device="cpu",
                              generator=pt.make_generator(3)).double()
    m_nhwc = pmodels.resnet18(num_classes=7, data_format="NHWC",
                              device="cpu",
                              generator=pt.make_generator(3)).double()
    for a, b in zip(m_nchw.state_dict().values(),
                    m_nhwc.state_dict().values()):
        assert torch.equal(a, b)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 64, 64)
    y = torch.tensor(rng.randint(0, 7, (2,)))
    losses = []
    for model, xin in ((m_nchw, x), (m_nhwc, x.transpose(0, 2, 3, 1))):
        loss = PF.cross_entropy(model(torch.tensor(
            np.ascontiguousarray(xin))), y)
        loss.backward()
        losses.append(loss.item())
    assert abs(losses[0] - losses[1]) <= 1e-12 * abs(losses[0])
    for (name, a), b in zip(m_nchw.named_parameters(),
                            m_nhwc.parameters()):
        assert _rel_l2(b.grad, a.grad) <= 1e-10, name
    for (name, a), b in zip(m_nchw.named_buffers(), m_nhwc.buffers()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_space_to_depth_stem_is_the_same_conv(fmt):
    """stem="space_to_depth" computes conv1 as a 4 x 4 conv over 2 x 2
    folded input: the same output up to the order of the sums (1e-5 in
    f32, the reference's test, and to f64 rounding in f64), with
    conv1.weight kept at (64, 3, 7, 7), so the state dicts are the
    same."""
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        m1, m2 = (pmodels.resnet18(num_classes=5, data_format=fmt,
                                   stem=stem, device="cpu",
                                   generator=pt.make_generator(0))
                  .to(dtype).eval() for stem in ("conv", "space_to_depth"))
        assert m2.conv1.weight.shape == (64, 3, 7, 7)
        shape = (2, 3, 64, 64) if fmt == "NCHW" else (2, 64, 64, 3)
        x = torch.tensor(np.random.RandomState(0).randn(*shape), dtype=dtype)
        with torch.no_grad():
            np.testing.assert_allclose(m2(x).numpy(), m1(x).numpy(),
                                       rtol=tol, atol=tol / 10)
            # the stem alone, before BN: the folded conv equals conv1
            xs, ws = m2._stem_space_to_depth(x)
            folded = PF.conv2d(xs, ws, data_format=fmt)
            plain = PF.conv2d(x, m1.conv1.weight, stride=2, padding=3,
                              data_format=fmt)
            np.testing.assert_allclose(folded.numpy(), plain.numpy(),
                                       rtol=tol, atol=tol)


def test_lenet_step_matches_reference():
    paddle.seed(0)
    ref = paddle.vision.models.LeNet()
    port = pmodels.LeNet(device="cpu")
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    assert sorted(port.state_dict()) == sorted(arrays) == sorted([
        "features.0.weight", "features.0.bias", "features.3.weight",
        "features.3.bias", "fc.0.weight", "fc.0.bias", "fc.1.weight",
        "fc.1.bias", "fc.2.weight", "fc.2.bias"])
    pt.load_numpy_state_dict(port, arrays)
    rng = np.random.RandomState(1)
    x = rng.randn(4, 1, 28, 28).astype("float32")
    y = rng.randint(0, 10, (4,)).astype("int64")
    r_logits = ref(paddle.to_tensor(x))
    r_loss = RF.cross_entropy(r_logits, paddle.to_tensor(y))
    r_loss.backward()
    p_logits = port(torch.tensor(x))
    p_loss = PF.cross_entropy(p_logits, torch.tensor(y))
    p_loss.backward()
    assert _rel_l2(p_logits.detach(), r_logits.numpy()) <= LOSS_RTOL
    assert abs(p_loss.item() - float(r_loss)) <= LOSS_RTOL * float(r_loss)
    for name, p in ref.named_parameters():
        assert _rel_l2(dict(port.named_parameters())[name].grad,
                       np.asarray(p.grad._val)) <= GRAD_RTOL, name


def test_resnet18_trains_under_to_static_run_steps():
    """The fused Function runs through the port's to_static + run_steps
    (the bench path) and the loss falls on a learnable stream: the
    reference's own test (tests/test_fused_conv_bn.py), with its weights
    carried. The first two steps match the reference's."""
    paddle.seed(0)
    ref = paddle.vision.models.resnet18(num_classes=4, fused_conv_bn=True)
    ref_opt = paddle.optimizer.Momentum(learning_rate=0.005, momentum=0.9,
                                        parameters=ref.parameters())
    model = pmodels.resnet18(num_classes=4, fused_conv_bn=True, device="cpu")
    pt.load_numpy_state_dict(model, {k: np.asarray(v._val)
                                     for k, v in ref.state_dict().items()})
    opt = pt.optimizer.Momentum(learning_rate=0.005, momentum=0.9,
                                parameters=model.parameters())
    rng = np.random.RandomState(0)
    protos = rng.randn(4, 3, 32, 32).astype("float32")
    ys = rng.randint(0, 4, (16, 8))
    xs = (protos[ys] + 0.25 * rng.randn(16, 8, 3, 32, 32)).astype("float32")

    @pt.jit.to_static
    def step(x, y):
        loss = PF.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    mean_before = model.bn1._mean.clone()
    c = step.run_steps(torch.tensor(xs), torch.tensor(ys)).numpy()
    assert c[-3:].mean() < 0.8 * c[:3].mean(), c
    assert not torch.equal(model.bn1._mean, mean_before)
    for i in range(2):
        loss = RF.cross_entropy(ref(paddle.to_tensor(xs[i])),
                                paddle.to_tensor(ys[i].astype("int64")))
        loss.backward()
        ref_opt.step()
        ref_opt.clear_grad()
        assert abs(c[i] - float(loss)) <= 1e-4 * float(loss), (i, c[i])


def test_state_dict_names_are_the_references():
    paddle.seed(0)
    ref = paddle.vision.models.resnet50(num_classes=3)
    port = pmodels.resnet50(num_classes=3, device="cpu")
    r_sd, p_sd = ref.state_dict(), port.state_dict()
    assert sorted(p_sd) == sorted(r_sd)
    assert len(p_sd) == 161 + 2 * 53
    assert {k: tuple(v.shape) for k, v in p_sd.items()} == \
        {k: tuple(v.shape) for k, v in r_sd.items()}
    assert "layer1.0.downsample.0.weight" in p_sd
    assert "layer4.2.bn3._variance" in p_sd
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pdparams_cross_both_ways(tmp_path, dtype):
    """A reference ResNet's state dict (with its _mean and _variance
    buffers, in f32 and in bf16) loads into the port with no renaming, and
    a file the port writes has the same names, dtypes and bytes and loads
    back into the reference."""
    paddle.seed(0)
    src = paddle.vision.models.resnet18(num_classes=3, data_format="NHWC")
    if dtype == "bfloat16":
        src.bfloat16()
    ref_path = tmp_path / "ref.pdparams"
    paddle.save(src.state_dict(), str(ref_path))
    port = pmodels.resnet18(num_classes=3, data_format="NHWC", device="cpu")
    if dtype == "bfloat16":
        port.bfloat16()
    pt.load_numpy_state_dict(port, pt.load(str(ref_path)))
    assert port.bn1._variance.dtype == getattr(torch, dtype)
    port_path = tmp_path / "port.pdparams"
    pt.save(port.state_dict(), str(port_path))
    with open(ref_path, "rb") as f:
        a = pickle.load(f)
    with open(port_path, "rb") as f:
        b = pickle.load(f)
    assert sorted(a) == sorted(b)
    for name in a:
        x, y = a[name]["data"], b[name]["data"]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.ascontiguousarray(x).tobytes() == \
            np.ascontiguousarray(y).tobytes(), name
    ref2 = paddle.vision.models.resnet18(num_classes=3, data_format="NHWC")
    if dtype == "bfloat16":
        ref2.bfloat16()
    ref2.set_state_dict(paddle.load(str(port_path)))
    for name, v in ref2.state_dict().items():
        assert np.asarray(v._val).tobytes() == \
            np.ascontiguousarray(a[name]["data"]).tobytes(), name


def test_nhwc_step_copies_no_activation_to_change_layout():
    """A channels-last training step (ResNet-18, NHWC, the space-to-depth
    stem, fused conv + BN) makes no copy that changes an activation's
    memory layout: every copy whose output strides differ from its
    input's (NCHW-contiguous against channels_last) is of a weight, the
    stem's folded weight (64, 12, 4, 4) once forward and once backward and
    conv1.weight's grad (64, 3, 7, 7), which comes back through the fold
    contiguous and is laid out as its channels_last parameter."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def layout(t):
        if t.dim() != 4 or t.is_contiguous():
            return "contiguous"
        if t.is_contiguous(memory_format=torch.channels_last):
            return "channels_last"
        return "strided"

    class LayoutCopies(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__
            if name.startswith(("copy_", "clone", "_to_copy",
                                "contiguous")):
                src, dst = (args[1], args[0]) if name.startswith("copy_") \
                    else (args[0], out)
                if layout(src) != layout(dst):
                    self.shapes.append(tuple(src.shape))
            return out

    model = pmodels.resnet18(num_classes=10, data_format="NHWC",
                             stem="space_to_depth", device="cpu",
                             generator=pt.make_generator(0))
    opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                parameters=model.parameters())
    x = torch.randn(4, 64, 64, 3)
    y = torch.tensor([1, 2, 3, 4])

    def step():
        PF.cross_entropy(model(x), y).backward()
        opt.step()
        opt.clear_grad()
    step()      # the optimizer's state is made on the first step
    copies = LayoutCopies()
    with copies:
        step()
    assert sorted(copies.shapes) == [(64, 3, 7, 7)] + [(64, 12, 4, 4)] * 2, \
        copies.shapes
