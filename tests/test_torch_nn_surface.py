"""The common surface of the PyTorch/CUDA port (top-level names, the
nn.Layer API, the activations, nn.functional's common functions, the
initializers, the activation, common and container layers) against the
JAX reference on the host.

Every case of tests/test_torch_nn_cases.py runs through both packages on
the same numpy inputs and weights; the outputs (after the case's
``post``) must have the same dtypes and agree: floats within rtol 1e-6 /
atol 1e-6, 1e-5 for interpolate and fold and for the reference's own
test_nn.py layers whose matmuls sum in another order (the case says
so), integers and bools exactly. The activations' gradients are held
against the reference's autograd; the remaining public names of each
namespace against the reference's, less the ones the roadmap assigns
to later slices.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from test_torch_nn_cases import CASES
from test_torch_tensor_ops import _numpy, assert_same, run_case

torch.set_num_threads(1)

DEFAULT_TOL = {"rtol": 1e-6, "atol": 1e-6}


@pytest.fixture(autouse=True)
def _on_host():
    before = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(before)


@pytest.fixture
def default_dtypes():
    """Restore both packages' default dtype (process-wide state)."""
    r, p = ref.get_default_dtype(), pt.get_default_dtype()
    yield
    ref.set_default_dtype(r)
    pt.set_default_dtype(p)


@pytest.mark.parametrize("c", CASES, ids=[c.id for c in CASES])
def test_nn_case_matches_reference(c):
    ref.seed(0)
    pt.seed(0)
    want = run_case(ref, c)
    got = run_case(pt, c)
    assert_same(got, want, {**DEFAULT_TOL, **c.tol}, c.id)


# -- gradients of the activations against the reference's autograd -----------
GRAD_CASES = [
    ("relu", {}), ("relu6", {}), ("elu", {"alpha": 0.5}), ("selu", {}),
    ("celu", {"alpha": 1.5}), ("gelu", {}), ("gelu", {"approximate": True}),
    ("sigmoid", {}), ("log_sigmoid", {}), ("tanh", {}), ("tanhshrink", {}),
    ("hardtanh", {}), ("hardshrink", {}), ("hardsigmoid", {}),
    ("hardswish", {}), ("leaky_relu", {"negative_slope": 0.2}),
    ("softmax", {"axis": 0}), ("log_softmax", {}), ("softplus", {}),
    ("softplus", {"beta": 3.0, "threshold": 4.0}), ("softshrink", {}),
    ("softsign", {}), ("swish", {}), ("silu", {}), ("mish", {}),
    ("maxout", {"groups": 2}), ("glu", {}), ("thresholded_relu", {}),
    ("normalize", {}), ("normalize", {"p": 1})]


@pytest.mark.parametrize("name,kw", GRAD_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(GRAD_CASES)])
def test_activation_grad_matches_reference(name, kw):
    rng = np.random.RandomState(3)
    a = (2.5 * rng.randn(4, 6)).astype("float32")
    rx = ref.to_tensor(a, stop_gradient=False)
    ry = getattr(ref.nn.functional, name)(rx, **kw)
    w = rng.randn(*ry.shape).astype("float32")
    ref.sum(ry * ref.to_tensor(w)).backward()
    px = torch.tensor(a, requires_grad=True)
    py = getattr(pt.nn.functional, name)(px, **kw)
    (py * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(rx.grad._val),
                               rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "linear"])
@pytest.mark.parametrize("align", [False, True])
def test_interpolate_grad_matches_reference(mode, align):
    rng = np.random.RandomState(4)
    shape = (2, 3, 7) if mode == "linear" else (2, 3, 6, 5)
    size = [11] if mode == "linear" else [9, 4]
    fmt = "NCL" if mode == "linear" else "NCHW"
    a = rng.randn(*shape).astype("float32")
    rx = ref.to_tensor(a, stop_gradient=False)
    ry = ref.nn.functional.interpolate(rx, size=size, mode=mode,
                                       align_corners=align, data_format=fmt)
    w = rng.randn(*ry.shape).astype("float32")
    ref.sum(ry * ref.to_tensor(w)).backward()
    px = torch.tensor(a, requires_grad=True)
    py = pt.nn.functional.interpolate(px, size=size, mode=mode,
                                      align_corners=align, data_format=fmt)
    (py * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(rx.grad._val),
                               rtol=1e-5, atol=1e-5)


# -- the arguments the reference never reads raise in the port (C-ref-15) --------
def test_interpolate_unread_arguments_raise():
    x = torch.zeros(1, 1, 4, 4)
    F = pt.nn.functional
    with pytest.raises(NotImplementedError, match="C-ref-15"):
        F.interpolate(x, size=[8, 8], mode="bilinear", align_mode=1)
    with pytest.raises(NotImplementedError, match="C-ref-15"):
        F.interpolate(x, size=[8, 8], mode="nearest", align_corners=True)
    with pytest.raises(NotImplementedError, match="C-ref-15"):
        F.diag_embed(torch.zeros(2, 3), offset=1)
    # align_mode=1 is moot once align_corners is set, as in paddle
    assert F.interpolate(x, size=[8, 8], mode="bilinear", align_corners=True,
                         align_mode=1).shape == (1, 1, 8, 8)
    with pytest.raises(NotImplementedError, match="out of scope"):
        F.class_center_sample(torch.zeros(4, dtype=torch.int64), 10, 4)


def test_class_center_sample_raises_in_both_packages():
    """Parity, not a gap: the reference raises too (parameter-server
    oriented, out of its scope)."""
    import paddle_tpu.nn.functional as RF
    with pytest.raises(NotImplementedError, match="out of scope"):
        RF.class_center_sample(ref.to_tensor(np.zeros(4, "int64")), 10, 4)
    with pytest.raises(NotImplementedError, match="out of scope"):
        pt.nn.functional.class_center_sample(
            torch.zeros(4, dtype=torch.int64), 10, 4)


def test_area_is_the_antialiased_linear_resize():
    """The reference maps 'area' to antialiased linear (C-ref-15): the
    port mirrors it, so it is not a box average."""
    x = torch.arange(16.0).reshape(1, 1, 4, 4)
    F = pt.nn.functional
    area = F.interpolate(x, size=[2, 2], mode="area")
    assert torch.equal(area, F.interpolate(x, size=[2, 2], mode="bilinear"))
    assert not torch.allclose(area, torch.nn.functional.avg_pool2d(x, 2))


# -- the top-level names (step 2.4) ------------------------------------------------
def test_top_level_names():
    for name in ("float16", "bfloat16", "float32", "float64", "int8",
                 "int16", "int32", "int64", "uint8", "bool", "complex64",
                 "complex128"):
        assert getattr(pt, name) == getattr(torch, name), name
        assert np.dtype(getattr(ref, name)).name == name, name
    assert pt.Tensor is torch.Tensor
    assert isinstance(torch.zeros(1), pt.Tensor)
    assert pt.is_compiled_with_cuda() is (torch.version.cuda is not None)
    assert pt.is_compiled_with_tpu() is False
    assert pt.in_dynamic_mode() is True and ref.in_dynamic_mode() is True
    assert pt.disable_static() is None
    with pytest.raises(NotImplementedError, match="A13"):
        pt.enable_static()
    assert pt.linalg is pt.tensor.linalg
    assert pt.text.__name__ == "paddle_tpu_torch.text"
    with pt.no_grad():
        assert not pt.is_grad_enabled()
        with pt.enable_grad():
            assert pt.is_grad_enabled()
    with pt.set_grad_enabled(False):
        assert not pt.is_grad_enabled()
    assert pt.is_grad_enabled() == ref.is_grad_enabled()
    assert pt.tolist(torch.tensor([1, 2])) == [1, 2]
    reader = pt.batch(lambda: iter(range(5)), 2)
    assert list(reader()) == [[0, 1], [2, 3], [4]]
    with pytest.raises(TypeError):
        pt.check_shape([2, "x"])
    assert pt.get_cuda_rng_state() == [] or torch.cuda.is_available()
    p = pt.create_parameter([3, 4], "float32", name="w",
                            default_initializer=pt.nn.initializer.Constant(2))
    assert isinstance(p, pt.Parameter) and p.name == "w"
    assert torch.equal(p, torch.full((3, 4), 2.0))
    before = torch._tensor_str.PRINT_OPTS.precision
    try:
        pt.set_printoptions(precision=3)
        assert torch._tensor_str.PRINT_OPTS.precision == 3
    finally:
        pt.set_printoptions(precision=before)


def test_default_dtype_reaches_creation_layers_and_draws(default_dtypes):
    for dt in ("bfloat16", "float16", "float32"):
        ref.set_default_dtype(dt)
        pt.set_default_dtype(dt)
        assert str(ref.get_default_dtype()) == str(
            pt.get_default_dtype()).replace("torch.", "")
        for fn in (lambda P: P.zeros([2]), lambda P: P.ones([2]),
                   lambda P: P.full([2], 1.5), lambda P: P.arange(0.0, 2.0),
                   lambda P: P.linspace(0, 1, 3), lambda P: P.eye(2),
                   lambda P: P.rand([2]), lambda P: P.randn([2]),
                   lambda P: P.uniform([2]), lambda P: P.normal(shape=[2]),
                   lambda P: P.to_tensor(np.zeros(2)),
                   lambda P: P.nn.Linear(2, 3).weight):
            assert np.dtype(fn(ref).dtype).name == dt, (dt, fn(ref).dtype)
            assert fn(pt).dtype == getattr(torch, dt), (dt, fn(pt).dtype)
        assert pt.full([2], 3).dtype == torch.int32
    with pytest.warns(UserWarning):
        pt.set_default_dtype("float64")
    assert pt.get_default_dtype() == torch.float32
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref.set_default_dtype("float64")
    assert str(ref.get_default_dtype()) == "float32"
    for P in (ref, pt):
        with pytest.raises(TypeError):
            P.set_default_dtype("int32")


# -- the remaining names of each namespace -----------------------------------------
# names the reference's modules bind that are not API (imports, helpers)
ARTEFACTS = {"annotations", "apply", "builtins", "jax", "jnp", "next_key",
             "np", "operator", "unwrap", "convert_dtype", "Tensor",
             "contextlib", "json", "os", "threading", "time"}
# what later slices port (ROADMAP A10, A13)
LATER = {
    "": {"NPUPlace", "TPUPlace", "SelectedRows",
         "autograd", "cost_model", "device", "distribution", "fft", "grad",
         "hub", "onnx", "signal", "slim", "sparsity", "static",
         "sysconfig", "utils"},
    ".nn": set(),
    ".nn.functional": set(),
    ".nn.initializer": set(),
    ".vision": set(),
    ".vision.models": set(),
    ".vision.ops": set(),
    ".text": set(),
    ".distributed.fleet": set(),
    ".distributed": set(),
    # ROADMAP A13: the sparsity package
    ".incubate": {"asp"},
    ".resilience": set(),
    ".profiler": set(),
    ".serving": set(),
    # ROADMAP A12: the quantized decode model
    ".serving.decode": {"load_decode_model"},
    # ROADMAP A13: ast_transform.py and convert_operators.py; A12: the
    # serialized program's functionalized_call
    ".jit": {"ProgramTranslator", "TracedLayer", "not_to_static",
             "set_code_level", "set_verbosity", "functionalized_call"},
}


@pytest.fixture(scope="module")
def fresh_names():
    """Both packages' names per namespace as a fresh import binds them.
    Other test files import submodules of the packages, which binds them
    on the package, so a dir() in this process would depend on which
    files ran before it on the same worker."""
    code = (
        "import importlib, json\n"
        "out = {}\n"
        f"for ns in {sorted(LATER)!r}:\n"
        "    out[ns] = [sorted(dir(importlib.import_module(pkg + ns)))\n"
        "               for pkg in ('paddle_tpu', 'paddle_tpu_torch')]\n"
        "print(json.dumps(out))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("ns", sorted(LATER), ids=lambda n: n or "top")
def test_missing_names_are_only_later_slices(ns, fresh_names):
    ref_names, port_names = fresh_names[ns]
    missing = {n for n in ref_names if not n.startswith("_")} \
        - set(port_names)
    assert missing - ARTEFACTS == LATER[ns], sorted(missing - ARTEFACTS
                                                    ^ LATER[ns])


# the names the resilience package binds from its ported submodules
RESILIENCE_NAMES = {
    "faults": ("FaultInjected", "fault_point", "maybe_inject",
               "should_inject"),
    "guard": ("StepGuard", "BadStepError"),
    "health": ("PreflightFailure", "preflight_kat", "serving_preflight",
               "QUARANTINE_EXIT_CODE", "Quarantined", "run_preflight",
               "StragglerDetector"),
    "integrity": ("IntegrityError", "ConsensusChecker", "StepReplayBuffer",
                  "checksum_state", "classify_replay"),
    "preempt": ("Preempted", "PreemptionCallback", "PreemptionHandler"),
    "recorder": ("FlightRecorder", "get_recorder"),
    "recovery": ("current_generation", "MembershipChange",
                 "RecoveryExhausted", "RecoveryJournal", "RecoveryManager",
                 "RendezvousTimeout"),
    "retry": ("retry_call",),
    "watchdog": ("PeerAbort", "StaleGeneration", "Watchdog",
                 "watch_section"),
}


@pytest.mark.parametrize("name", sorted(
    n for names in RESILIENCE_NAMES.values() for n in names))
def test_resilience_binds_its_submodules_names(name):
    import importlib

    import paddle_tpu.resilience as ref_res
    import paddle_tpu_torch.resilience as res
    module = next(m for m, names in RESILIENCE_NAMES.items()
                  if name in names)
    sub = importlib.import_module(f"paddle_tpu_torch.resilience.{module}")
    assert getattr(res, name) is getattr(sub, name)
    assert name in res.__all__
    assert hasattr(ref_res, name)


# the names the serving package binds from the modules that the socket
# frontend, live rollout and the autoscaler brought (given up by LATER)
SERVING_NAMES = {
    "client": ("InferenceClient", "RemoteInferenceError"),
    "server": ("SocketFrontend",),
    "rollout": ("GoldenMismatch", "ManifestWatcher", "RolloutConfig",
                "RolloutController", "RolloutError"),
    "autoscaler": ("Autoscaler", "AutoscalerConfig"),
}


@pytest.mark.parametrize("name", sorted(
    n for names in SERVING_NAMES.values() for n in names))
def test_serving_binds_its_submodules_names(name):
    import importlib

    import paddle_tpu.serving as ref_serving
    import paddle_tpu_torch.serving as serving
    module = next(m for m, names in SERVING_NAMES.items() if name in names)
    sub = importlib.import_module(f"paddle_tpu_torch.serving.{module}")
    assert getattr(serving, name) is getattr(sub, name)
    assert name in serving.__all__
    assert name in ref_serving.__all__
    assert getattr(ref_serving, name).__name__ == name


@pytest.mark.parametrize("module", sorted(SERVING_NAMES) + ["disagg"])
def test_serving_submodules_are_bound_like_the_references(module, fresh_names):
    """``serving.client``, ``.rollout``, ``.autoscaler`` and ``.server``
    are bound on a fresh import of either package; ``disagg`` on neither
    (it is imported by ``attach_disagg``)."""
    ref_names, port_names = fresh_names[".serving"]
    assert (module in port_names) == (module in ref_names)


# -- the nn.Layer API (step 2.1) ---------------------------------------------------
def _mlp(P):
    return P.nn.Sequential(P.nn.Linear(4, 8), P.nn.BatchNorm1D(8),
                           P.nn.ReLU(), P.nn.Linear(8, 2))


def _ref_state(m):
    return {k: np.asarray(v._val) for k, v in m.state_dict().items()}


def test_set_state_dict_round_trip_matches_reference():
    rm, pm = _mlp(ref), _mlp(pt)
    src = _ref_state(_mlp(ref))
    src.pop("1._mean")
    src["extra.weight"] = np.ones(3, "float32")
    src["0.weight"] = src["0.weight"].astype("float64")   # cast on load
    want = rm.set_state_dict(dict(src))
    got = pm.set_state_dict(dict(src))
    assert got == want == (["1._mean"], ["extra.weight"])
    assert pm.load_dict == pm.set_state_dict or \
        pm.load_dict.__func__ is type(pm).set_state_dict
    for name, t in pm.state_dict().items():
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), _ref_state(rm)[name],
                                      err_msg=name)
    rm.eval()
    pm.eval()
    x = np.random.RandomState(5).randn(3, 4).astype("float32")
    np.testing.assert_allclose(pm(torch.tensor(x)).detach().numpy(),
                               np.asarray(rm(ref.to_tensor(x))._val),
                               rtol=1e-6, atol=1e-6)
    # a Parameter keeps its object and address through a load
    w = pm[0].weight
    ptr = w.data_ptr()
    pm.load_dict({"0.weight": torch.zeros(4, 8)})
    assert pm[0].weight is w and w.data_ptr() == ptr
    assert float(w.detach().abs().max()) == 0.0
    for P, m in ((ref, rm), (pt, pm)):
        with pytest.raises(ValueError):
            m.set_state_dict({"0.weight": np.zeros((2, 2), "float32")})
    with pytest.raises(NotImplementedError):
        pm.set_state_dict({}, use_structured_name=False)


def test_layer_api_matches_reference():
    rm, pm = _mlp(ref), _mlp(pt)
    for P, m in ((ref, rm), (pt, pm)):
        assert m.full_name() == "sequential"
        assert m[0].full_name() == "linear"
        assert P.nn.Layer(name_scope="enc").full_name() == "enc"
    names = [[n for n, _ in m.named_sublayers(prefix="m", include_self=True)]
             for m in (rm, pm)]
    assert names[0] == names[1] == ["m", "m.0", "m.1", "m.2", "m.3"]
    assert len(rm.sublayers()) == len(pm.sublayers()) == 4
    assert [type(layer).__name__ for layer in pm.sublayers(True)] == \
        [type(layer).__name__ for layer in rm.sublayers(True)]
    for P, m in ((ref, rm), (pt, pm)):
        head = P.nn.Linear(2, 1)
        assert m.add_sublayer("head", head) is head
        prm = P.create_parameter([2], "float32")
        assert m.add_parameter("scale", prm) is prm
        assert {"head.weight", "scale"} <= set(m.state_dict())
        t = m.create_tensor(dtype="float32")
        assert tuple(t.shape) == () and np.dtype(
            _numpy(t).dtype).name == "float32"
    x = np.random.RandomState(6).randn(3, 4).astype("float32")
    outs = []
    for P, m, xt in ((ref, rm, ref.to_tensor(x)), (pt, pm, torch.tensor(x))):
        m.eval()
        base = _numpy(m(xt))
        handle = m.register_forward_post_hook(
            lambda layer, inp, out: out * 2.0)
        doubled = _numpy(m(xt))
        handle.remove()
        outs.append((base, doubled, _numpy(m(xt))))
        np.testing.assert_allclose(doubled, 2 * base, rtol=1e-6)
        np.testing.assert_array_equal(outs[-1][2], base)
    m = pm.astype("bfloat16")
    assert m is pm and all(p.dtype == torch.bfloat16
                           for p in pm.parameters())
    assert pm[1]._mean.dtype == torch.bfloat16 and pm._dtype == torch.bfloat16
    w = pm[0].weight
    pm.to(device="cpu", dtype="float32")
    assert pm[0].weight is w and w.dtype == torch.float32
    rm.astype("bfloat16")
    assert all(np.dtype(p.dtype).name == "bfloat16"
               for p in rm.parameters())
    loss = pm(torch.tensor(x)).sum()
    loss.backward()
    assert pm[0].weight.grad is not None
    pm.clear_gradients()
    assert all(p.grad is None for p in pm.parameters())


def test_layer_without_parameters_needs_no_device():
    """A layer resolves its device when it first creates something, so
    an activation or a container builds on a host without a card
    whatever the current device."""
    pt.set_device("gpu:0")
    try:
        layers = [pt.nn.GELU(), pt.nn.Softmax(), pt.nn.Sequential(),
                  pt.nn.LayerDict(), pt.nn.Flatten()]
    finally:
        pt.set_device("cpu")
    assert torch.equal(layers[0](torch.zeros(2)), torch.zeros(2))
