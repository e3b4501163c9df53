"""The tensor API of the PyTorch/CUDA port (paddle_tpu_torch.tensor)
against the JAX reference's (paddle_tpu.tensor) on the host.

Every case of tests/test_torch_tensor_cases.py runs through both packages
on the same numpy inputs; the outputs (after the case's ``post``) must
have the same dtypes and agree: floats within rtol 1e-5 / atol 1e-6
(1e-4 / 1e-5 for the decompositions and solves), integers and bools
exactly. The cases cover tests/test_tensor_ops.py:11-216 and :273-307
and every function the reference's tensor/__init__.py exports; the
gradients of test_tensor_ops.py's TestGrad are held against the
reference's autograd.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.core.tensor import Tensor as RefTensor
from test_torch_tensor_cases import CASES

torch.set_num_threads(1)

DEFAULT_TOL = {"rtol": 1e-5, "atol": 1e-6}


@pytest.fixture(autouse=True)
def _on_host():
    before = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(before)


def _numpy(out):
    """Outputs as numpy: tensors of either package, sequences, scalars."""
    if isinstance(out, (list, tuple)):
        return [_numpy(o) for o in out]
    if isinstance(out, torch.Tensor):
        t = out.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(out, RefTensor):
        return np.asarray(out)
    return np.asarray(out)


def run_case(P, c):
    out = c.fn(P, *[P.to_tensor(a) for a in c.arrays])
    out = _numpy(out)
    return c.post(c.arrays, out) if c.post is not None else out


def assert_same(got, want, tol, where=""):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, tol, f"{where}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    if want.dtype.name == "bfloat16":
        want = want.astype(np.float32)
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    if got.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, err_msg=where, **tol)
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)


@pytest.mark.parametrize("c", CASES, ids=[c.id for c in CASES])
def test_tensor_case_matches_reference(c):
    ref.seed(0)
    pt.seed(0)
    if c.oracle is not None:
        # the reference cannot run this case (ROADMAP C-ref-13): numpy's
        # result stands in, and the reference must still fail as recorded
        with pytest.raises(TypeError, match="kind"):
            run_case(ref, c)
        want = c.oracle(*c.arrays)
    else:
        want = run_case(ref, c)
    got = run_case(pt, c)
    assert_same(got, want, {**DEFAULT_TOL, **c.tol}, c.id)


def _exported():
    """The public functions paddle_tpu/tensor/__init__.py star-imports from
    its ten modules (``stat`` by name), with ``to_tensor``."""
    names = set()
    for m in ("attribute", "creation", "math", "logic", "manipulation",
              "linalg", "search", "random", "einsum"):
        mod = importlib.import_module(f"paddle_tpu.tensor.{m}")
        if hasattr(mod, "__all__"):
            names |= set(mod.__all__)
            continue
        names |= {n for n in dir(mod) if not n.startswith("_")
                  and callable(getattr(mod, n))
                  and getattr(getattr(mod, n), "__module__", None)
                  == mod.__name__}
    return names | {"var", "std", "median", "quantile", "numel"}


def test_every_exported_function_is_ported_and_has_a_case():
    names = _exported()
    assert len(names) > 250, len(names)
    missing = sorted(n for n in names if not callable(getattr(pt, n, None)))
    assert not missing, missing
    uncovered = sorted(names - {c.function for c in CASES})
    assert not uncovered, uncovered


# -- gradients (tests/test_tensor_ops.py TestGrad) ------------------------------

GRAD_CASES = {
    "elementwise": (lambda P, x, y: x * y + x, (3, 3), (3, 3)),
    "exp": (lambda P, x: P.exp(x), (3, 3)),
    "tanh": (lambda P, x: P.tanh(x), (3, 3)),
    "matmul": (lambda P, x, y: P.matmul(x, y), (3, 4), (4, 2)),
    "broadcast": (lambda P, x, y: x * y, (3, 4), (4,)),
    "reduce": (lambda P, x: P.mean(x, axis=1), (3, 4)),
    "getitem": (lambda P, x: P.sum(x[1:3]), (4, 4)),
}


@pytest.mark.parametrize("key", sorted(GRAD_CASES))
def test_tensor_grads_match_reference(key):
    fn, *shapes = GRAD_CASES[key]
    rng = np.random.RandomState(3)
    arrays = [(rng.rand(*s) + 0.2).astype("float32") for s in shapes]
    rx = [ref.to_tensor(a, stop_gradient=False) for a in arrays]
    ref.sum(fn(ref, *rx)).backward()
    px = [pt.to_tensor(a, stop_gradient=False) for a in arrays]
    pt.sum(fn(pt, *px)).backward()
    for r, p in zip(rx, px):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r.grad.numpy()),
                                   rtol=1e-6, atol=1e-6)


# -- the 64-bit policy (tests/test_tensor_ops.py TestIndexDtypePolicy) ----------

def test_int64_ingestion_narrows_silently():
    import warnings
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = [pt.to_tensor(np.array([1, 2, 3], dtype="int64")),
               pt.zeros([2], dtype="int64"), pt.arange(4, dtype="int64"),
               pt.cast(pt.to_tensor(np.array([1.0])), "int64")]
    assert all(t.dtype == torch.int32 for t in got)
    assert not [str(x.message) for x in w if "int64" in str(x.message)]


def test_int64_out_of_range_raises():
    with pytest.raises(OverflowError):
        pt.to_tensor(np.array([2 ** 40], dtype="int64"))
    with pytest.raises(OverflowError):
        ref.to_tensor(np.array([2 ** 40], dtype="int64"))


def test_int32_embedding_lookup_works():
    emb = pt.nn.Embedding(10, 4, device="cpu")
    idx = pt.to_tensor(np.array([[0, 9], [3, 3]], dtype="int64"))
    assert list(emb(idx).shape) == [2, 2, 4]


def test_float64_request_becomes_float32():
    t = pt.to_tensor(np.array([1.0], dtype="float64"), dtype="float64")
    assert t.dtype == torch.float32


def test_creation_follows_set_device_and_random_is_seeded():
    pt.set_device("cpu")
    assert pt.get_device() == "cpu" and pt.zeros([2]).device.type == "cpu"
    pt.seed(7)
    a = pt.rand([4])
    pt.seed(7)
    assert torch.equal(pt.rand([4]), a)
    # the tensor API draws from its own generator, not torch's global one
    pt.seed(7)
    torch.rand(3)
    assert torch.equal(pt.rand([4]), a)
