"""Modules of the PyTorch/CUDA port against the JAX reference on the host.

Each case feeds the same numpy inputs (made from a seed) through
paddle_tpu and through paddle_tpu_torch on the CPU and compares the
outputs as numpy. f32 cases are held to 1e-5 (the two frameworks sum in
different orders); bf16 cases to one bf16 ulp of values below 4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.ops.attention import \
    scaled_dot_product_attention as ref_sdpa
from paddle_tpu.ops.fused_ffn import fused_ffn as ref_fused_ffn
from paddle_tpu.ops.fused_residual_ln import \
    fused_residual_ln as ref_fused_residual_ln

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.core import device as pdevice
from paddle_tpu_torch.core import dtypes as pdtypes
from paddle_tpu_torch.core import random as prandom
from paddle_tpu_torch.framework import io_utils
from paddle_tpu_torch.nn import initializer as PI
from paddle_tpu_torch.ops.attention import scaled_dot_product_attention
from paddle_tpu_torch.ops.fused_ffn import fused_ffn
from paddle_tpu_torch.ops.fused_residual_ln import fused_residual_ln

# The shapes here are tiny: one intra-op thread is enough, and it keeps
# torch's spinning OpenMP pool from taking cores from the timing-sensitive
# tests that other workers run beside these.
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=2e-2)


def _np(t):
    return np.asarray(t._val if hasattr(t, "_val") else t).astype("float32")


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype("float32")


def _pair(arr, dtype="float32"):
    """The same array as a reference tensor and a port tensor."""
    ref = paddle.to_tensor(arr)
    port = torch.from_numpy(arr)
    if dtype == "bfloat16":
        ref = ref.astype("bfloat16")
        port = port.to(torch.bfloat16)
    return ref, port


@pytest.mark.parametrize("dtype,tol", [("float32", F32), ("bfloat16", BF16)])
@pytest.mark.parametrize("return_residual", [False, True])
def test_fused_residual_ln_forward(return_residual, dtype, tol):
    rng = np.random.RandomState(1)
    arrs = [_rand(rng, 2, 8, 32), _rand(rng, 2, 8, 32),
            1.0 + _rand(rng, 32, scale=0.1), _rand(rng, 32, scale=0.1)]
    pairs = [_pair(a, dtype) for a in arrs]
    ref = ref_fused_residual_ln(*[p[0] for p in pairs], epsilon=1e-5,
                                return_residual=return_residual)
    got = fused_residual_ln(*[p[1] for p in pairs], epsilon=1e-5,
                            return_residual=return_residual)
    if return_residual:
        assert got[0].dtype == got[1].dtype == pairs[0][1].dtype
        for r, g in zip(ref, got):
            np.testing.assert_allclose(_np(g.float()), _np(r), **tol)
    else:
        np.testing.assert_allclose(_np(got.float()), _np(ref), **tol)


@pytest.mark.parametrize("activation", ["gelu_tanh", "gelu", "relu"])
def test_fused_ffn_forward(activation):
    rng = np.random.RandomState(2)
    arrs = [_rand(rng, 2, 8, 32), _rand(rng, 32, 128, scale=0.1),
            _rand(rng, 128, scale=0.1), _rand(rng, 128, 32, scale=0.1),
            _rand(rng, 32, scale=0.1)]
    pairs = [_pair(a) for a in arrs]
    ref = ref_fused_ffn(*[p[0] for p in pairs], activation=activation)
    got = fused_ffn(*[p[1] for p in pairs], activation=activation)
    np.testing.assert_allclose(_np(got), _np(ref), **F32)
    with pytest.raises(ValueError):
        fused_ffn(*[p[1] for p in pairs], activation="swish")


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu(approximate):
    x = _rand(np.random.RandomState(3), 4, 64, scale=3.0)
    ref = RF.gelu(paddle.to_tensor(x), approximate=approximate)
    got = PF.gelu(torch.from_numpy(x), approximate=approximate)
    np.testing.assert_allclose(_np(got), _np(ref), **F32)


def test_linear_keeps_in_out_layout():
    rng = np.random.RandomState(4)
    x, w, b = _rand(rng, 3, 5, 16), _rand(rng, 16, 24), _rand(rng, 24)
    ref = RF.linear(paddle.to_tensor(x), paddle.to_tensor(w),
                    paddle.to_tensor(b))
    got = PF.linear(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(_np(got), _np(ref), **F32)
    layer = pnn.Linear(16, 24, device="cpu")
    assert tuple(layer.weight.shape) == (16, 24)
    assert tuple(layer.bias.shape) == (24,)
    assert torch.count_nonzero(layer.bias) == 0


@pytest.mark.parametrize("id_dtype", ["int64", "int32"])
def test_embedding(id_dtype):
    rng = np.random.RandomState(5)
    w = _rand(rng, 10, 8)
    ids = np.array([[0, 3, 9, 3], [1, 2, 9, 0]], dtype=id_dtype)
    ref = RF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w))
    got = PF.embedding(torch.from_numpy(ids), torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=0)


def test_layer_norm_layer_with_carried_weights():
    rng = np.random.RandomState(6)
    x = _rand(rng, 2, 7, 32)
    ref_layer = paddle.nn.LayerNorm(32)
    port_layer = pnn.LayerNorm(32, device="cpu")
    arrays = {"weight": 1.0 + _rand(rng, 32, scale=0.1),
              "bias": _rand(rng, 32, scale=0.1)}
    ref_layer.set_state_dict({k: paddle.to_tensor(v)
                              for k, v in arrays.items()})
    io_utils.load_numpy_state_dict(port_layer, arrays)
    ref = ref_layer(paddle.to_tensor(x))
    got = port_layer(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got.detach()), _np(ref), **F32)
    assert port_layer._epsilon == 1e-5


def test_layer_state_dict_names_match_reference():
    ref = paddle.nn.Linear(4, 6)
    port = pnn.Linear(4, 6, device="cpu")
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in port.state_dict().items()}


def test_load_numpy_state_dict_rejects_mismatches():
    layer = pnn.Linear(4, 6, device="cpu")
    good = {"weight": np.ones((4, 6), "float32"),
            "bias": np.zeros(6, "float32")}
    io_utils.load_numpy_state_dict(layer, good)
    assert torch.equal(layer.weight.detach(), torch.ones(4, 6))
    with pytest.raises(KeyError, match="missing"):
        io_utils.load_numpy_state_dict(layer, {"weight": good["weight"]})
    with pytest.raises(KeyError, match="unexpected"):
        io_utils.load_numpy_state_dict(layer, {**good, "extra": good["bias"]})
    with pytest.raises(ValueError, match="shape"):
        io_utils.load_numpy_state_dict(
            layer, {**good, "weight": np.ones((6, 4), "float32")})
    # values are cast to the parameter's dtype
    layer16 = pnn.Linear(4, 6, device="cpu", dtype="bfloat16")
    io_utils.load_numpy_state_dict(layer16, good)
    assert layer16.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("s_q,s_k", [(6, 6), (1, 9), (3, 9)])
def test_math_attention_causal_offset(s_q, s_k):
    """The math path, including the cached-decode geometry (s_q < s_k,
    query rows at the end of the key timeline)."""
    rng = np.random.RandomState(7)
    q, k, v = _rand(rng, 2, s_q, 2, 16), _rand(rng, 2, s_k, 2, 16), \
        _rand(rng, 2, s_k, 2, 16)
    ref = ref_sdpa(paddle.to_tensor(q), paddle.to_tensor(k),
                   paddle.to_tensor(v), is_causal=True, use_pallas=False)
    got = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=True)
    np.testing.assert_allclose(_np(got), _np(ref), **F32)


@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_math_attention_masks(kind):
    rng = np.random.RandomState(8)
    q, k, v = (_rand(rng, 1, 5, 2, 8) for _ in range(3))
    if kind == "bool":
        mask = rng.rand(1, 1, 5, 5) > 0.3
        mask[..., 0] = True
    else:
        mask = _rand(rng, 1, 1, 5, 5)
    ref = ref_sdpa(paddle.to_tensor(q), paddle.to_tensor(k),
                   paddle.to_tensor(v), attn_mask=paddle.to_tensor(mask),
                   training=False)
    got = scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask), training=False)
    np.testing.assert_allclose(_np(got), _np(ref), **F32)


def test_dropout_identity_in_eval_and_at_zero():
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    assert PF.dropout(x, p=0.5, training=False) is x
    assert PF.dropout(x, p=0.0, training=True) is x
    assert torch.count_nonzero(PF.dropout(x, p=1.0, training=True)) == 0
    g1, g2 = prandom.make_generator(7), prandom.make_generator(7)
    a = PF.dropout(x, p=0.5, training=True, generator=g1)
    b = PF.dropout(x, p=0.5, training=True, generator=g2)
    assert torch.equal(a, b)
    kept = a != 0
    np.testing.assert_allclose(a[kept].numpy(), (x[kept] * 2).numpy())


def test_initializers_draw_from_the_generator():
    g = prandom.make_generator(3)
    a = PI.Normal(0.0, 0.02)((256, 256), torch.float32, "cpu", g)
    b = PI.Normal(0.0, 0.02)((256, 256), torch.float32, "cpu",
                             prandom.make_generator(3))
    c = PI.Normal(0.0, 0.02)((256, 256), torch.float32, "cpu", g)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(float(a.std()) - 0.02) < 1e-3
    x = PI.XavierNormal()((300, 500), torch.bfloat16, "cpu", g)
    assert x.dtype == torch.bfloat16
    assert abs(float(x.float().std()) - np.sqrt(2.0 / 800)) < 2e-3
    assert torch.equal(PI.Constant(1.0)((3,), torch.float32, "cpu"),
                       torch.ones(3))


def test_dtypes_narrow_64_bit():
    assert pdtypes.convert_dtype("int64") == torch.int32
    assert pdtypes.convert_dtype("float64") == torch.float32
    assert pdtypes.convert_dtype(np.float64) == torch.float32
    assert pdtypes.convert_dtype("bf16") == torch.bfloat16
    assert pdtypes.convert_dtype(torch.bfloat16) == torch.bfloat16
    assert pdtypes.convert_dtype(None) is None
    arr = pdtypes.narrow_host_array(np.array([1, -2], dtype=np.int64))
    assert arr.dtype == np.int32
    with pytest.raises(OverflowError):
        pdtypes.narrow_host_array(np.array([2**40], dtype=np.int64))
    with pytest.raises(TypeError):
        pdtypes.convert_dtype("float8")


def test_places_and_default_device(monkeypatch):
    assert pdevice.resolve_device("cpu") == torch.device("cpu")
    assert pdevice.CPUPlace().torch_device == torch.device("cpu")
    assert pdevice.CUDAPlace(1).torch_device == torch.device("cuda", 1)
    assert pdevice.CUDAPlace(1) == pt.CUDAPlace(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the default device is the card; without one, entry points refuse
    with pytest.raises(RuntimeError, match="cuda:0 requested"):
        pdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda:1 requested"):
        pdevice.resolve_device("gpu:1")
    with pytest.raises(RuntimeError):
        pnn.Linear(2, 2)
