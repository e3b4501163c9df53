"""The port's transformer layers against the JAX reference on the host.

Each reference layer is built by paddle_tpu, its weights are carried into
the port's layer by name (load_numpy_state_dict), and the same numpy
inputs (made from a seeded RandomState) run through both in f32. The
output, the input's grad and every parameter's grad of a fixed random
projection of the output are held to 1e-5 (the two frameworks sum in
different orders). Dropout is 0: JAX's and torch's random streams never
match.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.ops.fused_residual_ln import \
    post_residual_ln as ref_post_residual_ln

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.ops.fused_residual_ln import post_residual_ln

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
D, HEADS, FF, B, S = 32, 4, 64, 2, 8


def _np(t):
    return np.asarray(t._val if hasattr(t, "_val") else t.detach())


def _carry(ref, port):
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    return pt.load_numpy_state_dict(port, arrays)


def _inputs(rng, *shapes):
    return [rng.randn(*s).astype("float32") for s in shapes]


def _run_both(ref, port, arrays, fwd, others=()):
    """``fwd(layer, *tensors, *others)`` on both packages, where
    ``arrays`` become differentiable tensors and ``others`` pairs of
    (reference, port) values; then the backward of sum(out * w) for a
    fixed random w. Returns the outputs, the inputs' grads and the
    parameters' grads of each, as numpy."""
    results = []
    for side, layer in enumerate((ref, port)):
        if side == 0:
            ins = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
        else:
            ins = [torch.tensor(a, requires_grad=True) for a in arrays]
        out = fwd(layer, *ins, *[o[side] for o in others])
        main = out[0] if isinstance(out, tuple) else out
        w = np.random.RandomState(99).randn(*main.shape).astype("float32")
        wt = paddle.to_tensor(w) if side == 0 else torch.tensor(w)
        (main * wt).sum().backward()
        grads = {n: _np(p.grad) for n, p in layer.named_parameters()}
        results.append((out, [_np(t.grad) for t in ins], grads))
    return results


def _assert_same(results, **tol):
    (r_out, r_in, r_par), (p_out, p_in, p_par) = results
    r_out = r_out if isinstance(r_out, tuple) else (r_out,)
    p_out = p_out if isinstance(p_out, tuple) else (p_out,)
    np.testing.assert_allclose(_np(p_out[0]), _np(r_out[0]), **(tol or TOL))
    for r, p in zip(r_in, p_in):
        np.testing.assert_allclose(p, r, **(tol or TOL))
    assert sorted(r_par) == sorted(p_par)
    for name, g in r_par.items():
        np.testing.assert_allclose(p_par[name], g, err_msg=name,
                                   **(tol or TOL))


def _masks(kind, rng, b, s_q, s_k):
    """(reference mask, port mask) of ``kind``: None, a bool mask with the
    diagonal kept, or an additive f32 mask (-1e30 where masked, small
    values elsewhere)."""
    if kind is None:
        return None, None
    keep = rng.rand(b, 1, s_q, s_k) > 0.4
    keep |= np.eye(s_q, s_k, dtype=bool)[None, None]
    if kind == "bool":
        return paddle.to_tensor(keep), torch.tensor(keep)
    add = np.where(keep, rng.randn(b, 1, s_q, s_k) * 0.1,
                   -1e30).astype("float32")
    return paddle.to_tensor(add), torch.tensor(add)


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention_matches_reference(mask, cross):
    paddle.seed(0)
    ref = paddle.nn.MultiHeadAttention(D, HEADS)
    port = _carry(ref, pnn.MultiHeadAttention(D, HEADS, device="cpu"))
    rng = np.random.RandomState(1)
    s_k = 6 if cross else S
    q, kv = _inputs(rng, (B, S, D), (B, s_k, D))
    m = _masks(mask, rng, B, S, s_k)
    results = _run_both(ref, port, [q, kv],
                        lambda layer, x, y, mm: layer(x, y, y, mm),
                        others=[m])
    _assert_same(results)


def test_multi_head_attention_caches_match_reference():
    """Incremental decode through a Cache (one token a step, keys and
    values grown by concatenation) and cross attention from a
    StaticCache."""
    paddle.seed(0)
    ref = paddle.nn.MultiHeadAttention(D, HEADS)
    port = _carry(ref, pnn.MultiHeadAttention(D, HEADS, device="cpu"))
    rng = np.random.RandomState(2)
    x, mem = _inputs(rng, (B, 4, D), (B, 6, D))
    r_cache = ref.gen_cache(paddle.to_tensor(x))
    p_cache = port.gen_cache(torch.tensor(x))
    assert tuple(p_cache.k.shape) == (B, 0, HEADS, D // HEADS)
    with torch.no_grad():
        for t in range(x.shape[1]):
            tok = x[:, t:t + 1]
            r_out, r_cache = ref(paddle.to_tensor(tok), cache=r_cache)
            p_out, p_cache = port(torch.tensor(tok), cache=p_cache)
            np.testing.assert_allclose(_np(p_out), _np(r_out), **TOL)
            assert isinstance(p_cache, pnn.MultiHeadAttention.Cache)
        np.testing.assert_allclose(_np(p_cache.k), _np(r_cache.k), **TOL)
        np.testing.assert_allclose(_np(p_cache.v), _np(r_cache.v), **TOL)
        st = pnn.MultiHeadAttention.StaticCache
        r_static = ref.gen_cache(paddle.to_tensor(mem), paddle.to_tensor(mem),
                                 paddle.nn.MultiHeadAttention.StaticCache)
        p_static = port.gen_cache(torch.tensor(mem), torch.tensor(mem), st)
        assert isinstance(p_static, st)
        r_out = ref(paddle.to_tensor(x), paddle.to_tensor(mem),
                    paddle.to_tensor(mem), None, r_static)
        p_out = port(torch.tensor(x), torch.tensor(mem), torch.tensor(mem),
                     None, p_static)
        np.testing.assert_allclose(_np(p_out), _np(r_out), **TOL)


@pytest.mark.parametrize("activation", ["relu", "gelu"])
@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_reference(normalize_before, activation):
    paddle.seed(0)
    kw = dict(dropout=0.0, activation=activation,
              normalize_before=normalize_before)
    ref = paddle.nn.TransformerEncoderLayer(D, HEADS, FF, **kw)
    port = _carry(ref, pnn.TransformerEncoderLayer(D, HEADS, FF, **kw,
                                                   device="cpu"))
    x, = _inputs(np.random.RandomState(3), (B, S, D))
    _assert_same(_run_both(ref, port, [x], lambda layer, t: layer(t)))


@pytest.mark.parametrize("mask", [None, "additive"])
def test_encoder_matches_reference(mask):
    paddle.seed(0)
    ref = paddle.nn.TransformerEncoder(
        paddle.nn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.0), 2)
    port = _carry(ref, pnn.TransformerEncoder(
        pnn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.0,
                                    device="cpu"), 2))
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    rng = np.random.RandomState(4)
    x, = _inputs(rng, (B, S, D))
    m = _masks(mask, rng, B, S, S)
    _assert_same(_run_both(ref, port, [x], lambda layer, t, mm: layer(t, mm),
                           others=[m]))


def _decoder_pair(num_layers=None):
    paddle.seed(0)
    kw = dict(dropout=0.0)
    r_layer = paddle.nn.TransformerDecoderLayer(D, HEADS, FF, **kw)
    p_layer = pnn.TransformerDecoderLayer(D, HEADS, FF, **kw, device="cpu")
    if num_layers is None:
        return r_layer, _carry(r_layer, p_layer)
    ref = paddle.nn.TransformerDecoder(r_layer, num_layers)
    return ref, _carry(ref, pnn.TransformerDecoder(p_layer, num_layers))


def _causal(s):
    m = np.where(np.tril(np.ones((s, s), bool)), 0.0, -1e30)
    m = m.astype("float32")
    return paddle.to_tensor(m), torch.tensor(m)


@pytest.mark.parametrize("num_layers", [None, 2])
def test_decoder_matches_reference(num_layers):
    """A decoder layer (None) or a 2-layer decoder: the causal forward
    with every grad, then incremental decode through gen_cache."""
    ref, port = _decoder_pair(num_layers)
    rng = np.random.RandomState(5)
    tgt, mem = _inputs(rng, (B, 5, D), (B, 7, D))
    results = _run_both(ref, port, [tgt, mem],
                        lambda layer, t, m, c: layer(t, m, c),
                        others=[_causal(5)])
    _assert_same(results)
    full = _np(results[1][0])
    with torch.no_grad():
        r_cache = ref.gen_cache(paddle.to_tensor(mem))
        p_cache = port.gen_cache(torch.tensor(mem))
        for t in range(tgt.shape[1]):
            tok = tgt[:, t:t + 1]
            r_out, r_cache = ref(paddle.to_tensor(tok), paddle.to_tensor(mem),
                                 None, None, r_cache)
            p_out, p_cache = port(torch.tensor(tok), torch.tensor(mem), None,
                                  None, p_cache)
            np.testing.assert_allclose(_np(p_out), _np(r_out), **TOL)
            # a cached step equals the causal forward's row
            np.testing.assert_allclose(_np(p_out)[:, 0], full[:, t],
                                       rtol=1e-4, atol=1e-4)


def test_decoder_gen_cache_zip():
    ref, port = _decoder_pair(2)
    mem = torch.zeros(B, 7, D)
    zipped = port.gen_cache(mem, do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2
    assert all(isinstance(c, pnn.MultiHeadAttention.Cache)
               for c in zipped[0])
    assert all(isinstance(c, pnn.MultiHeadAttention.StaticCache)
               for c in zipped[1])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_transformer_matches_reference(normalize_before):
    paddle.seed(0)
    kw = dict(d_model=D, nhead=HEADS, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=FF, dropout=0.0,
              normalize_before=normalize_before)
    ref = paddle.nn.Transformer(**kw)
    port = _carry(ref, pnn.Transformer(**kw, device="cpu"))
    r_mask = ref.generate_square_subsequent_mask(5)
    p_mask = port.generate_square_subsequent_mask(5)
    assert p_mask.dtype == torch.float32
    np.testing.assert_array_equal(_np(p_mask), _np(r_mask))
    rng = np.random.RandomState(6)
    src, tgt = _inputs(rng, (B, 7, D), (B, 5, D))
    _assert_same(_run_both(ref, port, [src, tgt],
                           lambda layer, s, t, m: layer(s, t, None, m),
                           others=[(r_mask, p_mask)]))


@pytest.mark.parametrize("fused", ["1", "0"])
def test_post_residual_ln_matches_reference(fused, monkeypatch):
    """norm(residual + sub) through the fused op (and, with the fusion
    off, the plain composition): output and every grad."""
    monkeypatch.setenv("PADDLE_TPU_FUSED_RESIDUAL_LN", fused)
    paddle.seed(0)
    ref = paddle.nn.LayerNorm(D)
    port = pnn.LayerNorm(D, device="cpu")
    rng = np.random.RandomState(7)
    w, b = _inputs(rng, (D,), (D,))
    ref.weight.set_value(paddle.to_tensor(1.0 + 0.1 * w))
    ref.bias.set_value(paddle.to_tensor(0.1 * b))
    _carry(ref, port)
    x, y = _inputs(rng, (B, S, D), (B, S, D))
    results = _run_both(ref, port, [x, y], lambda norm, r, s:
                        (ref_post_residual_ln if norm is ref
                         else post_residual_ln)(r, s, norm))
    _assert_same(results)


def test_encoder_copies_share_the_generator():
    """The encoder deep-copies its layer with the generator shared: the
    copies draw fresh, different weights and, in training, different
    dropout masks (a copied generator would repeat both)."""
    gen = pt.make_generator(3)
    layer = pnn.TransformerEncoderLayer(D, HEADS, FF, dropout=0.5,
                                        device="cpu", generator=gen)
    enc = pnn.TransformerEncoder(layer, 3)
    # the LayerList holding the copies is a Layer too (as the
    # reference's is) and draws nothing: it keeps no generator
    gens = {m._generator for m in enc.modules()
            if isinstance(m, pnn.Layer) and not isinstance(m, pnn.LayerList)}
    assert gens == {gen}
    w1, w2 = (enc.layers[i].linear1.weight for i in (1, 2))
    assert not torch.equal(w1, w2)
    assert not torch.equal(enc.layers[0].linear1.weight, w1)
    assert all(not enc.layers[i].linear1.bias.detach().any() for i in (1, 2))
    x = torch.ones(B, S, D)
    masks = [enc.layers[i].dropout1(x) for i in (1, 2)]
    assert not torch.equal(masks[0], masks[1])


def test_transformer_exports_and_sublayers_order():
    for name in ("MultiHeadAttention", "TransformerEncoderLayer",
                 "TransformerEncoder", "TransformerDecoderLayer",
                 "TransformerDecoder", "Transformer"):
        assert getattr(pt.nn, name) is getattr(pnn, name)
    for name in ("relu", "tanh", "gelu"):
        assert callable(getattr(pt.nn.functional, name))
    paddle.seed(0)
    ref = paddle.nn.TransformerEncoderLayer(D, HEADS, FF)
    port = pnn.TransformerEncoderLayer(D, HEADS, FF, device="cpu")
    r_names = [type(m).__name__ for m in ref.sublayers(include_self=True)]
    p_names = [type(m).__name__ for m in port.sublayers(include_self=True)]
    assert p_names == r_names
    assert port.sublayers()[0] is port.self_attn
