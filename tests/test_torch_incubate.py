"""paddle.incubate of the PyTorch/CUDA port on the host, against the JAX
reference (paddle_tpu/incubate/{nn,optimizer,__init__}.py).

Layers take the reference's weights by name; the same numpy inputs (made
from a seed) and the same output cotangent go through both packages; the
outputs and every gradient (parameters and input) are held in f32 to a
relative L2 of 1e-5. Dropout is off (JAX's and torch's draws never
match), except where the test checks that inference under
``downscale_in_infer`` scales. The optimizers wrap SGD for 6 steps on a
quadratic; the segment reductions include an empty segment.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

RTOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ref_arrays(layer):
    return {k: np.asarray(v._val) for k, v in layer.state_dict().items()}


def _run_ref(layer, xs, g):
    """Forward on ``xs`` (numpy), backward of sum(out * g): the output,
    the parameters' and the inputs' gradients."""
    import paddle_tpu as paddle
    ts = []
    for x in xs:
        t = paddle.to_tensor(x)
        t.stop_gradient = False
        ts.append(t)
    out = layer(*ts)
    (out * paddle.to_tensor(g)).sum().backward()
    return (np.asarray(out._val),
            {n: np.asarray(p.grad._val) for n, p in layer.named_parameters()
             if p.grad is not None},
            [np.asarray(t.grad._val) for t in ts])


def _run_port(layer, xs, g):
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    out = layer(*ts)
    (out * torch.tensor(g)).sum().backward()
    return (out.detach().numpy(),
            {n: p.grad.numpy() for n, p in layer.named_parameters()
             if p.grad is not None},
            [t.grad.numpy() for t in ts])


def _hold(ref, got):
    assert _rel(got[0], ref[0]) <= RTOL
    assert set(got[1]) == set(ref[1])
    for name in ref[1]:
        assert _rel(got[1][name], ref[1][name]) <= RTOL, name
    for a, b in zip(got[2], ref[2]):
        assert _rel(a, b) <= RTOL


def _pair(make_ref, make_port, seed=0):
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    paddle.seed(seed)
    ref = make_ref(paddle)
    port = make_port(pt)
    pt.load_numpy_state_dict(port, _ref_arrays(ref))
    return ref, port


LAYERS = {
    "mha_post_ln": (lambda P, **f: P.incubate.nn.FusedMultiHeadAttention(
        32, 4, **f), 1),
    "mha_pre_ln": (lambda P, **f: P.incubate.nn.FusedMultiHeadAttention(
        32, 4, normalize_before=True, **f), 1),
    "ffn_relu_post": (lambda P, **f: P.incubate.nn.FusedFeedForward(
        32, 64, dropout_rate=0.0, **f), 1),
    "ffn_gelu_pre": (lambda P, **f: P.incubate.nn.FusedFeedForward(
        32, 64, dropout_rate=0.0, activation="gelu", normalize_before=True,
        **f), 1),
    "encoder_layer": (lambda P, **f:
                      P.incubate.nn.FusedTransformerEncoderLayer(
                          32, 4, 64, dropout_rate=0.0, activation="gelu",
                          **f), 1),
    "bias_dropout_residual_ln": (
        lambda P, **f: P.incubate.nn.FusedBiasDropoutResidualLayerNorm(
            32, dropout_rate=0.0, **f), 2),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_fused_layers_match_the_reference(name):
    make, n_in = LAYERS[name]
    ref, port = _pair(lambda P: make(P), lambda P: make(P, device="cpu"))
    assert set(_ref_arrays(ref)) == set(port.state_dict())
    rng = np.random.RandomState(1)
    xs = [rng.randn(2, 16, 32).astype("float32") for _ in range(n_in)]
    g = rng.randn(2, 16, 32).astype("float32")
    _hold(_run_ref(ref, xs, g), _run_port(port, xs, g))


@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu", "gelu_tanh"])
def test_fused_feedforward_function_matches_the_reference(activation,
                                                          pre_ln):
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import fused_feedforward as ref_ffn
    from paddle_tpu_torch.incubate.nn import fused_feedforward
    rng = np.random.RandomState(2)
    args = [rng.randn(3, 5, 8).astype("f"), rng.randn(8, 16).astype("f"),
            rng.randn(16, 8).astype("f"), rng.randn(16).astype("f"),
            rng.randn(8).astype("f"), 1 + 0.1 * rng.randn(8).astype("f"),
            0.1 * rng.randn(8).astype("f")]
    kw = dict(dropout1_rate=0.0, dropout2_rate=0.0, activation=activation,
              pre_layer_norm=pre_ln)

    def call(fn, ts):
        x, w1, w2, b1, b2, s, b = ts
        return fn(x, w1, w2, b1, b2, ln1_scale=s, ln1_bias=b, ln2_scale=s,
                  ln2_bias=b, **kw)
    refs = [paddle.to_tensor(a) for a in args]
    for t in refs:
        t.stop_gradient = False
    out = call(ref_ffn, refs)
    out.sum().backward()
    ports = [torch.tensor(a, requires_grad=True) for a in args]
    got = call(fused_feedforward, ports)
    got.sum().backward()
    assert _rel(got.detach().numpy(), np.asarray(out._val)) <= RTOL
    for a, b in zip(ports, refs):
        assert _rel(a.grad.numpy(), np.asarray(b.grad._val)) <= RTOL


def test_fused_feedforward_bf16_weights_under_amp_promote_as_jnp_does():
    """Under amp O1 an f32 input (a LayerNorm's output) meets bf16
    weights in fused_ffn, which neither amp list casts: the reference's
    jnp.dot promotes to f32, where torch.matmul would refuse the mix."""
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    from paddle_tpu.incubate.nn import fused_feedforward as ref_ffn
    from paddle_tpu_torch.incubate.nn import fused_feedforward
    rng = np.random.RandomState(8)
    x = rng.randn(3, 5, 8).astype("f")
    ws = [rng.randn(8, 16), rng.randn(16, 8), rng.randn(16), rng.randn(8)]
    with paddle.amp.auto_cast(dtype="bfloat16"):
        want = ref_ffn(paddle.to_tensor(x), *[paddle.to_tensor(
            w.astype("f")).astype("bfloat16") for w in ws],
            dropout1_rate=0.0, dropout2_rate=0.0, pre_layer_norm=True)
    wt = [torch.tensor(w.astype("f")).bfloat16().requires_grad_()
          for w in ws]
    xt = torch.tensor(x, requires_grad=True)
    with pt.amp.auto_cast(dtype="bfloat16"):
        got = fused_feedforward(xt, *wt, dropout1_rate=0.0,
                                dropout2_rate=0.0, pre_layer_norm=True)
    assert got.dtype == torch.float32
    assert str(np.asarray(want._val).dtype) == "float32"
    assert _rel(got.detach().numpy(), np.asarray(want._val)) <= RTOL
    got.sum().backward()
    assert all(w.grad.dtype == torch.bfloat16 for w in wt)


def test_fused_feedforward_downscale_in_infer_scales_at_inference():
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import fused_feedforward as ref_ffn
    from paddle_tpu_torch.incubate.nn import fused_feedforward
    rng = np.random.RandomState(4)
    args = [rng.randn(3, 8).astype("f"), rng.randn(8, 16).astype("f"),
            rng.randn(16, 8).astype("f")]
    kw = dict(dropout1_rate=0.5, dropout2_rate=0.25, training=False,
              mode="downscale_in_infer")
    want = ref_ffn(*[paddle.to_tensor(a) for a in args], **kw)
    got = fused_feedforward(*[torch.tensor(a) for a in args], **kw)
    assert _rel(got.numpy(), np.asarray(want._val)) <= RTOL


def test_bias_dropout_residual_layer_norm_function():
    import paddle_tpu as paddle
    from paddle_tpu.incubate.nn import \
        fused_bias_dropout_residual_layer_norm as ref_fn
    from paddle_tpu_torch.incubate.nn import \
        fused_bias_dropout_residual_layer_norm as fn
    rng = np.random.RandomState(5)
    x, r = rng.randn(4, 8).astype("f"), rng.randn(4, 8).astype("f")
    bias, s, b = (rng.randn(8).astype("f") for _ in range(3))
    want = ref_fn(*(paddle.to_tensor(a) for a in (x, r, bias, s, b)),
                  dropout_rate=0.3, training=False)
    got = fn(*(torch.tensor(a) for a in (x, r, bias, s, b)),
             dropout_rate=0.3, training=False)
    assert _rel(got.numpy(), np.asarray(want._val)) <= RTOL
    got = fn(torch.tensor(x), torch.tensor(r), dropout_rate=0.0)
    want = ref_fn(paddle.to_tensor(x), paddle.to_tensor(r),
                  dropout_rate=0.0)
    assert _rel(got.numpy(), np.asarray(want._val)) <= RTOL


def test_encoder_layer_default_dropout_reaches_the_attention():
    """The reference's dropout_rate also sets the attention's dropout
    (paddle_tpu/incubate/nn.py:229-237), which keeps flash attention's
    rule from firing in training."""
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    ref = paddle.incubate.nn.FusedTransformerEncoderLayer(32, 4, 64)
    port = pt.incubate.nn.FusedTransformerEncoderLayer(32, 4, 64,
                                                       device="cpu")
    assert port.fused_attn.attn_dropout_rate == \
        ref.fused_attn.attn_dropout_rate == 0.1
    port = pt.incubate.nn.FusedTransformerEncoderLayer(
        32, 4, 64, attn_dropout_rate=0.0, device="cpu")
    assert port.fused_attn.attn_dropout_rate == 0.0
    assert port.ffn.dropout.p == 0.1


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_softmax_mask_fuse_and_upper_triangle(dtype):
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    rng = np.random.RandomState(6)
    x = rng.randn(2, 3, 5, 7).astype(dtype)
    mask = np.where(rng.rand(2, 1, 5, 7) < 0.3, -1e4, 0.0).astype(dtype)
    want = paddle.incubate.softmax_mask_fuse(paddle.to_tensor(x),
                                             paddle.to_tensor(mask))
    got = pt.incubate.softmax_mask_fuse(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._val),
                               rtol=1e-6, atol=1e-7)
    assert got.dtype == torch.tensor(x).dtype
    for shape in ((2, 3, 5, 7), (2, 4, 4)):
        y = rng.randn(*shape).astype(dtype)
        want = paddle.incubate.softmax_mask_fuse_upper_triangle(
            paddle.to_tensor(y))
        got = pt.incubate.softmax_mask_fuse_upper_triangle(torch.tensor(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(want._val),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["sum", "mean", "max", "min"])
def test_segment_reductions_match_the_reference(mode):
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    rng = np.random.RandomState(7)
    data = rng.randn(7, 3).astype("float32")
    ids = np.array([0, 0, 1, 3, 3, 3, 4], dtype="int64")   # segment 2 empty
    want = getattr(paddle.incubate, f"segment_{mode}")(
        paddle.to_tensor(data), paddle.to_tensor(ids))
    got = getattr(pt.incubate, f"segment_{mode}")(torch.tensor(data),
                                                  torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._val),
                               rtol=1e-6)
    ints = rng.randint(-5, 5, (7, 2)).astype("int32")
    want = getattr(paddle.incubate, f"segment_{mode}")(
        paddle.to_tensor(ints), paddle.to_tensor(ids))
    got = getattr(pt.incubate, f"segment_{mode}")(torch.tensor(ints),
                                                  torch.tensor(ids))
    if mode != "mean":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want._val))


def test_segment_mean_gradient():
    import paddle_tpu_torch as pt
    data = torch.randn(5, 2, dtype=torch.float64, requires_grad=True)
    ids = torch.tensor([1, 1, 0, 2, 2])
    out = pt.incubate.segment_mean(data, ids)
    (out * torch.arange(1.0, 4.0, dtype=torch.float64)[:, None]).sum() \
        .backward()
    # segment 1 (rows 0, 1) weighs 2 over 2 rows; 0 weighs 1; 2 weighs 3
    want = torch.tensor([[1.0] * 2, [1.0] * 2, [1.0] * 2, [1.5] * 2,
                         [1.5] * 2], dtype=torch.float64)
    assert torch.allclose(data.grad, want)


def _quad_steps(P, wrap, steps=6):
    """SGD(0.3) on sum(p**2) from p = [1, -2, 3, 0.5], wrapped; the
    parameter after each step."""
    import paddle_tpu as paddle
    if P is paddle:
        from paddle_tpu.core.tensor import Parameter
        p = Parameter(np.array([1.0, -2.0, 3.0, 0.5], "float32"))
    else:
        p = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0, 0.5]))
    inner = P.optimizer.SGD(learning_rate=0.3, parameters=[p])
    opt = wrap(P, inner, p)
    out = []
    for _ in range(steps):
        loss = (p * p).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(np.asarray(p._val if hasattr(p, "_val") else
                              p.detach().numpy()).copy())
    return out, opt, p


def test_lookahead_matches_the_reference():
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt

    def wrap(P, inner, p):
        return P.incubate.LookAhead(inner, alpha=0.5, k=3)
    want, _, _ = _quad_steps(paddle, wrap)
    got, opt, _ = _quad_steps(pt, wrap)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert opt.state_dict()["step"] == 6


def test_model_average_apply_and_restore_match_the_reference():
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt

    class Both:
        def __init__(self, inner, avg):
            self.inner, self.avg = inner, avg

        def step(self):
            self.inner.step()
            self.avg.step()

        def clear_grad(self):
            self.inner.clear_grad()

    def wrap(P, inner, p):
        return Both(inner, P.incubate.ModelAverage(0.15, parameters=[p]))
    want, ropt, rp = _quad_steps(paddle, wrap)
    got, opt, p = _quad_steps(pt, wrap)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    ropt.avg.apply()
    opt.avg.apply()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(rp._val),
                               rtol=1e-6)
    np.testing.assert_allclose(p.detach().numpy(), np.mean(got, 0),
                               rtol=1e-6)
    opt.avg.restore()
    np.testing.assert_array_equal(p.detach().numpy(), got[-1])
