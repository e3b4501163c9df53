"""The cases of the nn surface's parity checks, shared by
tests/test_torch_nn_surface.py (the port against the reference on the
host) and chip_smoke.py's nn_cases lane (the port on the card against the
port on the host).

A case calls a package ``P`` (paddle_tpu or paddle_tpu_torch) on tensors
made with ``P.to_tensor`` from fixed numpy arrays; layers are built on
the package's current device (the harness sets it) and take their
weights from seeded numpy arrays through ``set_state_dict``, so both
packages hold the same ones. ``post`` maps the outputs (as numpy arrays)
to what is compared where the raw outputs are not comparable: a random
draw's values (then its shape and what its distribution guarantees).
The cases cover every function of nn.functional's activation and common
modules, ``normalize`` and ``sequence_mask``, every initializer, every
activation, common and container layer, and the reference's own
tests/test_nn.py cases other than the RNNs (ROADMAP A4). This module
imports neither package and no JAX.
"""
import math

import numpy as np

_R = np.random.RandomState(11)


def _f(*shape, scale=1.0):
    return (scale * _R.randn(*shape)).astype("float32")


class Case:
    """One call: ``fn(P, *tensors)``; the id's part before "-" names the
    function or layer it covers."""

    def __init__(self, cid, fn, arrays, post=None, tol=None):
        self.id, self.fn, self.arrays = cid, fn, arrays
        self.post = post
        self.tol = tol or {}

    @property
    def function(self):
        return self.id.split("-")[0]


CASES = []


def case(cid, fn, *arrays, post=None, tol=None):
    CASES.append(Case(cid, fn, list(arrays), post, tol))


def F(P):
    return P.nn.functional


def weights_for(layer, seed):
    """Seeded arrays for every entry of ``layer``'s state dict (positive
    for a running variance), by name."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, t in layer.state_dict().items():
        a = rng.randn(*tuple(t.shape)).astype("float32") * 0.5
        if name.endswith("_variance"):
            a = np.abs(a) + 0.5
        out[name] = a
    return out


def load(P, layer, seed=0):
    """``layer`` with the seeded weights, loaded through set_state_dict."""
    layer.set_state_dict({k: P.to_tensor(v)
                          for k, v in weights_for(layer, seed).items()})
    return layer


X = _f(3, 8, scale=2.5)            # activations: both signs, past +-6
X4 = _f(2, 4, 5, 6)
XN = _f(2, 5, 6, 4)                # NHWC
X3 = _f(2, 3, 7)
X5 = _f(1, 2, 3, 4, 5)
IMG = _f(2, 3, 6, 8)
IDX = np.array([[0, 3, 5], [-1, 2, 6]])
INTERP_TOL = {"rtol": 1e-5, "atol": 1e-5}

# -- activation functions (nn/functional/activation.py) ----------------------
for name, call in [
        ("relu", lambda P, x: F(P).relu(x)),
        ("relu6", lambda P, x: F(P).relu6(x)),
        ("elu", lambda P, x: F(P).elu(x)),
        ("elu-alpha", lambda P, x: F(P).elu(x, alpha=0.5)),
        ("selu", lambda P, x: F(P).selu(x)),
        ("celu", lambda P, x: F(P).celu(x, alpha=1.5)),
        ("gelu", lambda P, x: F(P).gelu(x)),
        ("gelu-approximate", lambda P, x: F(P).gelu(x, approximate=True)),
        ("sigmoid", lambda P, x: F(P).sigmoid(x)),
        ("log_sigmoid", lambda P, x: F(P).log_sigmoid(x)),
        ("tanh", lambda P, x: F(P).tanh(x)),
        ("tanhshrink", lambda P, x: F(P).tanhshrink(x)),
        ("hardtanh", lambda P, x: F(P).hardtanh(x, -2.0, 1.5)),
        ("hardshrink", lambda P, x: F(P).hardshrink(x, 0.7)),
        ("hardsigmoid", lambda P, x: F(P).hardsigmoid(x)),
        ("hardsigmoid-slope", lambda P, x: F(P).hardsigmoid(x, 0.2, 0.4)),
        ("hardswish", lambda P, x: F(P).hardswish(x)),
        ("leaky_relu", lambda P, x: F(P).leaky_relu(x)),
        ("leaky_relu-slope", lambda P, x: F(P).leaky_relu(x, 0.3)),
        ("rrelu", lambda P, x: F(P).rrelu(x)),
        ("softmax", lambda P, x: F(P).softmax(x)),
        ("softmax-axis0", lambda P, x: F(P).softmax(x, axis=0)),
        ("softmax-dtype", lambda P, x: F(P).softmax(x, dtype="float32")),
        ("log_softmax", lambda P, x: F(P).log_softmax(x, axis=1)),
        ("softplus", lambda P, x: F(P).softplus(x)),
        ("softplus-beta", lambda P, x: F(P).softplus(x, beta=4.0,
                                                     threshold=5.0)),
        ("softshrink", lambda P, x: F(P).softshrink(x, 0.8)),
        ("softsign", lambda P, x: F(P).softsign(x)),
        ("swish", lambda P, x: F(P).swish(x)),
        ("silu", lambda P, x: F(P).silu(x)),
        ("mish", lambda P, x: F(P).mish(x)),
        ("maxout", lambda P, x: F(P).maxout(x, 4, axis=1)),
        ("glu", lambda P, x: F(P).glu(x)),
        ("glu-axis0", lambda P, x: F(P).glu(x[:2], axis=0)),
        ("thresholded_relu", lambda P, x: F(P).thresholded_relu(x, 0.5)),
        ("relu_", lambda P, x: F(P).relu_(x * 1.0)),
        ("elu_", lambda P, x: F(P).elu_(x * 1.0, 0.7)),
        ("softmax_", lambda P, x: F(P).softmax_(x * 1.0, axis=0)),
        ("tanh_", lambda P, x: F(P).tanh_(x * 1.0))]:
    case(name, call, X)
case("maxout-nchw", lambda P, x: F(P).maxout(x, 2), X4)
case("prelu-scalar", lambda P, x, w: F(P).prelu(x, w), X4,
     np.array([0.2], "float32"))
case("prelu-channels", lambda P, x, w: F(P).prelu(x, w), X4,
     np.array([0.1, 0.2, 0.3, 0.4], "float32"))
case("prelu-nhwc", lambda P, x, w: F(P).prelu(x, w, data_format="NHWC"), XN,
     np.array([0.1, 0.2, 0.3, 0.4], "float32"))


def _rrelu_post(arrays, out):
    x = arrays[0]
    neg = x < 0
    ratio = out[neg] / x[neg]
    return [out.shape, bool(np.all(out[~neg] == x[~neg])),
            bool(np.all((ratio >= 1 / 8 - 1e-6) & (ratio <= 1 / 3 + 1e-6)))]


case("rrelu-training", lambda P, x: F(P).rrelu(x, training=True), X,
     post=_rrelu_post)


def _gumbel_post(arrays, out):
    soft, hard = out
    return [soft.shape, bool(np.allclose(soft.sum(-1), 1.0, atol=1e-5)),
            bool(np.all((hard == 0) | (hard == 1))),
            bool(np.all(hard.sum(-1) == 1))]


case("gumbel_softmax", lambda P, x: [F(P).gumbel_softmax(x),
                                     F(P).gumbel_softmax(x, hard=True)], X,
     post=_gumbel_post)

# -- common functions (nn/functional/common.py, norm.py, __init__.py) --------
case("one_hot", lambda P, i: F(P).one_hot(i, 6), IDX)
case("label_smooth", lambda P, l: F(P).label_smooth(l), np.eye(5, dtype="f4"))
case("label_smooth-prior",
     lambda P, l, p: F(P).label_smooth(l, p, epsilon=0.3),
     np.eye(5, dtype="f4"), np.full((1, 5), 0.2, "float32"))
case("zeropad2d", lambda P, x: F(P).zeropad2d(x, [1, 2, 0, 3]), X4)
case("zeropad2d-nhwc",
     lambda P, x: F(P).zeropad2d(x, [1, 2, 0, 3], data_format="NHWC"), XN)
case("pad-reflect", lambda P, x: F(P).pad(x, [1, 1, 2, 0], mode="reflect"),
     X4)
for mode, x, up, down in [
        ("nearest", IMG, [9, 13], [4, 3]),
        ("bilinear", IMG, [9, 13], [4, 3]),
        ("bicubic", IMG, [9, 13], [4, 3]),
        ("area", IMG, [9, 13], [3, 4]),
        ("linear", X3, [12], [4]),
        ("trilinear", X5, [4, 6, 7], [2, 2, 3])]:
    case(f"interpolate-{mode}-up",
         lambda P, v, m=mode, s=up: F(P).interpolate(
             v, size=s, mode=m, data_format="NCDHW" if len(s) == 3
             else ("NCL" if len(s) == 1 else "NCHW")), x, tol=INTERP_TOL)
    case(f"interpolate-{mode}-down",
         lambda P, v, m=mode, s=down: F(P).interpolate(
             v, size=s, mode=m, data_format="NCDHW" if len(s) == 3
             else ("NCL" if len(s) == 1 else "NCHW")), x, tol=INTERP_TOL)
    if mode not in ("nearest", "area"):
        for d, s in (("up", up), ("down", down)):
            case(f"interpolate-{mode}-align_corners-{d}",
                 lambda P, v, m=mode, s=s: F(P).interpolate(
                     v, size=s, mode=m, align_corners=True,
                     data_format="NCDHW" if len(s) == 3
                     else ("NCL" if len(s) == 1 else "NCHW")),
                 x, tol=INTERP_TOL)
case("interpolate-scale_factor",
     lambda P, v: F(P).interpolate(v, scale_factor=1.5, mode="bilinear"),
     IMG, tol=INTERP_TOL)
case("interpolate-nhwc",
     lambda P, v: F(P).interpolate(v, size=[7, 9], mode="bilinear",
                                   data_format="NHWC"), XN, tol=INTERP_TOL)
case("interpolate-nearest-scale",
     lambda P, v: F(P).interpolate(v, scale_factor=2, mode="nearest"), IMG)
case("upsample", lambda P, v: F(P).upsample(v, size=[8, 10],
                                            mode="bicubic"), IMG,
     tol=INTERP_TOL)
case("pixel_shuffle", lambda P, x: F(P).pixel_shuffle(x, 2), _f(2, 8, 3, 4))
case("pixel_shuffle-nhwc",
     lambda P, x: F(P).pixel_shuffle(x, 2, data_format="NHWC"),
     _f(2, 3, 4, 8))
case("pixel_unshuffle", lambda P, x: F(P).pixel_unshuffle(x, 2),
     _f(2, 3, 4, 6))
case("pixel_unshuffle-nhwc",
     lambda P, x: F(P).pixel_unshuffle(x, 2, data_format="NHWC"),
     _f(2, 4, 6, 3))
case("channel_shuffle", lambda P, x: F(P).channel_shuffle(x, 3),
     _f(2, 6, 3, 4))
case("channel_shuffle-nhwc",
     lambda P, x: F(P).channel_shuffle(x, 2, data_format="NHWC"),
     _f(2, 3, 4, 6))
case("unfold", lambda P, x: F(P).unfold(x, 3), IMG)
case("unfold-strided", lambda P, x: F(P).unfold(x, [2, 3], strides=2,
                                                paddings=1, dilations=[1, 2]),
     IMG)
case("unfold-pad4", lambda P, x: F(P).unfold(x, 2, paddings=[1, 0, 2, 1]),
     IMG)
case("fold", lambda P, x: F(P).fold(x, [4, 5], 2), _f(2, 12, 12),
     tol=INTERP_TOL)
case("fold-strided",
     lambda P, x: F(P).fold(x, [6, 7], [3, 2], strides=2, paddings=1),
     _f(2, 18, 12), tol=INTERP_TOL)
case("cosine_similarity", lambda P, a, b: F(P).cosine_similarity(a, b),
     _f(4, 6), _f(4, 6))
case("cosine_similarity-axis",
     lambda P, a, b: F(P).cosine_similarity(a, b, axis=-1), X4, X4[::-1])
case("bilinear", lambda P, a, b, w, c: F(P).bilinear(a, b, w, c),
     _f(3, 4), _f(3, 5), _f(2, 4, 5), _f(2))
case("bilinear-nobias", lambda P, a, b, w: F(P).bilinear(a, b, w),
     _f(3, 4), _f(3, 5), _f(2, 4, 5))
case("dropout2d-eval", lambda P, x: F(P).dropout2d(x, training=False), X4)
case("dropout3d-eval", lambda P, x: F(P).dropout3d(x, training=False), X5)
case("alpha_dropout-eval",
     lambda P, x: F(P).alpha_dropout(x, training=False), X)
case("dropout-downscale-eval",
     lambda P, x: F(P).dropout(x, 0.3, training=False,
                               mode="downscale_in_infer"), X)


def _channel_post(axes):
    """Each slice over ``axes`` dropped whole or kept whole, scaled by
    1 / (1 - p)."""
    def post(arrays, out):
        x = arrays[0]
        ratio = np.where(x != 0, out / x, 0.0)
        red = tuple(i for i in range(out.ndim) if i not in axes)
        lo, hi = ratio.min(axis=red), ratio.max(axis=red)
        return [out.shape, bool(np.all(np.isclose(lo, hi))),
                bool(np.all(np.isclose(lo, 0.0) | np.isclose(lo, 2.0)))]
    return post


case("dropout2d-training", lambda P, x: F(P).dropout2d(x, 0.5), _f(8, 6, 3, 3),
     post=_channel_post((0, 1)))
case("dropout2d-training-nhwc",
     lambda P, x: F(P).dropout2d(x, 0.5, data_format="NHWC"), _f(8, 3, 3, 6),
     post=_channel_post((0, 3)))
case("dropout3d-training", lambda P, x: F(P).dropout3d(x, 0.5),
     _f(4, 6, 2, 3, 3), post=_channel_post((0, 1)))
case("dropout-axis", lambda P, x: F(P).dropout(x, 0.5, axis=1),
     _f(16, 5), post=_channel_post((1,)))


def _alpha_post(arrays, out):
    x, p = arrays[0], 0.4
    alpha_p = -1.6732632423543772848170429916717 * 1.0507009873554804934193349852946
    a = 1.0 / math.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2))
    b = -a * alpha_p * p
    kept = np.isclose(out, a * x + b, atol=1e-5)
    dropped = np.isclose(out, a * alpha_p + b, atol=1e-5)
    return [out.shape, bool(np.all(kept | dropped)),
            bool(0.3 < dropped.mean() < 0.5)]


case("alpha_dropout-training", lambda P, x: F(P).alpha_dropout(x, 0.4),
     _f(40, 50), post=_alpha_post)
case("normalize", lambda P, x: F(P).normalize(x), X4)
case("normalize-p1", lambda P, x: F(P).normalize(x, p=1, axis=-1), X4)
case("normalize-p3", lambda P, x: F(P).normalize(x, p=3, axis=0), X)
case("sequence_mask", lambda P, l: F(P).sequence_mask(l), np.array([1, 4, 2]))
case("sequence_mask-maxlen",
     lambda P, l: F(P).sequence_mask(l, maxlen=6, dtype="bool"),
     np.array([[1, 4], [0, 2]]))
case("diag_embed", lambda P, x: F(P).diag_embed(x), _f(2, 4))
case("npair_loss", lambda P, a, p, l: F(P).npair_loss(a, p, l), _f(6, 5),
     _f(6, 5), np.array([0, 1, 0, 2, 1, 2]))
case("scaled_dot_product_attention",
     lambda P, q, k, v: F(P).scaled_dot_product_attention(q, k, v,
                                                          is_causal=True),
     _f(2, 6, 2, 8), _f(2, 6, 2, 8), _f(2, 6, 2, 8),
     tol={"rtol": 1e-5, "atol": 1e-6})
case("sequence_mask-float",
     lambda P, l: F(P).sequence_mask(l, maxlen=5, dtype="float32"),
     np.array([3, 5]))

# -- initializers (nn/initializer.py) -----------------------------------------


def _param(P, init, shape=(64, 96), is_bias=False):
    return P.create_parameter(list(shape), "float32", is_bias=is_bias,
                              default_initializer=init)


def I(P):
    return P.nn.initializer


def _draw_post(lo=None, hi=None, mean=None, std=None, rel=0.03):
    """A random draw by what its distribution guarantees: its bounds,
    mean (within 4 standard errors) and standard deviation (within
    ``rel``), as booleans both packages must give."""
    def post(arrays, out):
        w = out.reshape(-1).astype(np.float64)
        checks = [out.shape]
        if lo is not None:
            checks.append(bool(w.min() >= lo - 1e-6 and w.max() <= hi + 1e-6))
            checks.append(bool(w.min() < lo + 0.05 * (hi - lo)
                               and w.max() > hi - 0.05 * (hi - lo)))
        if mean is not None:
            checks.append(bool(abs(w.mean() - mean)
                               < 4 * std / math.sqrt(w.size)))
            checks.append(bool(abs(w.std() / std - 1.0) < rel))
        return checks
    return post


_FAN = (128, 32, 3, 3)     # a conv weight: fan_in 288, fan_out 1152
_GAIN_RELU = math.sqrt(2.0)
case("Constant", lambda P: _param(P, I(P).Constant(0.37)))
case("Assign", lambda P, a: _param(P, I(P).Assign(a), shape=(3, 4)),
     _f(3, 4))
case("Assign-list", lambda P: _param(
    P, I(P).Assign([[1.0, 2.0], [3.0, 4.0]]), shape=(2, 2)))
case("Assign-reshape", lambda P, a: _param(P, I(P).Assign(a), shape=(2, 6)),
     _f(3, 4))
case("Bilinear", lambda P: _param(P, I(P).Bilinear(), shape=(4, 2, 4, 4)))
case("Bilinear-odd", lambda P: _param(P, I(P).Bilinear(), shape=(3, 3, 5, 3)))
case("calculate_gain", lambda P: P.to_tensor(np.array(
    [I(P).calculate_gain(n) for n in
     ("sigmoid", "linear", "conv2d", "tanh", "relu", "selu")]
    + [I(P).calculate_gain("leaky_relu"),
       I(P).calculate_gain("leaky_relu", 0.2)], "float32")))
case("Normal", lambda P: _param(P, I(P).Normal(0.5, 2.0), shape=(300, 400)),
     post=_draw_post(mean=0.5, std=2.0))
case("Uniform", lambda P: _param(P, I(P).Uniform(-0.3, 0.7),
                                 shape=(300, 400)),
     post=_draw_post(lo=-0.3, hi=0.7, mean=0.2, std=1.0 / math.sqrt(12)))
# N(0, 1) truncated to [-2, 2] has std 0.879596
case("TruncatedNormal",
     lambda P: _param(P, I(P).TruncatedNormal(0.5, 2.0), shape=(300, 400)),
     post=_draw_post(lo=-3.5, hi=4.5, mean=0.5, std=2.0 * 0.879596))
case("XavierNormal", lambda P: _param(P, I(P).XavierNormal(), shape=_FAN),
     post=_draw_post(mean=0.0, std=math.sqrt(2.0 / (288 + 1152))))
case("XavierUniform", lambda P: _param(P, I(P).XavierUniform(), shape=_FAN),
     post=_draw_post(lo=-math.sqrt(6.0 / 1440), hi=math.sqrt(6.0 / 1440),
                     mean=0.0, std=math.sqrt(6.0 / 1440) / math.sqrt(3)))
case("XavierUniform-fans",
     lambda P: _param(P, I(P).XavierUniform(fan_in=10, fan_out=20, gain=2.0),
                      shape=(300, 400)),
     post=_draw_post(lo=-2 * math.sqrt(0.2), hi=2 * math.sqrt(0.2)))
case("KaimingNormal", lambda P: _param(P, I(P).KaimingNormal(), shape=_FAN),
     post=_draw_post(mean=0.0, std=_GAIN_RELU / math.sqrt(288)))
case("KaimingNormal-linear",
     lambda P: _param(P, I(P).KaimingNormal(nonlinearity="tanh"),
                      shape=(400, 300)),
     post=_draw_post(mean=0.0, std=(5.0 / 3.0) / math.sqrt(400)))
case("KaimingUniform", lambda P: _param(P, I(P).KaimingUniform(),
                                        shape=_FAN),
     post=_draw_post(lo=-_GAIN_RELU * math.sqrt(3.0 / 288),
                     hi=_GAIN_RELU * math.sqrt(3.0 / 288)))
case("KaimingUniform-fan_in",
     lambda P: _param(P, I(P).KaimingUniform(fan_in=50,
                                             nonlinearity="leaky_relu",
                                             negative_slope=0.1),
                      shape=(300, 400)),
     post=_draw_post(lo=-math.sqrt(2 / 1.01) * math.sqrt(3 / 50),
                     hi=math.sqrt(2 / 1.01) * math.sqrt(3 / 50)))


def _global_init(P):
    """set_global_initializer: it wins over a layer's default, a
    ParamAttr's initializer wins over it; restored afterwards."""
    I(P).set_global_initializer(I(P).Constant(0.3), I(P).Constant(-0.1))
    try:
        lin = P.nn.Linear(3, 4)
        conv = P.nn.Conv2D(2, 3, 3)
        own = P.nn.Linear(3, 4, weight_attr=P.ParamAttr(
            initializer=I(P).Constant(0.7)))
        return [lin.weight, lin.bias, conv.weight, conv.bias, own.weight,
                own.bias]
    finally:
        I(P).set_global_initializer(None, None)


case("set_global_initializer", _global_init)

# -- activation layers (nn/layer/activation.py) --------------------------------
for name, build in [
        ("ReLU", lambda P: P.nn.ReLU()),
        ("ReLU6", lambda P: P.nn.ReLU6()),
        ("ELU", lambda P: P.nn.ELU(0.4)),
        ("SELU", lambda P: P.nn.SELU()),
        ("CELU", lambda P: P.nn.CELU(2.0)),
        ("GELU", lambda P: P.nn.GELU()),
        ("GELU-approximate", lambda P: P.nn.GELU(True)),
        ("Sigmoid", lambda P: P.nn.Sigmoid()),
        ("LogSigmoid", lambda P: P.nn.LogSigmoid()),
        ("Tanh", lambda P: P.nn.Tanh()),
        ("Tanhshrink", lambda P: P.nn.Tanhshrink()),
        ("Hardtanh", lambda P: P.nn.Hardtanh(-0.5, 0.5)),
        ("Hardshrink", lambda P: P.nn.Hardshrink(0.3)),
        ("Hardsigmoid", lambda P: P.nn.Hardsigmoid()),
        ("Hardswish", lambda P: P.nn.Hardswish()),
        ("LeakyReLU", lambda P: P.nn.LeakyReLU(0.2)),
        ("Softmax", lambda P: P.nn.Softmax(axis=0)),
        ("LogSoftmax", lambda P: P.nn.LogSoftmax()),
        ("Softplus", lambda P: P.nn.Softplus(2.0, 10.0)),
        ("Softshrink", lambda P: P.nn.Softshrink(0.4)),
        ("Softsign", lambda P: P.nn.Softsign()),
        ("Swish", lambda P: P.nn.Swish()),
        ("SiLU", lambda P: P.nn.SiLU()),
        ("Silu", lambda P: P.nn.Silu()),
        ("Mish", lambda P: P.nn.Mish()),
        ("ThresholdedReLU", lambda P: P.nn.ThresholdedReLU(0.9)),
        ("GLU", lambda P: P.nn.GLU()),
        ("Maxout", lambda P: P.nn.Maxout(2, axis=-1))]:
    case(name, lambda P, x, b=build: b(P)(x), X)
case("PReLU", lambda P, x: load(P, P.nn.PReLU(4), 1)(x), X4)
case("PReLU-init", lambda P, x: P.nn.PReLU(1, 0.3)(x), X4)
case("PReLU-nhwc",
     lambda P, x: load(P, P.nn.PReLU(4, data_format="NHWC"), 2)(x), XN)

# -- common layers (nn/layer/common.py) -----------------------------------------
case("Identity", lambda P, x: P.nn.Identity(3, k=1)(x), X)
case("Flatten", lambda P, x: P.nn.Flatten()(x), X4)
case("Flatten-range", lambda P, x: P.nn.Flatten(1, 2)(x), X4)
case("Dropout2D-eval", lambda P, x: P.nn.Dropout2D(0.4).eval()(x), X4)
case("Dropout3D-eval", lambda P, x: P.nn.Dropout3D(0.4).eval()(x), X5)
case("AlphaDropout-eval", lambda P, x: P.nn.AlphaDropout(0.4).eval()(x), X)
case("Dropout2D-training", lambda P, x: P.nn.Dropout2D(0.5)(x),
     _f(8, 6, 3, 3), post=_channel_post((0, 1)))
case("Dropout3D-training", lambda P, x: P.nn.Dropout3D(0.5)(x),
     _f(4, 6, 2, 3, 3), post=_channel_post((0, 1)))
case("AlphaDropout-training", lambda P, x: P.nn.AlphaDropout(0.4)(x),
     _f(40, 50), post=_alpha_post)
case("Upsample", lambda P, x: P.nn.Upsample(size=[9, 5],
                                            mode="bilinear")(x), IMG,
     tol=INTERP_TOL)
case("Upsample-scale", lambda P, x: P.nn.Upsample(scale_factor=2)(x), IMG)
case("UpsamplingNearest2D",
     lambda P, x: P.nn.UpsamplingNearest2D(size=[12, 4])(x), IMG)
case("UpsamplingBilinear2D",
     lambda P, x: P.nn.UpsamplingBilinear2D(scale_factor=2)(x), IMG,
     tol=INTERP_TOL)
case("Pad1D", lambda P, x: P.nn.Pad1D([1, 2], value=0.5)(x), X3)
case("Pad1D-replicate", lambda P, x: P.nn.Pad1D([2, 1],
                                                mode="replicate")(x), X3)
case("Pad2D", lambda P, x: P.nn.Pad2D([1, 0, 2, 1])(x), X4)
case("Pad2D-circular", lambda P, x: P.nn.Pad2D([1, 1, 1, 1],
                                               mode="circular")(x), X4)
case("Pad3D", lambda P, x: P.nn.Pad3D([1, 0, 0, 1, 1, 1])(x), X5)
case("ZeroPad2D", lambda P, x: P.nn.ZeroPad2D([2, 1, 0, 1])(x), X4)
case("CosineSimilarity",
     lambda P, a, b: P.nn.CosineSimilarity(axis=0)(a, b), _f(5, 3), _f(5, 3))
case("Bilinear-layer",
     lambda P, a, b: load(P, P.nn.Bilinear(4, 5, 3), 3)(a, b), _f(2, 4),
     _f(2, 5))
case("Unfold", lambda P, x: P.nn.Unfold([2, 2], strides=2)(x), IMG)
case("Fold", lambda P, x: P.nn.Fold([4, 6], [2, 3])(x), _f(1, 12, 12),
     tol=INTERP_TOL)
case("PixelShuffle", lambda P, x: P.nn.PixelShuffle(3)(x), _f(1, 9, 2, 3))
case("PixelUnshuffle", lambda P, x: P.nn.PixelUnshuffle(2)(x),
     _f(1, 2, 4, 6))
case("ChannelShuffle", lambda P, x: P.nn.ChannelShuffle(2)(x),
     _f(2, 4, 3, 3))
case("PairwiseDistance", lambda P, a, b: P.nn.PairwiseDistance()(a, b),
     _f(4, 6), _f(4, 6))
case("PairwiseDistance-p1",
     lambda P, a, b: P.nn.PairwiseDistance(1.0, keepdim=True)(a, b),
     _f(4, 6), _f(4, 6))

# -- containers (nn/layer/container.py) ---------------------------------------


def _parameter_list(P, x):
    ps = P.nn.ParameterList([P.create_parameter(
        [8, 8], "float32", default_initializer=P.nn.initializer.Assign(
            np.eye(8, dtype="float32") * (i + 1))) for i in range(2)])
    ps.append(P.create_parameter(
        [8], "float32", default_initializer=P.nn.initializer.Constant(0.5)))
    return [P.matmul(P.matmul(x, ps[0]), ps[1]) + ps[2],
            P.to_tensor(np.array([len(ps)]))]


def _layer_dict(P, x):
    d = P.nn.LayerDict({"a": P.nn.Linear(8, 6), "b": P.nn.Tanh()})
    d["c"] = P.nn.Linear(6, 2)
    load(P, d, 4)
    for k in d.keys():
        x = d[k](x)
    return [x, P.to_tensor(np.array([len(d), "b" in d]))]


case("ParameterList", _parameter_list, X)
case("LayerDict", _layer_dict, X)
case("Sequential-set_state_dict",
     lambda P, x: load(P, P.nn.Sequential(P.nn.Linear(8, 5), P.nn.GELU(),
                                          P.nn.Linear(5, 2)), 5)(x), X)
case("LayerList", lambda P, x: [load(P, l, 6)(x) for l in P.nn.LayerList(
    [P.nn.Linear(8, 3), P.nn.Linear(8, 2)])], X)

# -- the reference's tests/test_nn.py, through both packages ----------------------
case("test_nn-relu_gelu_softmax",
     lambda P, x: [F(P).relu(x), F(P).softmax(x, axis=-1), F(P).gelu(x)],
     _f(3, 4))
case("test_nn-linear", lambda P, x, w, b: F(P).linear(x, w, b), _f(2, 3),
     _f(3, 4), _f(4), tol={"rtol": 1e-5, "atol": 1e-5})
case("test_nn-conv2d", lambda P, x, w: F(P).conv2d(x, w, padding=1),
     _f(1, 2, 5, 5), _f(3, 2, 3, 3), tol={"rtol": 1e-5, "atol": 1e-5})
case("test_nn-max_avg_pool", lambda P, x: [F(P).max_pool2d(x, 2, 2),
                                           F(P).avg_pool2d(x, 2, 2)],
     _f(1, 1, 4, 4))
case("test_nn-cross_entropy",
     lambda P, x, y: F(P).cross_entropy(x, y), _f(4, 5),
     np.array([0, 2, 4, 1]))
case("test_nn-cross_entropy_ignore",
     lambda P, x, y: F(P).cross_entropy(x, y, ignore_index=-100), _f(4, 5),
     np.array([0, -100, 4, 1]))
case("test_nn-cross_entropy_soft",
     lambda P, x, y: F(P).cross_entropy(x, y, soft_label=True), _f(4, 5),
     np.full((4, 5), 0.2, "float32"))
case("test_nn-mse_l1", lambda P, a, b: [F(P).mse_loss(a, b),
                                        F(P).l1_loss(a, b)],
     _f(3, 3), _f(3, 3))
case("test_nn-dropout_modes",
     lambda P, x: [F(P).dropout(x, p=0.5, training=True),
                   F(P).dropout(x, p=0.5, training=False)],
     np.ones(1000, "float32"),
     post=lambda a, out: [bool(0.35 < (out[0] != 0).mean() < 0.65),
                          bool(np.all(out[0][out[0] != 0] == 2.0)),
                          out[1]])
case("test_nn-embedding", lambda P, i, w: F(P).embedding(i, w),
     np.array([[1, 3], [5, 9]]), _f(10, 4))
case("test_nn-one_hot", lambda P, i: F(P).one_hot(i, 4), np.array([1, 2]))
case("test_nn-layer_norm", lambda P, x: F(P).layer_norm(x, 8),
     _f(2, 3, 8), tol={"rtol": 1e-5, "atol": 1e-5})
case("test_nn-linear_layer", lambda P, x: load(P, P.nn.Linear(4, 3), 7)(x),
     _f(2, 4))
case("test_nn-batch_norm_train_eval",
     lambda P, x: (lambda bn: [bn(x), bn._mean, bn._variance,
                               bn.eval()(x)])(load(P, P.nn.BatchNorm2D(3), 8)),
     _f(4, 3, 5, 5, scale=2.0), tol={"rtol": 1e-5, "atol": 1e-5})
case("test_nn-conv_layer", lambda P, x: load(
    P, P.nn.Conv2D(3, 8, 3, stride=2, padding=1), 9)(x), _f(2, 3, 8, 8),
    tol={"rtol": 1e-5, "atol": 1e-5})
case("test_nn-embedding_layer",
     lambda P, i: P.nn.Embedding(20, 6, padding_idx=0)(i)[0, 1],
     np.array([[1, 0, 3]]))
case("test_nn-train_eval_propagation",
     lambda P: (lambda m: [P.to_tensor(np.array(
         [m.eval() is m and not m[1].training,
          m.train() is m and m[1].training]))])(
         P.nn.Sequential(P.nn.Linear(2, 2), P.nn.Dropout(0.5))))
case("test_nn-multihead_attention",
     lambda P, q: load(P, P.nn.MultiHeadAttention(16, 4), 10)(q, q, q),
     _f(2, 5, 16), tol={"rtol": 1e-5, "atol": 1e-5})
case("test_nn-transformer_encoder",
     lambda P, s: load(P, P.nn.TransformerEncoder(
         P.nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0), 2), 11)(s),
     _f(2, 6, 16), tol={"rtol": 1e-4, "atol": 1e-5})
case("test_nn-transformer_full",
     lambda P, s, t: load(P, P.nn.Transformer(
         d_model=16, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
         dim_feedforward=32, dropout=0.0), 12)(s, t),
     _f(2, 5, 16), _f(2, 4, 16), tol={"rtol": 1e-4, "atol": 1e-5})
