"""Every optimizer of the PyTorch/CUDA port against the JAX reference's,
with ParamAttr, the regularizers, parameter groups and ``minimize``.

Each optimizer takes 5 steps on the same numpy parameters and grads in
both packages, f32 and (where it has multi_precision) bf16 with f32
masters, under no weight decay, a float coefficient and an L2Decay, with
and without ClipGradByGlobalNorm(0.5); the parameters and every
accumulator of the state dict, by key, must agree: f32 to 1e-6, bf16
parameters within one ulp (they are the masters rounded). The port's
rules run as multi-tensor passes (optimizer/optimizer.py); the
reference's as a per-parameter loop. Then the caveats the port does not
mirror (ROADMAP C-ref-10, -11, -12), checkpoints crossing both ways, the
reference's own optimizer tests, a tiny GPT under Lamb and RMSProp and a
LeNet under Momentum + L2Decay through ``Model.fit``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as ref
from paddle_tpu.core.tensor import Tensor as RefTensor
from paddle_tpu.regularizer import L1Decay as RefL1, L2Decay as RefL2
from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT

import paddle_tpu_torch as pt
from paddle_tpu_torch.regularizer import L1Decay, L2Decay
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

torch.set_num_threads(1)

STEPS = 5
SHAPES = {"fc_w": (6, 4), "fc_b": (4,), "emb_w": (5, 3)}

# the 12 optimizers of the reference's __all__, with settings that reach
# their options
OPTIMIZERS = {
    "SGD": dict(learning_rate=0.1),
    "Momentum": dict(learning_rate=0.1, momentum=0.9, use_nesterov=True),
    "Adam": dict(learning_rate=0.01),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.1,
                  apply_decay_param_fun=lambda n: n != "fc_b"),
    "Adagrad": dict(learning_rate=0.1, initial_accumulator_value=0.1),
    "Adadelta": dict(learning_rate=1.0, rho=0.9),
    "Adamax": dict(learning_rate=0.01),
    "RMSProp": dict(learning_rate=0.01, momentum=0.9, centered=True),
    "Lamb": dict(learning_rate=0.01,
                 exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1),
    "Lars": dict(learning_rate=0.1, lars_coeff=0.01,
                 exclude_from_weight_decay=["_b"]),
    "LarsMomentum": dict(learning_rate=0.1, momentum=0.8),
    "Ftrl": dict(learning_rate=0.1, l1=0.01, l2=0.01),
}
# more settings of the same classes
VARIANTS = {
    "RMSProp_plain": ("RMSProp", dict(learning_rate=0.01)),
    "Ftrl_power": ("Ftrl", dict(learning_rate=0.1, lr_power=-0.3)),
}
MULTI_PRECISION = ("Momentum", "Adam", "AdamW")
# AdamW's weight_decay is its decoupled coefficient and Lamb has
# lamb_weight_decay instead: neither takes a regularizer object
DECAYS = {"none": (None, None), "float": (0.01, 0.01),
          "l2": (RefL2(0.01), L2Decay(0.01))}


def _cls(package, key):
    return getattr(package.optimizer, VARIANTS.get(key, (key,))[0])


def _kwargs(key, decay):
    kw = dict(VARIANTS[key][1] if key in VARIANTS else OPTIMIZERS[key])
    base = VARIANTS.get(key, (key,))[0]
    if decay is None:
        return kw
    if base == "Lamb":
        kw["lamb_weight_decay"] = decay
    elif base == "AdamW":
        kw["weight_decay"] = decay
    else:
        kw["weight_decay"] = decay
    return kw


def _cases():
    out = []
    for key in [*OPTIMIZERS, *VARIANTS]:
        base = VARIANTS.get(key, (key,))[0]
        decays = ("none", "float") if base in ("AdamW", "Lamb") \
            else tuple(DECAYS)
        dtypes = ("float32", "bfloat16") if base in MULTI_PRECISION \
            else ("float32",)
        for dtype in dtypes:
            for decay in decays:
                for clip in (False, True):
                    out.append((key, dtype, decay, clip))
    return out


def _ref_params(inits, dtype):
    params = []
    for name, a in inits.items():
        p = ref.create_parameter(list(a.shape), dtype, name=name)
        p.set_value(np.asarray(jnp.asarray(a).astype(jnp.dtype(dtype))))
        params.append(p)
    return params


def _port_params(inits, dtype):
    params = []
    for name, a in inits.items():
        # a copy of its own: jnp.asarray may alias the numpy buffer, and
        # the port updates in place while JAX may not have read it yet
        p = pt.Parameter(torch.tensor(a).to(getattr(torch, dtype)))
        p.name = name
        params.append(p)
    return params


def _pair(key, dtype, decay, clip, inits):
    kw_ref = _kwargs(key, DECAYS[decay][0])
    kw_port = _kwargs(key, DECAYS[decay][1])
    if dtype == "bfloat16":
        kw_ref["multi_precision"] = kw_port["multi_precision"] = True
    rp, pp = _ref_params(inits, dtype), _port_params(inits, dtype)
    ropt = _cls(ref, key)(parameters=rp, grad_clip=ref.nn.ClipGradByGlobalNorm(
        0.5) if clip else None, **kw_ref)
    popt = _cls(pt, key)(parameters=pp, grad_clip=pt.nn.ClipGradByGlobalNorm(
        0.5) if clip else None, **kw_port)
    return rp, pp, ropt, popt


def _inits(seed=5):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(*s).astype("float32") for n, s in SHAPES.items()}


def _grads(seed, steps=STEPS):
    rng = np.random.RandomState(seed)
    return [{n: rng.randn(*s).astype("float32") for n, s in SHAPES.items()}
            for _ in range(steps)]


def _step_both(rp, pp, ropt, popt, grads, dtype):
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    for r, p, g in zip(rp, pp, grads.values()):
        r.grad = RefTensor(jnp.asarray(g).astype(jdt), stop_gradient=True)
        p.grad = torch.from_numpy(g).to(tdt)
    ropt.step()
    popt.step()
    ropt.clear_grad()
    popt.clear_grad()


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._val if hasattr(t, "_val") else t, np.float32)


@pytest.mark.parametrize("key,dtype,decay,clip", _cases())
def test_optimizer_matches_reference(key, dtype, decay, clip):
    inits = _inits()
    rp, pp, ropt, popt = _pair(key, dtype, decay, clip, inits)
    for grads in _grads(6):
        _step_both(rp, pp, ropt, popt, grads, dtype)
    for r, p in zip(rp, pp):
        assert p.dtype == getattr(torch, dtype)
        if dtype == "bfloat16":
            # one bf16 ulp: 2^-7 relative
            np.testing.assert_allclose(_f32(p), _f32(r), rtol=2 ** -7,
                                       atol=0, err_msg=p.name)
        else:
            np.testing.assert_allclose(_f32(p), _f32(r), rtol=1e-6,
                                       atol=1e-6, err_msg=p.name)
    want, got = ropt.state_dict(), popt.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(
            _f32(got[k]).reshape(-1), _f32(want[k]).reshape(-1), rtol=1e-6,
            atol=1e-6, err_msg=k)


@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_state_dict_crosses_both_ways(key, tmp_path):
    """Two steps in each package, then each loads the other's checkpoint
    (the .pdopt pickle): the port into its own tensors, in place, and one
    more step from the loaded state agrees."""
    inits = _inits(7)
    rp, pp, ropt, popt = _pair(key, "float32", "none", False, inits)
    grads = _grads(8, 3)
    for g in grads[:2]:
        _step_both(rp, pp, ropt, popt, g, "float32")
    ref.save(ropt.state_dict(), str(tmp_path / "ref.pdopt"))
    pt.save(popt.state_dict(), str(tmp_path / "port.pdopt"))
    held = {k: v.data_ptr() for k, v in popt.state_dict().items()}
    popt.set_state_dict(pt.load(str(tmp_path / "ref.pdopt")))
    assert {k: v.data_ptr() for k, v in popt.state_dict().items()} == held
    ropt.set_state_dict(ref.load(str(tmp_path / "port.pdopt")))
    _step_both(rp, pp, ropt, popt, grads[2], "float32")
    for r, p in zip(rp, pp):
        np.testing.assert_allclose(_f32(p), _f32(r), rtol=1e-6, atol=1e-6)
    fresh = _cls(pt, key)(parameters=pp, **_kwargs(key, None))
    fresh.set_state_dict(pt.load(str(tmp_path / "ref.pdopt")))
    assert sorted(fresh.state_dict()) == sorted(ropt.state_dict())


def test_updates_are_in_place():
    """Parameters, masters and accumulators keep their storage across
    steps (what a captured step's replays rely on)."""
    inits = _inits()
    for key in OPTIMIZERS:
        mp = key in MULTI_PRECISION
        pp = _port_params(inits, "bfloat16" if mp else "float32")
        opt = _cls(pt, key)(parameters=pp, **_kwargs(key, L2Decay(0.01)
                                                     if key not in (
                                                         "AdamW", "Lamb")
                                                     else None),
                            **({"multi_precision": True} if mp else {}))
        ptrs = None
        for grads in _grads(1, 3):
            for p, g in zip(pp, grads.values()):
                p.grad = torch.from_numpy(g).to(p.dtype)
            opt.step()
            now = [p.data_ptr() for p in pp] + sorted(
                t.data_ptr() for t in opt.state_dict().values())
            assert ptrs is None or now == ptrs, key
            ptrs = now


# -- ParamAttr, regularizers, groups, minimize ------------------------------------

def _linear_pair(weight_attr, bias_attr):
    """The reference's Linear(4, 3) and the port's with the same weights
    and attributes."""
    rl = ref.nn.Linear(4, 3, weight_attr=weight_attr[0],
                       bias_attr=bias_attr[0])
    pl = pt.nn.Linear(4, 3, weight_attr=weight_attr[1],
                      bias_attr=bias_attr[1], device="cpu")
    with torch.no_grad():
        pl.weight.copy_(torch.tensor(np.asarray(rl.weight._val)))
        if pl.bias is not None:
            pl.bias.copy_(torch.tensor(np.asarray(rl.bias._val)))
    return rl, pl


def test_param_attr_precedence_matches_reference():
    """A ParamAttr regularizer wins over the optimizer's weight_decay,
    need_clip=False keeps a grad out of the clip, trainable=False stops
    the update, and the name reaches the state dict."""
    rl, pl = _linear_pair(
        (ref.ParamAttr(name="w", regularizer=RefL1(0.05), need_clip=False,
                       learning_rate=0.5),
         pt.ParamAttr(name="w", regularizer=L1Decay(0.05), need_clip=False,
                      learning_rate=0.5)),
        (ref.ParamAttr(name="b", trainable=False),
         pt.ParamAttr(name="b", trainable=False)))
    assert pl.weight.name == "w" and pl.bias.name == "b"
    assert pl.weight.requires_grad and not pl.bias.requires_grad
    assert pl.weight.need_clip is False and pl.weight.optimize_attr == {
        "learning_rate": 0.5}
    assert isinstance(pl.weight.regularizer, L1Decay)
    # the reference never reads the factor; the port refuses it (C-ref-14)
    with pytest.raises(NotImplementedError, match="C-ref-14"):
        pt.optimizer.Momentum(learning_rate=0.1,
                              parameters=pl.parameters())
    pl.weight.optimize_attr["learning_rate"] = 1.0
    ropt = ref.optimizer.Momentum(
        learning_rate=0.1, parameters=rl.parameters(),
        weight_decay=RefL2(0.3), grad_clip=ref.nn.ClipGradByGlobalNorm(1e-3))
    popt = pt.optimizer.Momentum(
        learning_rate=0.1, parameters=pl.parameters(),
        weight_decay=L2Decay(0.3), grad_clip=pt.nn.ClipGradByGlobalNorm(1e-3))
    x = np.random.RandomState(2).randn(5, 4).astype("float32")
    for _ in range(3):
        ref.sum(rl(ref.to_tensor(x)) ** 2).backward()
        (pl(torch.tensor(x)) ** 2).sum().backward()
        ropt.step()
        popt.step()
        ropt.clear_grad()
        popt.clear_grad()
    np.testing.assert_allclose(_f32(pl.weight), _f32(rl.weight), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(_f32(pl.bias), _f32(rl.bias))
    assert sorted(popt.state_dict()) == sorted(ropt.state_dict()) == [
        "w__velocity"]


def test_param_attr_forms():
    """None, False, a name, an Initializer and a ParamAttr."""
    lin = pt.nn.Linear(2, 3, weight_attr="named", bias_attr=False,
                       device="cpu")
    assert lin.weight.name == "named" and lin.bias is None
    lin = pt.nn.Linear(2, 3, weight_attr=pt.nn.initializer.Constant(0.5),
                       bias_attr=pt.ParamAttr(
                           initializer=pt.nn.initializer.Constant(2.0)),
                       device="cpu")
    assert float(lin.weight.sum()) == 3.0 and float(lin.bias.sum()) == 6.0
    emb = pt.nn.Embedding(5, 2, weight_attr=pt.ParamAttr(name="table"),
                          device="cpu")
    assert emb.weight.name == "table"
    import copy
    twin = copy.deepcopy(lin)
    assert twin.weight.regularizer is None and twin.weight.need_clip


def test_param_attr_l2decay_applied():
    """tests/test_regressions.py:95-97 on the port: a zero gradient still
    decays a weight whose ParamAttr carries L2Decay."""
    lin = pt.nn.Linear(2, 2, weight_attr=pt.ParamAttr(
        regularizer=L2Decay(0.5)), device="cpu")
    opt = pt.optimizer.SGD(learning_rate=1.0, parameters=lin.parameters())
    w0 = lin.weight.detach().clone()
    (lin(torch.zeros(1, 2)).sum() * 0).backward()
    opt.step()
    torch.testing.assert_close(lin.weight.detach(), w0 * 0.5)


def test_parameter_groups_flatten_and_extra_keys_raise():
    """Groups flatten as in the reference; a group option (which the
    reference stores and never reads) raises (ROADMAP C-ref-10)."""
    inits = _inits()
    pp, flat = _port_params(inits, "float32"), _port_params(inits, "float32")
    grouped = pt.optimizer.Adam(learning_rate=0.01, parameters=[
        {"params": pp[:1]}, {"params": pp[1:]}])
    plain = pt.optimizer.Adam(learning_rate=0.01, parameters=flat)
    for grads in _grads(3, 2):
        for a, b, g in zip(pp, flat, grads.values()):
            a.grad, b.grad = torch.tensor(g), torch.tensor(g)
        grouped.step()
        plain.step()
    for a, b in zip(pp, flat):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="C-ref-10"):
        pt.optimizer.Adam(parameters=[{"params": pp, "learning_rate": 0.1}])
    # the reference takes the option and ignores it
    rp = _ref_params(inits, "float32")
    ref.optimizer.Adam(parameters=[{"params": rp, "learning_rate": 0.1}])


def test_optimizer_l1decay_is_l1_against_the_math():
    """Optimizer-level L1Decay: g + coeff * sign(p), as Paddle documents
    (ROADMAP C-ref-11); the reference applies coeff * p."""
    p0 = np.array([0.5, -2.0, 3.0], "float32")
    g = np.array([0.1, 0.2, -0.3], "float32")
    lr, c = 0.1, 0.05
    p = pt.Parameter(torch.tensor(p0))
    opt = pt.optimizer.SGD(learning_rate=lr, parameters=[p],
                           weight_decay=L1Decay(c))
    p.grad = torch.tensor(g)
    opt.step()
    want = p0 - np.float32(lr) * (g + np.float32(c) * np.sign(p0))
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)
    rp = ref.create_parameter([3], "float32")
    rp.set_value(p0)
    ropt = ref.optimizer.SGD(learning_rate=lr, parameters=[rp],
                             weight_decay=RefL1(c))
    rp.grad = RefTensor(jnp.asarray(g), stop_gradient=True)
    ropt.step()
    np.testing.assert_allclose(np.asarray(rp._val),
                               p0 - np.float32(lr) * (g + np.float32(c) * p0),
                               rtol=1e-6)


def test_adamw_lr_ratio_against_the_math():
    """AdamW(lr_ratio=f): lr * f(param) in the decoupled decay and in the
    Adam step (Paddle's adamw op; ROADMAP C-ref-12), two steps in f64
    numpy against the port in f32."""
    inits = _inits()
    pp = _port_params(inits, "float32")
    ratio = {"fc_w": 0.5, "fc_b": 1.0, "emb_w": 0.25}
    lr, coeff, b1, b2, eps = 0.01, 0.1, 0.9, 0.999, 1e-8
    opt = pt.optimizer.AdamW(learning_rate=lr, weight_decay=coeff,
                             lr_ratio=lambda p: ratio[p.name],
                             parameters=pp)
    want = {n: a.astype(np.float64) for n, a in inits.items()}
    m = {n: 0.0 for n in inits}
    v = {n: 0.0 for n in inits}
    for t, grads in enumerate(_grads(4, 2), 1):
        for p, g in zip(pp, grads.values()):
            p.grad = torch.tensor(g)
        opt.step()
        for n, g in grads.items():
            lr_p = lr * ratio[n]
            w = want[n] * (1 - lr_p * coeff)
            m[n] = b1 * m[n] + (1 - b1) * g
            v[n] = b2 * v[n] + (1 - b2) * g.astype(np.float64) ** 2
            lr_t = lr_p * np.sqrt(1 - b2 ** t) / (1 - b1 ** t)
            want[n] = w - lr_t * m[n] / (np.sqrt(v[n])
                                         + eps * np.sqrt(1 - b2 ** t))
    for p in pp:
        np.testing.assert_allclose(p.detach().numpy(), want[p.name],
                                   rtol=1e-5, atol=1e-6, err_msg=p.name)


def test_minimize_is_backward_then_step():
    rl, pl = _linear_pair((None, None), (None, None))
    twin = pt.nn.Linear(4, 3, device="cpu")
    twin.load_state_dict(pl.state_dict())
    x = torch.tensor(np.random.RandomState(1).randn(5, 4).astype("float32"))
    ropt = ref.optimizer.Adam(learning_rate=0.1, parameters=rl.parameters())
    popt = pt.optimizer.Adam(learning_rate=0.1, parameters=pl.parameters())
    topt = pt.optimizer.Adam(learning_rate=0.1, parameters=twin.parameters())
    assert popt.minimize((pl(x) ** 2).mean()) == (None, None)
    (twin(x) ** 2).mean().backward()
    topt.step()
    ropt.minimize(ref.mean(rl(ref.to_tensor(x.numpy())) ** 2))
    assert torch.equal(pl.weight, twin.weight)
    np.testing.assert_allclose(_f32(pl.weight), _f32(rl.weight), rtol=1e-6,
                               atol=1e-6)


# -- the reference's own optimizer tests, on the port ------------------------------

@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_optimizer_steps_a_linear(key):
    """tests/test_training.py:39-43: one step on a Linear moves it."""
    torch.manual_seed(3)
    layer = pt.nn.Linear(4, 4, device="cpu")
    opt = _cls(pt, key)(parameters=layer.parameters(),
                        **{**_kwargs(key, None), "learning_rate": 0.1})
    x = torch.randn(8, 4)
    before = layer.weight.detach().clone()
    (layer(x) ** 2).mean().backward()
    opt.step()
    assert not torch.equal(before, layer.weight.detach())


def _quad_converges(make, steps=200):
    w = pt.Parameter(torch.tensor([3.0, -2.0]))
    opt = make([w])
    for _ in range(steps):
        (w * w).sum().backward()
        opt.step()
        opt.clear_grad()
    return float((w * w).sum())


def test_lars_converges():
    """tests/test_new_ops.py:185-190."""
    final = _quad_converges(lambda ps: pt.optimizer.Lars(
        learning_rate=0.5, momentum=0.9, lars_coeff=0.1,
        lars_weight_decay=0.0, parameters=ps))
    assert final < 1e-2, final


def test_ftrl_converges():
    """tests/test_new_ops.py:192-196."""
    final = _quad_converges(lambda ps: pt.optimizer.Ftrl(
        learning_rate=0.5, parameters=ps))
    assert final < 1e-2, final


def test_ftrl_l1_induces_sparsity():
    """tests/test_new_ops.py:198-215."""
    rng = np.random.RandomState(0)
    X = torch.tensor(rng.randn(64, 8).astype("float32"))
    true_w = torch.zeros(8)
    true_w[:2] = torch.tensor([2.0, -3.0])
    y = X @ true_w
    w = pt.Parameter(torch.zeros(8))
    opt = pt.optimizer.Ftrl(learning_rate=0.5, l1=2.0, parameters=[w])
    for _ in range(150):
        (((X * w).sum(-1) - y) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
    assert (w.detach()[2:].abs() < 0.15).all(), w


# -- model level -------------------------------------------------------------------

GPT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
               max_position_embeddings=128, dropout=0.0)


def _gpt_stream(steps=3, batch=2, seq=64):
    rng = np.random.RandomState(0)
    perm = rng.permutation(64)
    ids = np.empty((steps, batch, seq + 1), np.int64)
    ids[:, :, 0] = rng.randint(0, 64, (steps, batch))
    for t in range(seq):
        ids[:, :, t + 1] = perm[ids[:, :, t]]
    return ids[:, :, :-1].astype("int32"), ids[:, :, 1:]


@pytest.mark.parametrize("key,kw", [
    ("Lamb", dict(learning_rate=1e-2)),
    ("RMSProp", dict(learning_rate=1e-3, momentum=0.9)),
])
def test_tiny_gpt_steps_follow_reference(key, kw):
    ref.seed(0)
    rmodel = RefGPT(RefConfig(**GPT_CFG))
    arrays = {k: np.asarray(v._val) for k, v in rmodel.state_dict().items()}
    pmodel = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    pt.load_numpy_state_dict(pmodel, arrays)
    ropt = getattr(ref.optimizer, key)(parameters=rmodel.parameters(), **kw)
    popt = getattr(pt.optimizer, key)(parameters=pmodel.parameters(), **kw)
    want, got = [], []
    for x, y in zip(*_gpt_stream()):
        loss = rmodel(ref.to_tensor(x), labels=ref.to_tensor(y))
        loss.backward()
        ropt.step()
        ropt.clear_grad()
        want.append(float(loss))
        loss = pmodel(torch.from_numpy(x), labels=torch.from_numpy(y))
        loss.backward()
        popt.step()
        popt.clear_grad()
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[-1] < got[0]


class _Losses(pt.callbacks.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


def test_lenet_fit_with_l2decay_and_param_attr_follows_reference():
    """PaddleClas's regularizer through Model.fit: Momentum with
    weight_decay=L2Decay(1e-4), one fc weight regularised on its own
    (L1Decay, as ParamAttr(regularizer=...) sets it); 8 steps."""
    ref.seed(0)
    rnet = ref.vision.models.LeNet()
    pnet = pt.vision.models.LeNet(device="cpu")
    pt.load_numpy_state_dict(pnet, {k: np.array(v._val)
                                    for k, v in rnet.state_dict().items()})
    rnet.fc[1].weight.regularizer = RefL1(1e-3)
    pnet.fc[1].weight.regularizer = L1Decay(1e-3)
    models = []
    for P, net, reg in ((ref, rnet, RefL2(1e-4)), (pt, pnet, L2Decay(1e-4))):
        m = P.Model(net)
        m.prepare(P.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                       weight_decay=reg,
                                       parameters=net.parameters()),
                  P.nn.CrossEntropyLoss())
        models.append(m)
    curves = []
    for P, m in zip((ref, pt), models):
        rec = _Losses()
        np.random.seed(7)
        m.fit(P.vision.datasets.MNIST(mode="train"), batch_size=64,
              shuffle=False, num_iters=8, verbose=0, callbacks=[rec])
        curves.append(rec.losses)
    assert len(curves[1]) == len(curves[0]) == 8
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-5, atol=0)
