"""The training slice of the PyTorch/CUDA port against the JAX reference.

Same numpy inputs (and carried weights) through paddle_tpu and
paddle_tpu_torch on the host: the fused ops' backwards against jax.vjp of
the reference's custom_vjps, cross_entropy, the optimizers' update rules,
and a tiny GPT trained for 5 AdamW steps through ``jit.to_static`` whose
losses must follow the reference's eager steps, on the math path and on
the flash path (B1/B2/B3's plain versions through the autograd Function).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
from paddle_tpu.core.tensor import Tensor as RefTensor
from paddle_tpu.ops import fused_ffn as ref_ffn
from paddle_tpu.ops import fused_residual_ln as ref_rln
from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.ops import _param_guard, autotune
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.ops import fused_residual_ln as port_rln
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa
from paddle_tpu_torch.ops.cuda import launch_counts
from paddle_tpu_torch.ops.fused_ffn import fused_ffn
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

# The shapes here are tiny: one intra-op thread is enough, and it keeps
# torch's spinning OpenMP pool from taking cores from the timing-sensitive
# tests that other workers run beside these.
torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)


def _tensor(a, dtype=torch.float32, grad=True):
    return torch.from_numpy(np.array(a)).to(dtype).requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy()


# -- (a) fused_residual_ln ----------------------------------------------------

def _rln_inputs(seed, degenerate=False):
    rng = np.random.RandomState(seed)
    x, y = (rng.randn(2, 8, 32).astype("float32") for _ in range(2))
    w = (1.0 + 0.1 * rng.randn(32)).astype("float32")
    if degenerate:
        w[3] = 0.0
    b = (0.1 * rng.randn(32)).astype("float32")
    return x, y, w, b


@pytest.mark.parametrize("dtype,tol", [
    ("float32", F32),
    # bf16: both sides compute in f32 from the same bf16 inputs and round
    # outputs and grads to bf16 once; one bf16 ulp is 2^-7 relative, and
    # dw/db sum 16 such terms
    ("bfloat16", dict(rtol=2e-2, atol=2e-2)),
])
@pytest.mark.parametrize("return_residual", [False, True])
@pytest.mark.parametrize("degenerate", [False, True])
def test_fused_residual_ln_grads_match_jax_vjp(degenerate, return_residual,
                                               dtype, tol):
    """The no-saved-z backward (and, for a weight with a zero channel, the
    plain route the reference's eager guard takes) against jax.vjp of the
    reference."""
    arrs = _rln_inputs(1 + 2 * degenerate + return_residual, degenerate)
    rng = np.random.RandomState(7)
    cts = [rng.randn(2, 8, 32).astype("float32")
           for _ in range(1 + return_residual)]
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(a).astype(jdt) for a in arrs]
    if degenerate:
        def ref(x, y, w, b):
            outs, _ = ref_rln._fwd_impl(x, y, w, b, 1e-5, return_residual,
                                        None)
            return outs
    else:
        def ref(x, y, w, b):
            return ref_rln._fused_residual_ln_diff(x, y, w, b, 1e-5,
                                                   return_residual, None)
    outs_r, vjp = jax.vjp(ref, *jargs)
    jcts = [jnp.asarray(c).astype(jdt) for c in cts]
    want = vjp(tuple(jcts) if return_residual else jcts[0])

    tdt = getattr(torch, dtype)
    ts = [_tensor(a, tdt) for a in arrs]
    outs = port_rln.fused_residual_ln(*ts, epsilon=1e-5,
                                      return_residual=return_residual)
    outs = outs if return_residual else (outs,)
    # the plain route keeps z for autograd; the Function keeps only
    # (w, b, out, rstd). A weight clear of the band takes the Function
    # where the fusion policy's table keeps the op fused (bf16 training
    # measured slower fused on the card: ops/autotune.py _POLICY_FALLBACK)
    fused = not degenerate and autotune.policy_table_choice(
        "fused_residual_ln", autotune.short_dtype(tdt), "fwd_bwd") == "fused"
    fn_name = type(outs[-1].grad_fn).__name__
    assert ("FusedResidualLN" in fn_name) == fused, fn_name
    assert ts[2]._degen_cache == (port_rln._W_TOL, degenerate)
    torch.autograd.backward(outs, [_tensor(c, tdt, False) for c in cts])
    outs_r = outs_r if return_residual else (outs_r,)
    for o, r in zip(outs, outs_r):
        np.testing.assert_allclose(_np(o), np.asarray(r.astype(jnp.float32)),
                                   **tol)
    for t, w, name in zip(ts, want, ("dx", "dy", "dw", "db")):
        assert t.grad.dtype == tdt, name
        np.testing.assert_allclose(_np(t.grad),
                                   np.asarray(w.astype(jnp.float32)),
                                   err_msg=name, **tol)


def test_fused_residual_ln_guard_is_sticky_and_reset_by_loading():
    """The verdict is cached on the parameter and kept across an
    optimizer's own update (sticky: no sync per step); a write the
    version counter sees, and a load, make it checked again (C3)."""
    layer = GPTForCausalLM(GPTConfig(vocab_size=16, hidden_size=64,
                                     num_layers=1, num_heads=1,
                                     max_position_embeddings=128,
                                     dropout=0.0), device="cpu")
    w = layer.gpt.h[0].ln2.weight
    name = next(n for n, p in layer.named_parameters() if p is w)
    x = torch.zeros(1, 4, 64, requires_grad=True)
    port_rln.fused_residual_ln(x, x, w, layer.gpt.h[0].ln2.bias)
    assert w._degen_cache == (port_rln._W_TOL, False)
    gen = _param_guard.generation()
    with torch.no_grad():
        w.zero_()         # an in-place write: the verdict is checked again
    assert port_rln.degenerate_below_tol(w, port_rln._W_TOL) is True
    assert _param_guard.generation() == gen + 1
    sd = {k: v.numpy() for k, v in layer.state_dict().items()}
    sd[name] = np.ones(64, np.float32)
    pt.load_numpy_state_dict(layer, sd)
    assert w._degen_cache == (port_rln._W_TOL, False)
    assert _param_guard.generation() == gen + 2
    opt = pt.optimizer.SGD(learning_rate=1.0, parameters=[w])
    w.grad = torch.ones_like(w)
    opt.step()            # w is 0 now, but an update keeps the verdict
    assert float(w.detach().abs().max()) == 0.0
    assert port_rln.degenerate_below_tol(w, port_rln._W_TOL) is False
    assert _param_guard.generation() == gen + 2


# -- (b) fused_ffn -----------------------------------------------------------

@pytest.mark.parametrize("activation", ["gelu", "gelu_tanh", "relu"])
def test_fused_ffn_grads_match_jax_vjp(activation):
    rng = np.random.RandomState(3)
    arrs = [rng.randn(2, 8, 32), rng.randn(32, 64) * 0.2, rng.randn(64) * 0.1,
            rng.randn(64, 32) * 0.2, rng.randn(32) * 0.1]
    arrs = [a.astype("float32") for a in arrs]
    dy = rng.randn(2, 8, 32).astype("float32")
    out_r, vjp = jax.vjp(
        lambda *a: ref_ffn._fused_ffn_diff(*a, activation),
        *(jnp.asarray(a) for a in arrs))
    want = vjp(jnp.asarray(dy))
    ts = [_tensor(a) for a in arrs]
    out = fused_ffn(*ts, activation=activation)
    assert "FusedFFN" in type(out.grad_fn).__name__
    out.backward(_tensor(dy, grad=False))
    np.testing.assert_allclose(_np(out), np.asarray(out_r), **F32)
    for t, w, name in zip(ts, want, ("dx", "dw1", "db1", "dw2", "db2")):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), err_msg=name,
                                   rtol=1e-4, atol=1e-5)


# -- (c) cross_entropy ---------------------------------------------------------

def _ce_case(kind):
    rng = np.random.RandomState(4)
    logits = rng.randn(12, 10).astype("float32") * 2
    labels = rng.randint(0, 10, size=(12,)).astype("int64")
    kw = {}
    if kind == "ignore_index":
        labels[[1, 5, 6]] = -100
    elif kind == "all_ignored":
        labels[:] = 7
        kw["ignore_index"] = 7
    elif kind == "weight":
        labels[2] = -100
        kw["weight"] = rng.rand(10).astype("float32") + 0.5
    elif kind == "soft":
        soft = rng.rand(12, 10).astype("float32")
        labels = soft / soft.sum(-1, keepdims=True)
        kw["soft_label"] = True
    return logits, labels, kw


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("kind", ["plain", "ignore_index", "all_ignored",
                                  "weight", "soft"])
def test_cross_entropy_matches_reference(kind, reduction):
    logits, labels, kw = _ce_case(kind)
    want = RF.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels),
        reduction=reduction,
        **{k: paddle.to_tensor(v) if k == "weight" else v
           for k, v in kw.items()})
    lg = _tensor(logits)
    got = PF.cross_entropy(
        lg, torch.from_numpy(labels), reduction=reduction,
        **{k: torch.from_numpy(v) if k == "weight" else v
           for k, v in kw.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want._val), **F32)
    got.sum().backward()
    assert torch.isfinite(lg.grad).all()
    if kind == "all_ignored":
        # max(#valid, 1) in the mean: 0, not NaN
        assert float(got.detach().sum()) == 0.0 \
            and float(lg.grad.abs().sum()) == 0.0


# -- (d) optimizers --------------------------------------------------------------

OPTIMIZERS = {
    "SGD": dict(learning_rate=0.1),
    "SGD_l2": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.1, momentum=0.9),
    "Momentum_nesterov": dict(learning_rate=0.1, momentum=0.9,
                              use_nesterov=True),
    "Adam": dict(learning_rate=0.01),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.1),
}


def _opt_class(module, key):
    return getattr(module.optimizer, key.split("_")[0])


# bf16 runs with multi_precision, which SGD does not have
@pytest.mark.parametrize("key,dtype", [
    *[(k, "float32") for k in sorted(OPTIMIZERS)],
    *[(k, "bfloat16") for k in sorted(OPTIMIZERS) if not k.startswith("SGD")],
])
def test_optimizer_steps_match_reference(key, dtype):
    """5 steps on the same parameters and grads: f32, and bf16 with
    multi_precision, where the f32 masters must agree to 1e-6 and the bf16
    parameters within one ulp (they are the masters rounded)."""
    mp = dtype == "bfloat16"
    rng = np.random.RandomState(5)
    shapes = [(6, 4), (4,)]
    inits = [rng.randn(*s).astype("float32") for s in shapes]
    grads = [[rng.randn(*s).astype("float32") for s in shapes]
             for _ in range(5)]
    kw = dict(OPTIMIZERS[key])
    if mp:
        kw["multi_precision"] = True
    jdt = jnp.dtype(dtype)
    ref_params = []
    for a in inits:
        p = paddle.create_parameter(list(a.shape), dtype)
        p.set_value(np.asarray(jnp.asarray(a).astype(jdt)))
        ref_params.append(p)
    ref_opt = _opt_class(paddle, key)(parameters=ref_params, **kw)
    tdt = getattr(torch, dtype)
    # a copy of its own for the port: jnp.asarray may alias a numpy
    # buffer (zero-copy when it happens to be 64-byte aligned), and the
    # port updates its parameters in place while JAX's asynchronous
    # dispatch may not yet have read the reference's
    port_params = [torch.nn.Parameter(torch.tensor(a, dtype=tdt))
                   for a in inits]
    port_opt = _opt_class(pt, key)(parameters=port_params, **kw)
    for step_grads in grads:
        for rp, pp, g in zip(ref_params, port_params, step_grads):
            rp.grad = RefTensor(jnp.asarray(g).astype(jdt),
                                stop_gradient=True)
            pp.grad = torch.from_numpy(g).to(tdt)
        ref_opt.step()
        port_opt.step()
        ref_opt.clear_grad()
        port_opt.clear_grad()
        assert all(p.grad is None for p in port_params)
    for rp, pp in zip(ref_params, port_params):
        assert pp.dtype == tdt
        want = np.asarray(rp._val.astype(jnp.float32))
        if mp:
            # one bf16 ulp: 2^-7 relative
            np.testing.assert_allclose(_np(pp), want, rtol=2 ** -7, atol=0)
            ref_master = ref_opt._accumulators["master_weight"][id(rp)]
            np.testing.assert_allclose(
                port_opt._get_master(pp).numpy(),
                np.asarray(ref_master._val), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(_np(pp), want, rtol=1e-6, atol=1e-6)


def test_optimizer_lr_and_clear_grad():
    p = torch.nn.Parameter(torch.ones(3))
    opt = pt.optimizer.AdamW(learning_rate=1e-3, parameters=[p])
    assert opt._learning_rate.dtype == torch.float32 \
        and opt._learning_rate.dim() == 0
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5
    p.grad = torch.ones(3)
    opt.clear_grad(set_to_zero=True)
    assert torch.equal(p.grad, torch.zeros(3))
    opt.clear_grad()
    assert p.grad is None
    with pytest.raises(TypeError, match="LRScheduler"):
        pt.optimizer.SGD(learning_rate=object(), parameters=[p])
    with pytest.raises(TypeError, match="grad_clip"):
        pt.optimizer.SGD(parameters=[p], grad_clip=1.0)
    # AdamW's lr_ratio and sparse grads are taken (ROADMAP A2, done): a
    # sparse grad of ones steps as its dense equivalent does
    pt.optimizer.AdamW(parameters=[p], lr_ratio=lambda q: 1.0)
    q = torch.nn.Parameter(torch.ones(3))
    twin = pt.optimizer.AdamW(learning_rate=0.5, parameters=[q])
    opt.set_lr(0.5)
    p.grad, q.grad = torch.ones(3).to_sparse(), torch.ones(3)
    opt.step()
    twin.step()
    assert torch.equal(p.detach(), q.detach())


# -- (e) the slice on a tiny GPT -------------------------------------------

CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
           max_position_embeddings=512, dropout=0.0)
STEPS = 5


def _stream(seed=0):
    """bench.py's learnable stream: a permutation over a sub-vocabulary
    drives next-token generation, x[t+1] = perm[x[t]]."""
    rng = np.random.RandomState(seed)
    sub, batch, seq = 64, 2, 256
    perm = rng.permutation(sub)
    ids = np.empty((STEPS, batch, seq + 1), np.int64)
    ids[:, :, 0] = rng.randint(0, sub, (STEPS, batch))
    for t in range(seq):
        ids[:, :, t + 1] = perm[ids[:, :, t]]
    return ids[:, :, :-1].astype("int32"), ids[:, :, 1:]


@pytest.fixture(scope="module")
def reference_run():
    """Initial weights and the reference's 5 eager AdamW steps."""
    paddle.seed(0)
    ref = RefGPT(RefConfig(**CFG))
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=ref.parameters())
    xs, ys = _stream()
    losses = []
    for x, y in zip(xs, ys):
        loss = ref(paddle.to_tensor(x), labels=paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return arrays, losses


@pytest.mark.parametrize("path", ["math", "flash"])
def test_tiny_gpt_adamw_steps_follow_reference(reference_run, path,
                                               monkeypatch):
    arrays, want = reference_run
    calls = []
    if path == "flash":
        # take the flash path as on a card: B1/B2/B3's plain versions
        # through the autograd Function
        real = port_attn._FlashAttentionFn.apply
        monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
        monkeypatch.setattr(port_attn._FlashAttentionFn, "apply",
                            lambda *a: calls.append(1) or real(*a))
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    pt.load_numpy_state_dict(model, arrays)
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())

    @pt.jit.to_static
    def step(x, y):
        loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.float()

    before = dict(launch_counts)
    xs, ys = _stream()
    got = [float(step(torch.from_numpy(x), torch.from_numpy(y)).detach())
           for x, y in zip(xs, ys)]
    assert dict(launch_counts) == before          # launch-free on the host
    assert len(calls) == (STEPS * CFG["num_layers"] if path == "flash"
                          else 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert got[-1] < got[0]


def test_gpt_plain_residual_branch_matches_reference(reference_run,
                                                     monkeypatch):
    """PADDLE_TPU_FUSED_RESIDUAL_LN=0: both GPTs take the plain residual +
    LayerNorm composition; loss and every parameter's grad agree."""
    arrays, _ = reference_run
    monkeypatch.setenv("PADDLE_TPU_FUSED_RESIDUAL_LN", "0")
    paddle.seed(0)
    ref = RefGPT(RefConfig(**CFG))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    pt.load_numpy_state_dict(model, arrays)
    xs, ys = _stream()
    loss_r = ref(paddle.to_tensor(xs[0]), labels=paddle.to_tensor(ys[0]))
    loss_r.backward()
    loss = model(torch.from_numpy(xs[0]), labels=torch.from_numpy(ys[0]))
    loss.backward()
    assert not any("FusedResidualLN" in type(n).__name__
                   for n in _graph_nodes(loss.grad_fn))
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
    ref_grads = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(ref_grads[name].grad._val),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def _graph_nodes(fn):
    seen, todo = set(), [fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return seen


def test_to_static_keeps_the_call_surface():
    calls = []

    @pt.jit.to_static(input_spec=[pt.jit.InputSpec([None, 4], "int32")])
    def fn(a):
        calls.append(a)
        return a + 1

    assert fn(1) == 2 and calls == [1]
    layer = pt.jit.to_static(torch.nn.Linear(2, 2))
    assert isinstance(layer.forward, pt.jit.StaticFunction)
    assert layer(torch.zeros(1, 2)).shape == (1, 2)
    assert port_fa.KERNEL_NAMES == ("flash_attn_fwd", "flash_attn_bwd_dkv",
                                    "flash_attn_bwd_dq")


# -- (f) recompute, and recompute under amp ----------------------------------

def _grads_of(model, x, y, amp=False):
    model.zero_grad(set_to_none=True)
    with pt.amp.auto_cast(enable=amp):
        loss = model(x, labels=y)
    loss.backward()
    return float(loss.detach()), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}


def _port_gpt(arrays, recompute):
    model = GPTForCausalLM(GPTConfig(**CFG, recompute=recompute),
                           device="cpu")
    return pt.load_numpy_state_dict(model, arrays)


@pytest.mark.parametrize("path", ["math", "flash"])
def test_recompute_grads_match_plain_and_reference(reference_run, path,
                                                   monkeypatch):
    """recompute=True reruns each block in the backward: the port's grads
    equal its own without recompute (1e-6) and the reference's recompute
    grads (1e-5 relative L2); on the flash path B1 runs twice per layer
    (the forward and its rerun)."""
    arrays, _ = reference_run
    calls = []
    if path == "flash":
        real = port_attn._FlashAttentionFn.apply
        monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
        monkeypatch.setattr(port_attn._FlashAttentionFn, "apply",
                            lambda *a: calls.append(1) or real(*a))
    xs, ys = _stream()
    x, y = torch.from_numpy(xs[0]), torch.from_numpy(ys[0])
    loss_p, plain = _grads_of(_port_gpt(arrays, False), x, y)
    n_plain = len(calls)
    loss_r, remat = _grads_of(_port_gpt(arrays, True), x, y)
    if path == "flash":
        assert n_plain == CFG["num_layers"]
        assert len(calls) - n_plain == 2 * CFG["num_layers"]
    assert loss_r == loss_p
    for name, g in plain.items():
        np.testing.assert_allclose(remat[name].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    if path == "flash":
        return
    paddle.seed(0)
    ref = RefGPT(RefConfig(**CFG, recompute=True))
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in arrays.items()})
    loss_ref = ref(paddle.to_tensor(xs[0]), labels=paddle.to_tensor(ys[0]))
    loss_ref.backward()
    np.testing.assert_allclose(loss_r, float(loss_ref), rtol=1e-5)
    for name, p in ref.named_parameters():
        want = np.asarray(p.grad._val)
        gap = np.linalg.norm(remat[name].numpy() - want) / np.linalg.norm(
            want)
        assert gap <= 1e-5, (name, gap)


def test_recompute_under_auto_cast_keeps_the_casts(reference_run):
    """The rerun happens inside loss.backward(), outside the auto_cast
    block: recompute restores the amp state of the forward, so the rerun
    computes in bf16 as the forward did and the grads are the ones without
    recompute."""
    arrays, _ = reference_run
    xs, ys = _stream()
    x, y = torch.from_numpy(xs[0]), torch.from_numpy(ys[0])
    loss_p, plain = _grads_of(_port_gpt(arrays, False), x, y, amp=True)
    loss_r, remat = _grads_of(_port_gpt(arrays, True), x, y, amp=True)
    loss_32, _ = _grads_of(_port_gpt(arrays, False), x, y)
    assert loss_r == loss_p != loss_32
    for name, g in plain.items():
        np.testing.assert_allclose(remat[name].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_recompute_replays_the_dropout_masks():
    """A block with dropout draws the same masks in the rerun as in the
    forward (its generator's state is saved and restored)."""
    cfg = dict(CFG, dropout=0.1)
    grads = []
    for recompute in (False, True):
        model = GPTForCausalLM(GPTConfig(**cfg, recompute=recompute),
                               device="cpu", generator=pt.make_generator(3))
        xs, ys = _stream()
        grads.append(_grads_of(model, torch.from_numpy(xs[0][:, :64]),
                               torch.from_numpy(ys[0][:, :64])))
    assert grads[0][0] == grads[1][0]
    for name, g in grads[0][1].items():
        np.testing.assert_allclose(grads[1][1][name].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


# -- (g) optimizer state_dict ---------------------------------------------------

def test_optimizer_state_dict_matches_reference(tmp_path):
    """2 AdamW multi-precision steps on bf16 parameters with the same grads:
    the reference's keys, and values equal to 1e-6; each package loads the
    other's checkpoint (the .pdparams pickle), the port in place."""
    rng = np.random.RandomState(8)
    shapes = [(6, 4), (4,), (3, 2)]
    inits = [rng.randn(*s).astype("float32") for s in shapes]
    grads = [[rng.randn(*s).astype("float32") for s in shapes]
             for _ in range(2)]
    ref_params = []
    for a in inits:
        p = paddle.create_parameter(list(a.shape), "bfloat16")
        p.set_value(np.asarray(jnp.asarray(a).astype(jnp.bfloat16)))
        ref_params.append(p)
    kw = dict(learning_rate=0.01, weight_decay=0.1, multi_precision=True)
    ref_opt = paddle.optimizer.AdamW(parameters=ref_params, **kw)
    port_params = [torch.nn.Parameter(torch.tensor(a).to(torch.bfloat16))
                   for a in inits]
    port_opt = pt.optimizer.AdamW(parameters=port_params, **kw)
    for step_grads in grads:
        for rp, pp, g in zip(ref_params, port_params, step_grads):
            rp.grad = RefTensor(jnp.asarray(g).astype(jnp.bfloat16),
                                stop_gradient=True)
            pp.grad = torch.tensor(g).to(torch.bfloat16)
        ref_opt.step()
        port_opt.step()
    want = ref_opt.state_dict()
    got = port_opt.state_dict()
    assert sorted(got) == sorted(want)
    assert {k.rsplit("__", 1)[1] for k in got} == {
        "master_weight", "moment1", "moment2", "beta1_pow", "beta2_pow"}
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k]._val, np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # the port reads the reference's checkpoint, into its own tensors
    paddle.save(want, str(tmp_path / "ref.pdopt"))
    fresh = pt.optimizer.AdamW(parameters=port_params, **kw)
    for _ in range(2):    # build the accumulators first: loading is in place
        for pp, g in zip(port_params, grads[0]):
            pp.grad = torch.tensor(g).to(torch.bfloat16)
        fresh.step()
    held = {k: id(v) for k, v in fresh.state_dict().items()}
    fresh.set_state_dict(pt.load(str(tmp_path / "ref.pdopt")))
    assert {k: id(v) for k, v in fresh.state_dict().items()} == held
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[k].numpy(), err_msg=k)
    # and the reference reads the port's
    pt.save(got, str(tmp_path / "port.pdopt"))
    ref2 = paddle.optimizer.AdamW(parameters=ref_params, **kw)
    ref2.set_state_dict(paddle.load(str(tmp_path / "port.pdopt")))
    for k, v in ref2.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v._val), got[k].numpy(),
                                      err_msg=k)
