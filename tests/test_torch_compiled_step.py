"""The port's compiled step on the host: the program cache's lifecycle and
counters (the port of tests/test_compiled_step.py's
TestCompileObservability), run_steps, and an AdamW GPT step through
CompiledTrainStep against the reference's compiled step. On the host a
built program runs the Python body (there are no CPU graphs); the keys,
stages and counters are those of the card, where the program is a CUDA
graph (tests/test_torch_cuda.py)."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.compiled_step import CompiledTrainStep as RefStep
from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                compile_stats,
                                                reset_compile_stats)
from paddle_tpu_torch.jit.to_static import StaticFunction
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

torch.set_num_threads(1)


@pytest.fixture()
def flag_guard():
    old = pt.get_flags()
    yield
    pt.set_flags(old)
    pt.jit.enable_to_static(True)


class _MLP(torch.nn.Module):
    def __init__(self, seed, din=8, dh=32, dout=4):
        super().__init__()
        gen = pt.make_generator(seed)
        self.fc1 = pt.nn.Linear(din, dh, device="cpu", generator=gen)
        self.fc2 = pt.nn.Linear(dh, dout, device="cpu", generator=gen)

    def forward(self, x):
        return self.fc2(torch.tanh(self.fc1(x)))


def _train_step(model, opt):
    def step(x, y):
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def _batches(steps, batch=16, din=8, dout=4, seed=0):
    rng = np.random.RandomState(seed)
    xs = torch.from_numpy(rng.randn(steps, batch, din).astype("float32"))
    ys = torch.from_numpy(rng.randint(0, dout, (steps, batch)))
    return xs, ys


def _compiled(seed=1, label="test.counters", opt_cls="SGD"):
    model = _MLP(seed)
    opt = getattr(pt.optimizer, opt_cls)(learning_rate=0.1,
                                         parameters=model.parameters())
    return model, CompiledTrainStep(_train_step(model, opt), label=label)


def test_one_compile_per_signature():
    _, step = _compiled()
    xs, ys = _batches(6)
    reset_compile_stats()
    for i in range(6):
        step(xs[i], ys[i])
    # call 1 = eager discovery, call 2 = the build (the one compile),
    # calls 3..6 = cache hits
    assert compile_stats() == {"compiles": 1, "cache_hits": 4,
                               "retrace_warnings": 0}
    prog, = step.static_function.programs.values()
    assert prog.stage == 1 and prog.built and prog.hits == 4
    assert prog.graph is None          # no graphs on the host


def test_second_shape_builds_second_program():
    _, step = _compiled()
    reset_compile_stats()
    for batch in (16, 8):
        xs, ys = _batches(3, batch=batch)
        for i in range(3):
            step(xs[i], ys[i])
    assert len(step.static_function.programs) == 2
    assert compile_stats()["compiles"] == 2
    assert compile_stats()["cache_hits"] == 2


def test_two_pass_discovery(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TWO_PASS_DISCOVERY", "1")
    _, step = _compiled()
    xs, ys = _batches(4)
    reset_compile_stats()
    for i in range(4):
        step(xs[i], ys[i])
    assert compile_stats()["compiles"] == 1
    assert compile_stats()["cache_hits"] == 1


@pytest.mark.allow_retrace
def test_retrace_storm_warning(flag_guard):
    pt.set_flags({"FLAGS_compiled_step_max_retraces": 2})
    _, step = _compiled(label="test.storm")
    rng = np.random.RandomState(0)
    reset_compile_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for batch in (4, 5, 6, 7):  # 4 distinct signatures > bound 2
            x = torch.from_numpy(rng.randn(batch, 8).astype("float32"))
            y = torch.from_numpy(rng.randint(0, 4, (batch,)))
            step(x, y)
            step(x, y)
    storm = [w for w in caught if issubclass(w.category, RuntimeWarning)
             and "retrace" in str(w.message)]
    assert len(storm) == 1, [str(w.message) for w in caught]
    assert "FLAGS_compiled_step_max_retraces" in str(storm[0].message)
    assert "test.storm" in str(storm[0].message)
    assert compile_stats()["retrace_warnings"] == 1


@pytest.mark.parametrize("switch", ["flag", "enable_to_static"])
def test_disabled_wrapper_is_pure_eager(flag_guard, switch):
    if switch == "flag":
        pt.set_flags({"FLAGS_compiled_step": 0})
    else:
        pt.jit.enable_to_static(False)
    assert pt.jit.compiled_step.compiled_step_enabled() == (switch != "flag")
    model, step = _compiled()
    eager_model = _MLP(1)
    eager_opt = pt.optimizer.SGD(learning_rate=0.1,
                                 parameters=eager_model.parameters())
    eager = _train_step(eager_model, eager_opt)
    xs, ys = _batches(3)
    reset_compile_stats()
    for i in range(3):
        assert torch.equal(step(xs[i], ys[i]), eager(xs[i], ys[i]))
    assert compile_stats() == {"compiles": 0, "cache_hits": 0,
                               "retrace_warnings": 0}
    assert step.static_function.programs == {}


def test_max_cached_programs_bound(flag_guard):
    pt.set_flags({"FLAGS_max_cached_programs": 2})
    calls = []

    @pt.jit.to_static
    def fn(x):
        calls.append(x.shape[0])
        return x * 2
    for n in (1, 2, 3, 3, 1):
        fn(torch.ones(n))
    assert len(fn.programs) == 2
    sizes = [key[0][1][0][1][0] for key in fn.programs]
    # n=1 was evicted when n=3 arrived, and discovered again at the end
    assert sizes == [3, 1] and calls == [1, 2, 3, 3, 1]


def test_per_instance_programs():
    class Net(torch.nn.Module):
        def __init__(self, scale):
            super().__init__()
            self.scale = scale

        @pt.jit.to_static
        def forward(self, x):
            return x * self.scale

    a, b = Net(2.0), Net(3.0)
    x = torch.ones(2)
    for _ in range(3):
        assert float(a(x)[0]) == 2.0 and float(b(x)[0]) == 3.0
    assert a.forward is a.forward and a.forward is not b.forward
    assert len(a.forward.programs) == 1 and len(b.forward.programs) == 1


def test_loading_weights_builds_a_new_program():
    """A load that changes the degenerate-weight guard's verdict on a
    weight (which a captured step baked in) makes the next call key a new
    program; a load that keeps every verdict reuses the program."""
    cfg = GPTConfig(vocab_size=32, hidden_size=64, num_layers=1,
                    num_heads=1, max_position_embeddings=16, dropout=0.0)
    model = GPTForCausalLM(cfg, device="cpu")
    step = pt.jit.to_static(lambda x, y: model(x, labels=y))
    ids = torch.zeros(1, 8, dtype=torch.int64)
    for _ in range(2):
        step(ids, ids)
    pt.load_numpy_state_dict(model, {k: v.clone() for k, v in
                                     model.state_dict().items()})
    step(ids, ids)
    assert len(step.programs) == 1
    state = {k: v.clone() for k, v in model.state_dict().items()}
    ln = next(k for k in state if k.endswith("ln2.weight"))
    state[ln][3] = 0.0
    pt.load_numpy_state_dict(model, state)
    step(ids, ids)
    assert len(step.programs) == 2


def test_run_steps_equals_k_calls():
    k = 5
    xs, ys = _batches(k, seed=3)
    model_a, step_a = _compiled(seed=4, opt_cls="Adam")
    model_b, step_b = _compiled(seed=4, opt_cls="Adam")
    reset_compile_stats()
    stacked = step_a.run_steps(xs, ys)
    assert compile_stats() == {"compiles": 1, "cache_hits": k - 2,
                               "retrace_warnings": 0}
    singles = [step_b(xs[i], ys[i]) for i in range(k)]
    assert stacked.shape == (k,)
    assert torch.equal(stacked, torch.stack(singles))
    for pa, pb in zip(model_a.parameters(), model_b.parameters()):
        assert torch.equal(pa, pb)
    # the same program serves both entry points
    assert len(step_a.static_function.programs) == 1
    reset_compile_stats()
    step_a.run_steps(xs, ys)
    step_a(xs[0], ys[0])
    assert compile_stats()["cache_hits"] == k + 1


def test_run_steps_checks_its_arguments():
    fn = StaticFunction(lambda x, y: x + y)
    with pytest.raises(ValueError, match="same leading"):
        fn.run_steps(torch.ones(2, 3), torch.ones(3, 3))
    with pytest.raises(ValueError, match="at least one tensor"):
        fn.run_steps(1, 2)
    out = fn.run_steps(torch.ones(3, 2), torch.ones(3, 2))
    assert torch.equal(out, torch.full((3, 2), 2.0))


CFG = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
           max_position_embeddings=16, dropout=0.0)


def test_gpt_adamw_compiled_step_matches_reference():
    """4 AdamW steps of a tiny GPT, CompiledTrainStep on both sides (the
    reference's builds one XLA program, the port's one program), f32
    losses to 1e-5."""
    paddle.seed(11)
    ref = RefGPT(RefConfig(**CFG))
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    ref_opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=ref.parameters())
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    pt.load_numpy_state_dict(model, arrays)
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())

    def make(m, o, to_tensor):
        def step(x, y):
            loss = m(to_tensor(x), labels=to_tensor(y))
            loss.backward()
            o.step()
            o.clear_grad()
            return loss
        return step

    ref_step = RefStep(make(ref, ref_opt, lambda a: a), label="ref.gpt")
    step = CompiledTrainStep(make(model, opt, lambda a: a), label="gpt")
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 64, (4, 4, 17))
    got, want = [], []
    reset_compile_stats()
    for i in range(4):
        x, y = ids[i, :, :-1].astype("int32"), ids[i, :, 1:]
        want.append(float(np.asarray(ref_step(
            paddle.to_tensor(x), paddle.to_tensor(y)).numpy())))
        got.append(float(step(torch.from_numpy(x),
                              torch.from_numpy(y)).detach()))
    assert compile_stats()["compiles"] == 1
    assert compile_stats()["cache_hits"] == 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[-1] < got[0]


# -- outer gradients (C1) and the lr tensor's device (C2) -------------------

def test_forward_only_layer_gives_eager_grads_on_every_call():
    """A forward-only to_static layer trained with an outer backward: the
    grads of calls 1-3 (discovery, build, built) equal eager's, and
    discovery finds the closed-over parameters as the program's leaves."""
    xs, ys = _batches(3, seed=7)
    eager, static = _MLP(5), _MLP(5)
    fwd = pt.jit.to_static(static)
    for i in range(3):
        for model in (eager, fwd):
            model.zero_grad(set_to_none=True)
            F.cross_entropy(model(xs[i]), ys[i]).backward()
        for (name, p), q in zip(eager.named_parameters(),
                                static.parameters()):
            assert q.grad is not None and q.grad.abs().sum() > 0, name
            torch.testing.assert_close(q.grad, p.grad, rtol=1e-6,
                                       atol=1e-7, msg=name)
    prog, = static.forward.programs.values()
    assert prog.built and not prog.internal_backward
    assert {id(t) for t in prog.leaves} == {id(p)
                                            for p in static.parameters()}


def test_forward_only_grads_flow_to_a_differentiable_argument():
    """A tensor argument that requires grad is an input of the program: its
    grad (and what lies behind it) comes through, and the parameters behind
    it are not taken for the program's leaves."""
    emb = pt.nn.Linear(8, 8, device="cpu", generator=pt.make_generator(2))
    head = _MLP(6)
    fwd = pt.jit.to_static(head)
    xs, ys = _batches(3, seed=8)
    for i in range(3):
        emb.zero_grad(set_to_none=True)
        head.zero_grad(set_to_none=True)
        F.cross_entropy(fwd(emb(xs[i])), ys[i]).backward()
        got = [p.grad.clone() for p in (*emb.parameters(),
                                        *head.parameters())]
        emb.zero_grad(set_to_none=True)
        head.zero_grad(set_to_none=True)
        F.cross_entropy(_MLP.forward(head, emb(xs[i])), ys[i]).backward()
        for g, p in zip(got, (*emb.parameters(), *head.parameters())):
            torch.testing.assert_close(g, p.grad, rtol=1e-6, atol=1e-7)
    prog, = head.forward.programs.values()
    assert {id(t) for t in prog.leaves} == {id(p) for p in head.parameters()}


def test_differentiating_a_self_backward_step_raises():
    """A step that runs its own backward: on every call its output carries
    a grad node whose backward raises the reference's error."""
    model, step = _compiled(seed=9)
    xs, ys = _batches(3, seed=9)
    for i in range(3):
        loss = step(xs[i], ys[i])
        assert loss.requires_grad
        with pytest.raises(RuntimeError, match="runs its own backward"):
            (loss * 2.0).backward()
    prog, = step.static_function.programs.values()
    assert prog.internal_backward and prog.leaves == []


def test_lr_tensor_follows_the_parameters_device():
    """Parameters that lie on another device than the lr tensor (as when
    they moved to the card after the optimizer was built; here the meta
    device stands in for it) take the lr tensor along at the next step,
    and the scheduler is rebound to the moved tensor."""
    params = [torch.nn.Parameter(torch.empty(4, 3, device="meta"))]
    params[0].grad = torch.empty(4, 3, device="meta")
    sched = pt.optimizer.lr.LinearWarmup(learning_rate=0.1, warmup_steps=4,
                                         start_lr=0.0, end_lr=0.1)
    opt = pt.optimizer.SGD(learning_rate=sched, parameters=[])
    opt._parameter_list = params
    host_lr = opt._learning_rate
    assert host_lr.device.type == "cpu" and sched._lr_tensor is host_lr
    opt.step()
    assert opt._learning_rate.device.type == "meta"
    assert sched._lr_tensor is opt._learning_rate
    sched.step()
    assert float(host_lr) == 0.0        # the old tensor is left behind
    assert sched._lr_tensor is opt._learning_rate


def test_parameters_on_two_devices_raise():
    model = _MLP(11)
    model.fc1.weight = torch.nn.Parameter(
        torch.empty(model.fc1.weight.shape, device="meta"))
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    with pytest.raises(ValueError, match="more than one device"):
        opt.step()
