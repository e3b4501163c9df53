"""The port's amp against the JAX reference's: the op lists and the cast
decisions, a small GPT with f32 weights under ``auto_cast(dtype=
"bfloat16")`` (loss and every grad within 2e-2 relative L2), and
GradScaler over a scripted run with injected non-finite grads (scale,
good/bad counters, parameters and accumulators step by step)."""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as RefTensor
from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT

import paddle_tpu_torch as pt
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

torch.set_num_threads(1)

# the modules (each package's amp/__init__ exports the function of the
# same name)
ref_amp = importlib.import_module("paddle_tpu.amp.auto_cast")
port_amp = importlib.import_module("paddle_tpu_torch.amp.auto_cast")

OPS = sorted(ref_amp.WHITE_LIST | ref_amp.BLACK_LIST
             | {"embedding", "dropout", "fused_ffn", "gelu"})


def test_lists_equal_the_reference():
    assert port_amp.WHITE_LIST == ref_amp.WHITE_LIST
    assert port_amp.BLACK_LIST == ref_amp.BLACK_LIST


@pytest.mark.parametrize("kw", [
    dict(), dict(level="O2"),
    dict(custom_white_list=["gelu"], custom_black_list=["linear"]),
    dict(level="O2", custom_black_list=["embedding"]),
    dict(enable=False),
], ids=["O1", "O2", "custom", "O2_custom", "off"])
def test_cast_decisions_equal_the_reference(kw):
    with ref_amp.auto_cast(**kw), port_amp.auto_cast(**kw):
        assert port_amp.is_enabled() == ref_amp.is_enabled()
        for op in OPS:
            assert port_amp.should_cast_to_low(op) == \
                ref_amp.should_cast_to_low(op), op
            assert port_amp.should_cast_to_high(op) == \
                ref_amp.should_cast_to_high(op), op
    assert not port_amp.is_enabled()


def test_amp_cast_casts_floating_inputs_only():
    x = torch.ones(2, 3, requires_grad=True)
    ids = torch.ones(2, dtype=torch.int64)
    with pt.amp.auto_cast():
        lo = port_amp.amp_cast("linear", x, ids, None)
        hi = port_amp.amp_cast("layer_norm", x.bfloat16())
        same = port_amp.amp_cast("gelu", x)
    assert lo[0].dtype == torch.bfloat16 and lo[1] is ids and lo[2] is None
    assert hi[0].dtype == torch.float32 and same[0] is x
    assert port_amp.amp_cast("linear", x)[0] is x        # outside auto_cast
    lo[0].sum().backward()
    assert x.grad.dtype == torch.float32                  # the cast is differentiable


CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
           max_position_embeddings=64, dropout=0.0)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_gpt_under_auto_cast_matches_reference():
    paddle.seed(0)
    ref = RefGPT(RefConfig(**CFG))
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    pt.load_numpy_state_dict(model, arrays)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, CFG["vocab_size"], (2, 33))
    x, y = ids[:, :-1].astype("int32"), ids[:, 1:].astype("int64")
    with paddle.amp.auto_cast(dtype="bfloat16"):
        loss_r = ref(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    loss_r.backward()
    with pt.amp.auto_cast(dtype="bfloat16"):
        loss = model(torch.from_numpy(x), labels=torch.from_numpy(y))
    loss.backward()
    # the casts happened: the f32 loss differs from the bf16-compute one
    with torch.no_grad():
        loss32 = model(torch.from_numpy(x), labels=torch.from_numpy(y))
    assert loss.dtype == torch.float32 and float(loss) != float(loss32)
    assert _rel_l2(np.float32(float(loss)), np.float32(float(loss_r))) \
        <= 2e-2
    ref_grads = dict(ref.named_parameters())
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        gap = _rel_l2(p.grad.numpy(), np.asarray(ref_grads[name].grad._val))
        assert gap <= 2e-2, (name, gap)


def _scaler_run(module, grads, inf_steps):
    """Adam on two parameters for len(grads) steps; each step's grads are
    the given ones times the current scale (inf at ``inf_steps``). Returns
    per step (scale, good, bad, params, moment1s)."""
    rng = np.random.RandomState(9)
    inits = [rng.randn(4, 3).astype("float32"),
             rng.randn(3).astype("float32")]
    if module is paddle:
        params = []
        for a in inits:
            p = paddle.create_parameter(list(a.shape), "float32")
            p.set_value(a)
            params.append(p)
    else:
        params = [torch.nn.Parameter(torch.tensor(a)) for a in inits]
    opt = module.optimizer.Adam(learning_rate=0.01, parameters=params)
    scaler = module.amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                   incr_every_n_steps=2,
                                   decr_every_n_nan_or_inf=1)
    out = []
    for i, step_grads in enumerate(grads):
        scale = float(np.asarray(scaler._scale._val if module is paddle
                                 else scaler._scale))
        for p, g in zip(params, step_grads):
            g = g * np.float32(scale)
            if i in inf_steps and p is params[1]:
                g = g.copy()
                g[0] = np.inf
            p.grad = (RefTensor(jnp.asarray(g), stop_gradient=True)
                      if module is paddle else torch.from_numpy(g))
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()

        def arr(t):
            return np.array(t._val if module is paddle else t.detach())
        m1 = [arr(opt._accumulators["moment1"][id(p)]) for p in params]
        out.append((float(arr(scaler._scale)), int(arr(scaler._good_steps)),
                    int(arr(scaler._bad_steps)), [arr(p) for p in params],
                    m1))
    return out


def test_grad_scaler_matches_reference_with_injected_infs():
    rng = np.random.RandomState(2)
    grads = [[rng.randn(4, 3).astype("float32"),
              rng.randn(3).astype("float32")] for _ in range(7)]
    inf_steps = (0, 3, 4)     # the first (accumulators created that step)
    want = _scaler_run(paddle, grads, inf_steps)
    got = _scaler_run(pt, grads, inf_steps)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[:3] == w[:3], (i, g[:3], w[:3])
        for a, b in zip(g[3] + g[4], w[3] + w[4]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {i}")
    # skipped steps leave parameters and accumulators as they were
    for i in inf_steps:
        before = got[i - 1] if i else None
        for k in (3, 4):
            for a, b in zip(got[i][k], before[k] if before else
                            [None] * 2):
                if b is None:
                    # step 0: the moments are back at their initial zeros
                    assert k == 3 or not a.any()
                else:
                    np.testing.assert_array_equal(a, b)
    scales = [g[0] for g in got]
    assert scales[0] == 2.0 ** 9 and min(scales) < max(scales)


def test_grad_scaler_state_dict_round_trip():
    p = torch.nn.Parameter(torch.ones(2))
    scaler = pt.amp.GradScaler(init_loss_scaling=8.0)
    opt = pt.optimizer.SGD(parameters=[p])
    p.grad = torch.tensor([float("inf"), 1.0])
    scaler.step(opt)
    scaler.update()
    sd = scaler.state_dict()
    assert float(sd["scale"]) == 4.0 and int(sd["bad_steps"]) == 0
    other = pt.amp.GradScaler()
    scale_tensor = other._scale
    other.load_state_dict(sd)
    assert other._scale is scale_tensor and float(other._scale) == 4.0
    assert torch.equal(p.detach(), torch.ones(2))
