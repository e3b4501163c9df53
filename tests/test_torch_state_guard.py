"""The fused ops' degenerate-weight guard after a weight is overwritten
(ROADMAP C3), and the optimizers' refusal of a ParamAttr learning-rate
factor (ROADMAP C-ref-14), on the host.

fused_residual_ln and fused_conv_bn route a weight with a channel inside
the |w| <= tol band through plain autograd, since their custom backwards
would freeze it. The verdict is cached on the parameter. A zero channel
that arrives through ``set_state_dict``/``load_dict``, torch's
``load_state_dict``, an in-place write (``zero_``, ``copy_``,
``p.data[...] =``, ``paddle.assign(x, output=p)``) or
``load_numpy_state_dict`` must get plain autograd's gradient (within
1e-5, and not 0); an optimizer's own update keeps the verdict without a
new check; a to_static step is built again when a load changes a
verdict, and only then.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import _param_guard
from paddle_tpu_torch.ops import fused_conv_bn as fcb
from paddle_tpu_torch.ops import fused_residual_ln as rln

torch.set_num_threads(1)

C = 8
ZERO = 3
DW_TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_host():
    before = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(before)


class Block(pt.nn.Layer):
    """layer_norm(x + y) through fused_residual_ln."""

    def __init__(self):
        super().__init__()
        self.ln = pt.nn.LayerNorm(C)

    def forward(self, x, y):
        return rln.fused_residual_ln(x, y, self.ln.weight, self.ln.bias)


def _xy(seed=0):
    rng = np.random.RandomState(seed)
    return (torch.tensor(rng.randn(4, 5, C).astype("float32")),
            torch.tensor(rng.randn(4, 5, C).astype("float32")))


def _plain_dw(weight, bias, x, y, ct):
    """plain autograd's grad of the weight: layer_norm(x + y) * w + b."""
    w = weight.detach().clone().requires_grad_()
    z = x + y
    mean = z.mean(-1, keepdim=True)
    var = z.var(-1, correction=0, keepdim=True)
    out = (z - mean) * torch.rsqrt(var + 1e-5) * w + bias.detach()
    out.backward(ct)
    return w.grad


def _dw(block, x, y, ct):
    block.ln.weight.grad = None
    block(x, y).backward(ct)
    return block.ln.weight.grad


def _zeroed(block):
    w = block.ln.weight.detach().clone()
    w[ZERO] = 0.0
    return w


def _warm(block, x, y, ct):
    _dw(block, x, y, ct)
    assert block.ln.weight._degen_cache == (rln._W_TOL, False)


def _check_after(block, x, y, ct):
    w = block.ln.weight
    got = _dw(block, x, y, ct)
    want = _plain_dw(w, block.ln.bias, x, y, ct)
    assert abs(float(want[ZERO])) > 1e-3
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=DW_TOL,
                               rtol=DW_TOL)
    assert w._degen_cache == (rln._W_TOL, True)


def _load_set_state_dict(block):
    sd = {k: v.detach().clone() for k, v in block.state_dict().items()}
    sd["ln.weight"] = _zeroed(block)
    assert block.set_state_dict(sd) == ([], [])


def _load_load_dict(block):
    block.load_dict({"ln.weight": _zeroed(block).numpy()})


def _load_torch(block):
    block.load_state_dict({"ln.weight": _zeroed(block),
                           "ln.bias": block.ln.bias.detach().clone()})


def _load_numpy(block):
    pt.load_numpy_state_dict(block, {"ln.weight": _zeroed(block).numpy()},
                             strict=False)


def _zero_(block):
    with torch.no_grad():
        block.ln.weight[ZERO].zero_()


def _copy_(block):
    with torch.no_grad():
        block.ln.weight.copy_(_zeroed(block))


def _data_write(block):
    block.ln.weight.data[ZERO] = 0.0


def _assign(block):
    pt.assign(_zeroed(block), output=block.ln.weight)


WRITES = {"set_state_dict": _load_set_state_dict,
          "load_dict": _load_load_dict, "load_state_dict": _load_torch,
          "load_numpy_state_dict": _load_numpy, "zero_": _zero_,
          "copy_": _copy_, "data_write": _data_write, "assign": _assign}


@pytest.mark.parametrize("write", sorted(WRITES))
def test_zero_channel_after_a_write_gets_plain_autograds_grad(write):
    block = Block()
    x, y = _xy()
    ct = torch.tensor(np.random.RandomState(1).randn(4, 5, C)
                      .astype("float32"))
    _warm(block, x, y, ct)
    gen = _param_guard.generation()
    WRITES[write](block)
    _check_after(block, x, y, ct)
    assert _param_guard.generation() == gen + 1


def test_write_that_keeps_the_verdict_does_not_bump_the_generation():
    block = Block()
    x, y = _xy()
    ct = torch.ones(4, 5, C)
    _warm(block, x, y, ct)
    gen = _param_guard.generation()
    block.set_state_dict({"ln.weight": torch.full((C,), 2.0)})
    with torch.no_grad():
        block.ln.weight.mul_(0.5)
    _dw(block, x, y, ct)
    assert block.ln.weight._degen_cache == (rln._W_TOL, False)
    assert _param_guard.generation() == gen


def test_optimizer_update_keeps_the_verdict_without_a_check():
    """An optimizer's in-place update re-stamps the verdict: no sync per
    parameter per step, and the verdict stays (sticky by design)."""
    block = Block()
    x, y = _xy()
    ct = torch.ones(4, 5, C)
    _warm(block, x, y, ct)
    opt = pt.optimizer.Momentum(learning_rate=0.1,
                                parameters=block.parameters())
    w = block.ln.weight
    v0 = w._version
    _dw(block, x, y, ct)
    opt.step()
    assert w._version > v0 and w._degen_stamp == w._version
    assert _param_guard.fresh([w]) == [w]


def test_fused_conv_bn_gamma_after_a_load():
    """fused_conv_bn's gamma guard reads the same cache: a zero gamma
    channel loaded into a warm BatchNorm gets plain autograd's grad."""
    rng = np.random.RandomState(2)
    conv = pt.nn.Conv2D(3, C, 3, padding=1, bias_attr=False)
    bn = pt.nn.BatchNorm2D(C)
    x = torch.tensor(rng.randn(2, 3, 6, 6).astype("float32"))
    ct = torch.tensor(rng.randn(2, C, 6, 6).astype("float32"))

    def dgamma(fn):
        bn.weight.grad = None
        fn().backward(ct)
        return bn.weight.grad.clone()

    def fused():
        return fcb.fused_conv_bn(x, conv.weight, bn.weight, bn.bias,
                                 training=True, padding=1)

    def plain():
        return bn(conv(x))
    dgamma(fused)
    assert bn.weight._degen_cache == (fcb._GAMMA_TOL, False)
    gamma = bn.weight.detach().clone()
    gamma[ZERO] = 0.0
    bn.set_state_dict({"weight": gamma})
    got, want = dgamma(fused), dgamma(plain)
    assert bn.weight._degen_cache == (fcb._GAMMA_TOL, True)
    assert abs(float(want[ZERO])) > 1e-3
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=DW_TOL,
                               rtol=DW_TOL)


def test_to_static_rebuilds_only_when_a_verdict_changes():
    block = Block()
    opt = pt.optimizer.SGD(learning_rate=0.0, parameters=block.parameters())
    x, y = _xy()

    @pt.jit.to_static
    def step(x, y):
        loss = block(x, y).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    for _ in range(3):
        step(x, y)
    assert len(step.programs) == 1
    block.set_state_dict({"ln.weight": torch.full((C,), 2.0)})
    step(x, y)
    assert len(step.programs) == 1           # verdict unchanged
    block.set_state_dict({"ln.weight": _zeroed(block)})
    step(x, y)
    assert len(step.programs) == 2           # verdict changed: rebuilt
    prog = step.programs[max(step.programs, key=lambda k: k[-1])]
    assert prog.stage >= 1
    step(x, y)
    assert len(step.programs) == 2


# -- C-ref-14 ---------------------------------------------------------------------
OPTIMIZERS = [n for n in pt.optimizer.__all__ if n not in ("Optimizer", "lr")]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_param_attr_learning_rate_factor_raises(name):
    cls = getattr(pt.optimizer, name)
    layer = pt.nn.Linear(3, 2, weight_attr=pt.ParamAttr(learning_rate=0.5))
    with pytest.raises(NotImplementedError, match="C-ref-14"):
        cls(learning_rate=0.1, parameters=layer.parameters())
    plain = pt.nn.Linear(3, 2, weight_attr=pt.ParamAttr(learning_rate=1.0))
    cls(learning_rate=0.1, parameters=plain.parameters())
