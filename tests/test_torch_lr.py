"""The port's learning-rate schedulers against the JAX reference's: every
scheduler's lr over 30 steps (to 1e-7), a state_dict round trip, and the
optimizer's f32 lr tensor following ``scheduler.step()`` in place."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle

import paddle_tpu_torch as pt

torch.set_num_threads(1)

STEPS = 30

# name -> kwargs, the same for both packages
SCHEDULERS = {
    "NoamDecay": dict(d_model=64, warmup_steps=5, learning_rate=2.0),
    "PiecewiseDecay": dict(boundaries=[5, 12, 20], values=[0.1, 0.05, 0.01,
                                                           0.001]),
    "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
    "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.2),
    "PolynomialDecay": dict(learning_rate=0.5, decay_steps=12, end_lr=0.01,
                            power=2.0),
    "PolynomialDecay_cycle": dict(learning_rate=0.5, decay_steps=7,
                                  end_lr=0.01, cycle=True),
    "LinearWarmup": dict(learning_rate=0.3, warmup_steps=8, start_lr=0.0,
                         end_lr=0.3),
    "ExponentialDecay": dict(learning_rate=0.5, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.5, milestones=[4, 11, 25],
                           gamma=0.5),
    "StepDecay": dict(learning_rate=0.5, step_size=6, gamma=0.3),
    "LambdaDecay": dict(learning_rate=0.5, lr_lambda=lambda e: 0.95 ** e),
    "MultiplicativeDecay": dict(learning_rate=0.5,
                                lr_lambda=lambda e: 0.9 if e % 3 else 1.1),
    "ReduceOnPlateau": dict(learning_rate=0.5, factor=0.5, patience=2,
                            cooldown=1),
    "CosineAnnealingDecay": dict(learning_rate=0.5, T_max=10, eta_min=0.01),
    "OneCycleLR": dict(max_learning_rate=0.5, total_steps=25),
    "OneCycleLR_linear": dict(max_learning_rate=0.5, total_steps=25,
                              anneal_strategy="linear"),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.2,
                     step_size_up=4, step_size_down=6),
    "CyclicLR_triangular2": dict(base_learning_rate=0.01,
                                 max_learning_rate=0.2, step_size_up=3,
                                 mode="triangular2"),
    "CyclicLR_exp_range": dict(base_learning_rate=0.01,
                               max_learning_rate=0.2, step_size_up=3,
                               mode="exp_range", exp_gamma=0.95),
}

# ReduceOnPlateau's metric per step: falls, then plateaus, then falls
METRICS = [1.0 - 0.05 * min(i, 8) - 0.02 * max(i - 20, 0)
           for i in range(STEPS)]


def _make(module, key):
    cls = getattr(module.optimizer.lr, key.split("_")[0])
    return cls(**SCHEDULERS[key])


def _lrs(sched, key):
    out = [sched()]
    for i in range(STEPS):
        if key == "ReduceOnPlateau":
            sched.step(METRICS[i])
        else:
            sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize("key", sorted(SCHEDULERS))
def test_scheduler_matches_reference(key):
    want = _lrs(_make(paddle, key), key)
    got = _lrs(_make(pt, key), key)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)
    assert len(set(np.round(got, 9))) > 1, "the schedule never moved"


def test_linear_warmup_wraps_a_scheduler():
    def make(m):
        inner = m.optimizer.lr.CosineAnnealingDecay(0.4, T_max=12)
        return m.optimizer.lr.LinearWarmup(inner, warmup_steps=5,
                                           start_lr=0.0, end_lr=0.4)
    np.testing.assert_allclose(_lrs(make(pt), "LinearWarmup"),
                               _lrs(make(paddle), "LinearWarmup"),
                               rtol=1e-7, atol=1e-7)


def test_state_dict_round_trip():
    sched = pt.optimizer.lr.StepDecay(0.5, step_size=3, gamma=0.5)
    for _ in range(7):
        sched.step()
    sd = sched.state_dict()
    assert "_lr_tensor" not in sd and sd["last_epoch"] == 7
    ref = paddle.optimizer.lr.StepDecay(0.5, step_size=3, gamma=0.5)
    for _ in range(7):
        ref.step()
    assert sd == ref.state_dict()
    fresh = pt.optimizer.lr.StepDecay(0.5, step_size=3, gamma=0.5)
    fresh.set_state_dict(sd)
    assert fresh() == sched() and fresh.last_epoch == 7
    fresh.step()
    sched.step()
    assert fresh() == sched()
    # the lambda schedulers leave their lambda out
    lam = pt.optimizer.lr.LambdaDecay(0.5, lr_lambda=lambda e: 0.9 ** e)
    assert "lr_lambda" not in lam.state_dict()


def test_optimizer_lr_tensor_follows_the_scheduler():
    p = torch.nn.Parameter(torch.ones(3))
    sched = pt.optimizer.lr.ExponentialDecay(0.5, gamma=0.5)
    opt = pt.optimizer.SGD(learning_rate=sched, parameters=[p])
    lr_tensor = opt._learning_rate
    assert lr_tensor.dtype == torch.float32 and float(lr_tensor) == 0.5
    for want in (0.25, 0.125):
        sched.step()
        # written in place: the tensor a captured step holds sees it
        assert opt._learning_rate is lr_tensor
        assert float(lr_tensor) == want and opt.get_lr() == want
    p.grad = torch.ones(3)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), [0.875] * 3)
    sd = opt.state_dict()
    assert sd["LR_Scheduler"]["last_epoch"] == 2
    sched2 = pt.optimizer.lr.ExponentialDecay(0.5, gamma=0.5)
    opt2 = pt.optimizer.SGD(learning_rate=sched2, parameters=[p])
    opt2.set_state_dict(sd)
    assert float(opt2._learning_rate) == 0.125
