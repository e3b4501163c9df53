"""The port's gradient clips against the JAX reference's: each clip on the
same random grads (to 1e-6), and a small GPT taking 3 AdamW steps with
ClipGradByGlobalNorm(1.0) on both sides from carried weights (losses to
1e-5, every parameter to 1e-5 relative L2)."""
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

CLIPS = {
    "ClipGradByValue": dict(max=0.5),
    "ClipGradByValue_min": dict(max=0.8, min=-0.3),
    "ClipGradByNorm": dict(clip_norm=1.5),
    "ClipGradByGlobalNorm": dict(clip_norm=2.0),
    "ClipGradByGlobalNorm_loose": dict(clip_norm=1e3),   # no clipping
}


def _pairs(seed):
    rng = np.random.RandomState(seed)
    shapes = [(8, 5), (5,), (3, 4, 2), (7,)]
    grads = [rng.randn(*s).astype("float32") for s in shapes]
    ref, port = [], []
    for i, g in enumerate(grads):
        rp = paddle.create_parameter(list(g.shape), "float32")
        pp = torch.nn.Parameter(torch.zeros(g.shape))
        if i == 3:       # a parameter that opts out of clipping
            rp.need_clip = False
            pp.need_clip = False
        ref.append((rp, RefTensor(jnp.asarray(g), stop_gradient=True)))
        port.append((pp, torch.from_numpy(g)))
    return grads, ref, port


@pytest.mark.parametrize("key", sorted(CLIPS))
def test_clip_matches_reference(key):
    grads, ref, port = _pairs(3)
    name = key.split("_")[0]
    want = getattr(paddle.nn, name)(**CLIPS[key])(ref)
    got = getattr(pt.nn, name)(**CLIPS[key])(port)
    assert [p for p, _ in got] == [p for p, _ in port]
    for (_, g), (_, w), raw in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w._val),
                                   rtol=1e-6, atol=1e-6)
    # the opted-out grad is untouched, and p.grad is never written
    np.testing.assert_array_equal(got[3][1].numpy(), grads[3])
    assert all(p.grad is None for p, _ in port)


def test_clip_is_a_device_computation():
    """No Python number is read from a grad: the scale stays a tensor (a
    captured step could not read one)."""
    _, _, port = _pairs(4)
    clip = pt.nn.ClipGradByGlobalNorm(0.1)
    got = clip(port)
    norm = torch.linalg.vector_norm(torch.cat([g.reshape(-1)
                                               for _, g in got[:3]]))
    np.testing.assert_allclose(float(norm), 0.1, rtol=1e-6)


CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
           max_position_embeddings=64, dropout=0.0)


def _batches(steps=3, seed=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, CFG["vocab_size"], (steps, 2, 33))
    return ids[:, :, :-1].astype("int32"), ids[:, :, 1:].astype("int64")


def test_gpt_adamw_with_global_norm_clip_matches_reference():
    paddle.seed(0)
    ref = RefGPT(RefConfig(**CFG))
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    ref_opt = paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=ref.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    model = GPTForCausalLM(GPTConfig(**CFG), device="cpu")
    pt.load_numpy_state_dict(model, arrays)
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    xs, ys = _batches()
    for x, y in zip(xs, ys):
        loss_r = ref(paddle.to_tensor(x), labels=paddle.to_tensor(y))
        loss_r.backward()
        ref_opt.step()
        ref_opt.clear_grad()
        loss = model(torch.from_numpy(x), labels=torch.from_numpy(y))
        loss.backward()
        # the clip binds: the global norm of the raw grads is above 1
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in model.parameters()]))
        assert float(norm) > 1.0
        opt.step()
        opt.clear_grad()
        np.testing.assert_allclose(float(loss.detach()), float(loss_r),
                                   rtol=1e-5, atol=1e-5)
    ref_params = dict(ref.named_parameters())
    h = CFG["hidden_size"]
    for name, p in model.named_parameters():
        got, want = p.detach().numpy(), np.asarray(ref_params[name]._val)
        if name.endswith("qkv.bias"):
            # the key bias has a zero gradient (softmax is invariant to a
            # shift of every logit of a row): its grads are rounding noise
            # in both packages, which Adam's normalisation turns into
            # full-size steps of either sign; q and v must agree
            keep = np.r_[0:h, 2 * h:3 * h]
            got, want = got[keep], want[keep]
        gap = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert gap <= 1e-5, (name, gap)
