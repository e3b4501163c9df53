"""The port's paddle.metric against the reference's on the host: the same
numpy predictions and labels give the same values exactly (``accuracy``
within float32 rounding of a mean), with ties in the logits, top-k,
streaming updates over batches and tensors in bfloat16."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402

torch.set_num_threads(1)


def _logits(seed, n=37, c=6, ties=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c).astype("float32")
    if ties:  # rows with equal logits: the stable sort picks the first
        x = np.round(x)
    return x, rng.randint(0, c, (n,)).astype("int64")


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("ties", [False, True])
def test_accuracy_matches_reference(k, ties):
    x, y = _logits(k, ties=ties)
    for lab in (y, y[:, None]):
        r = paddle.metric.accuracy(paddle.to_tensor(x), paddle.to_tensor(lab),
                                   k=k)
        p = pt.metric.accuracy(torch.tensor(x), torch.tensor(lab), k=k)
        assert p.dtype == torch.float32 and p.dim() == 0
        assert p.item() == pytest.approx(float(r.item()), abs=1e-7)


def test_accuracy_ties_pick_the_first_index():
    x = torch.tensor([[1.0, 1.0, 0.0], [0.0, 2.0, 2.0]])
    assert pt.metric.accuracy(x, torch.tensor([0, 1])).item() == 1.0
    assert pt.metric.accuracy(x, torch.tensor([1, 2])).item() == 0.0


@pytest.mark.parametrize("topk", [(1,), (1, 3), (2, 4)])
def test_streaming_accuracy_matches_reference(topk):
    rm = paddle.metric.Accuracy(topk=topk)
    pm = pt.metric.Accuracy(topk=topk)
    assert pm.name() == rm.name()
    for seed in range(3):
        x, y = _logits(10 + seed, ties=seed == 1)
        rc = rm.compute(paddle.to_tensor(x), paddle.to_tensor(y))
        pc = pm.compute(torch.tensor(x), torch.tensor(y))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(rc.numpy()))
        assert pm.update(pc) == rm.update(rc)
    assert pm.accumulate() == rm.accumulate()
    pm.reset()
    assert pm.accumulate() == (0.0 if len(topk) == 1 else [0.0] * len(topk))


def test_accuracy_reads_bfloat16_tensors():
    x, y = _logits(3)
    m = pt.metric.Accuracy()
    ref = pt.metric.Accuracy()
    m.update(m.compute(torch.tensor(x).bfloat16(), torch.tensor(y)))
    ref.update(ref.compute(torch.tensor(x).bfloat16().float(),
                           torch.tensor(y)))
    assert m.accumulate() == ref.accumulate()


def _binary(seed, n=200):
    rng = np.random.RandomState(seed)
    return rng.rand(n).astype("float32"), rng.randint(0, 2, n).astype("int64")


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_match_reference(cls):
    rm, pm = getattr(paddle.metric, cls)(), getattr(pt.metric, cls)()
    assert pm.name() == rm.name()
    for seed in range(3):
        p, y = _binary(seed)
        rm.update(paddle.to_tensor(p), paddle.to_tensor(y))
        pm.update(torch.tensor(p), torch.tensor(y))
    assert pm.accumulate() == rm.accumulate()
    pm.reset()
    assert pm.accumulate() == 0.0


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_matches_reference(two_columns):
    rm, pm = paddle.metric.Auc(), pt.metric.Auc()
    for seed in range(3):
        p, y = _binary(seed)
        if two_columns:
            p = np.stack([1 - p, p], 1)
        rm.update(paddle.to_tensor(p), paddle.to_tensor(y))
        pm.update(torch.tensor(p), torch.tensor(y))
    assert pm.accumulate() == pytest.approx(rm.accumulate(), abs=1e-12)
    assert 0.3 < pm.accumulate() < 0.7
