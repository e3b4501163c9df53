"""The port's losses (nn.functional and the loss layers) against the
reference's on the host.

Every loss of the reference runs on the same numpy inputs (from a seeded
RandomState) in both packages, under each reduction it takes: the values
within VALUE_TOL and the grads of the floating inputs (of the sum of the
output) within GRAD_TOL, both float32 rounding over short sums. The loss
layers hold their options and call the same functions; they are checked
on one case each.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional as RF  # noqa: E402

import paddle_tpu_torch.nn as pnn  # noqa: E402
import paddle_tpu_torch.nn.functional as PF  # noqa: E402

torch.set_num_threads(1)

VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _f(*shape, seed=0, lo=None, hi=None):
    r = _rng(seed)
    if lo is not None:
        return r.uniform(lo, hi, shape).astype("float32")
    return r.randn(*shape).astype("float32")


def _i(hi, *shape, seed=1):
    return _rng(seed).randint(0, hi, shape).astype("int64")


def _pm1(*shape, seed=2):
    return (2 * _rng(seed).randint(0, 2, shape) - 1).astype("float32")


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype("float32")


def _soft(n, c, seed=3):
    p = _rng(seed).rand(n, c).astype("float32") + 0.1
    return (p / p.sum(-1, keepdims=True)).astype("float32")


def _ce_labels_with_ignored():
    y = _i(5, 8)
    y[[1, 6]] = -100
    return y


# name: (function, inputs, kwargs, indices of the inputs to differentiate)
CASES = {
    "cross_entropy": ("cross_entropy", lambda: [_f(8, 5), _i(5, 8)], {},
                      [0]),
    "cross_entropy_ignore": ("cross_entropy", lambda: [
        _f(8, 5), _ce_labels_with_ignored()], {}, [0]),
    "cross_entropy_weight": ("cross_entropy", lambda: [
        _f(8, 5), _i(5, 8), _f(5, seed=4, lo=0.5, hi=2.0)], {}, [0]),
    "cross_entropy_soft": ("cross_entropy", lambda: [
        _f(8, 5), _soft(8, 5)], {"soft_label": True}, [0]),
    "cross_entropy_probs": ("cross_entropy", lambda: [
        _soft(8, 5, seed=5), _i(5, 8)], {"use_softmax": False}, [0]),
    "cross_entropy_axis1": ("cross_entropy", lambda: [
        _f(4, 5, 3), _i(5, 4, 1, 3)], {"axis": 1}, [0]),
    "softmax_with_cross_entropy": ("softmax_with_cross_entropy", lambda: [
        _f(8, 5), _i(5, 8, 1)], {}, [0]),
    "softmax_with_cross_entropy_soft": ("softmax_with_cross_entropy",
                                        lambda: [_f(8, 5), _soft(8, 5)],
                                        {"soft_label": True}, [0]),
    "binary_cross_entropy": ("binary_cross_entropy", lambda: [
        _f(6, 3, lo=0.05, hi=0.95), _i(2, 6, 3).astype("float32")], {}, [0]),
    "binary_cross_entropy_weight": ("binary_cross_entropy", lambda: [
        _f(6, 3, lo=0.05, hi=0.95), _i(2, 6, 3).astype("float32"),
        _f(6, 3, seed=7, lo=0.5, hi=1.5)], {}, [0]),
    "bce_with_logits": ("binary_cross_entropy_with_logits", lambda: [
        _f(6, 3) * 3, _i(2, 6, 3).astype("float32")], {}, [0]),
    "bce_with_logits_pos_weight": (
        "binary_cross_entropy_with_logits",
        lambda: [_f(6, 3) * 3, _i(2, 6, 3).astype("float32")],
        {"weight": _f(6, 3, seed=7, lo=0.5, hi=1.5),
         "pos_weight": _f(3, seed=8, lo=0.5, hi=3.0)}, [0]),
    "nll_loss": ("nll_loss", lambda: [_log_softmax(_f(8, 5)), _i(5, 8)], {},
                 [0]),
    "nll_loss_weight": ("nll_loss", lambda: [
        _log_softmax(_f(8, 5)), _i(5, 8), _f(5, seed=4, lo=0.5, hi=2.0)],
        {}, [0]),
    "mse_loss": ("mse_loss", lambda: [_f(4, 3), _f(4, 3, seed=5)], {},
                 [0, 1]),
    "l1_loss": ("l1_loss", lambda: [_f(4, 3), _f(4, 3, seed=5)], {}, [0, 1]),
    "smooth_l1_loss": ("smooth_l1_loss", lambda: [
        _f(4, 3) * 2, _f(4, 3, seed=5)], {"delta": 0.7}, [0]),
    "kl_div": ("kl_div", lambda: [_log_softmax(_f(4, 5)), _soft(4, 5)], {},
               [0, 1]),
    "margin_ranking_loss": ("margin_ranking_loss", lambda: [
        _f(7), _f(7, seed=5), _pm1(7)], {"margin": 0.3}, [0, 1]),
    "hinge_embedding_loss": ("hinge_embedding_loss", lambda: [
        _f(7) * 2, _pm1(7)], {"margin": 0.8}, [0]),
    "cosine_embedding_loss": ("cosine_embedding_loss", lambda: [
        _f(5, 4), _f(5, 4, seed=5), _pm1(5)], {"margin": 0.1}, [0, 1]),
    "triplet_margin_loss": ("triplet_margin_loss", lambda: [
        _f(5, 4), _f(5, 4, seed=5), _f(5, 4, seed=6)], {}, [0, 1, 2]),
    "triplet_margin_loss_p1_swap": ("triplet_margin_loss", lambda: [
        _f(5, 4), _f(5, 4, seed=5), _f(5, 4, seed=6)],
        {"p": 1.0, "swap": True}, [0, 1, 2]),
    "soft_margin_loss": ("soft_margin_loss", lambda: [_f(6, 3), _pm1(6, 3)],
                         {}, [0]),
    "multi_label_soft_margin_loss": (
        "multi_label_soft_margin_loss",
        lambda: [_f(6, 3), _i(2, 6, 3).astype("float32")], {}, [0]),
    "multi_label_soft_margin_loss_weight": (
        "multi_label_soft_margin_loss",
        lambda: [_f(6, 3), _i(2, 6, 3).astype("float32"),
                 _f(3, seed=8, lo=0.5, hi=2.0)], {}, [0]),
    "poisson_nll_loss": ("poisson_nll_loss", lambda: [
        _f(6, 3), _i(5, 6, 3).astype("float32")], {}, [0]),
    "poisson_nll_loss_full": ("poisson_nll_loss", lambda: [
        _f(6, 3, lo=0.5, hi=3.0), _i(5, 6, 3).astype("float32")],
        {"log_input": False, "full": True}, [0]),
    "triplet_margin_with_distance_loss": (
        "triplet_margin_with_distance_loss",
        lambda: [_f(5, 4), _f(5, 4, seed=5), _f(5, 4, seed=6)],
        {"swap": True}, [0, 1, 2]),
}

REDUCTIONS = {
    "cross_entropy": ["mean", "sum", "none"],
    "binary_cross_entropy": ["mean", "sum", "none"],
    "bce_with_logits": ["mean", "sum", "none"],
    "nll_loss": ["mean", "sum", "none"],
    "mse_loss": ["mean", "sum", "none"],
    "l1_loss": ["mean", "sum", "none"],
    "kl_div": ["mean", "batchmean", "sum", "none"],
}

PARAMS = [(name, red) for name in sorted(CASES)
          for red in (REDUCTIONS.get(name) or [None])]


def _run_ref(fn, arrays, kwargs, diff):
    ts = [paddle.to_tensor(a, stop_gradient=i not in diff)
          for i, a in enumerate(arrays)]
    kwargs = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in kwargs.items()}
    out = getattr(RF, fn)(*ts, **kwargs)
    out.sum().backward()
    return out.numpy(), [np.asarray(ts[i].grad.numpy()) for i in diff]


def _run_port(fn, arrays, kwargs, diff):
    ts = [torch.tensor(a, requires_grad=i in diff)
          for i, a in enumerate(arrays)]
    kwargs = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
              for k, v in kwargs.items()}
    out = getattr(PF, fn)(*ts, **kwargs)
    out.sum().backward()
    return out.detach().numpy(), [ts[i].grad.numpy() for i in diff]


@pytest.mark.parametrize("name,reduction", PARAMS)
def test_loss_matches_reference(name, reduction):
    fn, make, kwargs, diff = CASES[name]
    kwargs = dict(kwargs)
    if reduction is not None:
        kwargs["reduction"] = reduction
    arrays = make()
    rv, rg = _run_ref(fn, arrays, kwargs, diff)
    pv, pg = _run_port(fn, arrays, kwargs, diff)
    assert pv.shape == rv.shape
    np.testing.assert_allclose(pv, rv, **VALUE_TOL)
    for p, r in zip(pg, rg):
        np.testing.assert_allclose(p, r, **GRAD_TOL)


def test_log_loss_square_error_focal_dice_match_reference():
    p, y = _f(6, 1, lo=0.05, hi=0.95), _i(2, 6, 1).astype("float32")
    for fn, args in (("log_loss", (p, y)), ("square_error_cost", (p, y)),
                     ("sigmoid_focal_loss", (_f(6, 3), _i(2, 6, 3)
                                             .astype("float32"))),
                     ("dice_loss", (_soft(6, 4), _i(4, 6, 1)))):
        rv, rg = _run_ref(fn, list(args), {}, [0])
        pv, pg = _run_port(fn, list(args), {}, [0])
        np.testing.assert_allclose(pv, rv, **VALUE_TOL)
        np.testing.assert_allclose(pg[0], rg[0], **GRAD_TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss_matches_reference(reduction):
    T, N, C, L = 12, 3, 5, 4
    lp = _log_softmax(_f(T, N, C))
    labels = _i(C - 1, N, L) + 1  # no blanks among the labels
    labels[1, 2] = labels[1, 1]   # a repeated label
    in_len = np.array([12, 10, 7], "int64")
    lab_len = np.array([4, 3, 2], "int64")
    kwargs = {"reduction": reduction}
    rt = paddle.to_tensor(lp, stop_gradient=False)
    rout = RF.ctc_loss(rt, paddle.to_tensor(labels), paddle.to_tensor(in_len),
                       paddle.to_tensor(lab_len), **kwargs)
    rout.sum().backward()
    pt_ = torch.tensor(lp, requires_grad=True)
    pout = PF.ctc_loss(pt_, torch.tensor(labels), torch.tensor(in_len),
                       torch.tensor(lab_len), **kwargs)
    pout.sum().backward()
    np.testing.assert_allclose(pout.detach().numpy(), rout.numpy(),
                               **VALUE_TOL)
    np.testing.assert_allclose(pt_.grad.numpy(), rt.grad.numpy(), **GRAD_TOL)


def test_margin_cross_entropy_matches_reference():
    x = np.tanh(_f(6, 5)).astype("float32")
    y = _i(5, 6)
    for ret in (False, True):
        r = RF.margin_cross_entropy(paddle.to_tensor(x), paddle.to_tensor(y),
                                    return_softmax=ret)
        p = PF.margin_cross_entropy(torch.tensor(x), torch.tensor(y),
                                    return_softmax=ret)
        for a, b in zip(p if ret else [p], r if ret else [r]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **VALUE_TOL)
    # a mesh axis name resolves to this rank's group on the global mesh's
    # axis (ROADMAP C9); the one-rank default mesh has no "mp" axis
    with pytest.raises(ValueError, match="no axis 'mp'"):
        PF.margin_cross_entropy(torch.tensor(x), torch.tensor(y),
                                group="mp")


def test_hsigmoid_loss_matches_reference():
    x, y = _f(6, 4), _i(7, 6)
    w, b = _f(6, 4, seed=9), _f(6, seed=10)
    for bias in (None, b):
        args = [x, y, 7, w] + ([bias] if bias is not None else [])
        r = RF.hsigmoid_loss(*[paddle.to_tensor(a) if isinstance(a, np.ndarray)
                               else a for a in args])
        p = PF.hsigmoid_loss(*[torch.tensor(a) if isinstance(a, np.ndarray)
                               else a for a in args])
        assert tuple(p.shape) == (6, 1)
        np.testing.assert_allclose(p.numpy(), r.numpy(), **VALUE_TOL)


LAYERS = {
    "CrossEntropyLoss": ({"ignore_index": 2}, "cross_entropy"),
    "MSELoss": ({"reduction": "sum"}, "mse_loss"),
    "L1Loss": ({}, "l1_loss"),
    "NLLLoss": ({}, "nll_loss"),
    "BCELoss": ({}, "binary_cross_entropy"),
    "BCEWithLogitsLoss": ({}, "bce_with_logits"),
    "KLDivLoss": ({"reduction": "batchmean"}, "kl_div"),
    "SmoothL1Loss": ({"delta": 0.5}, "smooth_l1_loss"),
    "MarginRankingLoss": ({"margin": 0.2}, "margin_ranking_loss"),
    "HingeEmbeddingLoss": ({}, "hinge_embedding_loss"),
    "CosineEmbeddingLoss": ({}, "cosine_embedding_loss"),
    "TripletMarginLoss": ({}, "triplet_margin_loss"),
    "SoftMarginLoss": ({}, "soft_margin_loss"),
    "MultiLabelSoftMarginLoss": ({}, "multi_label_soft_margin_loss"),
    "PoissonNLLLoss": ({}, "poisson_nll_loss"),
    "TripletMarginWithDistanceLoss": ({"margin": 0.5},
                                      "triplet_margin_with_distance_loss"),
}


@pytest.mark.parametrize("cls", sorted(LAYERS))
def test_loss_layers_match_reference(cls):
    kwargs, case = LAYERS[cls]
    # the layer takes the loss's tensor inputs; options go to its init
    n_in = 3 if cls in ("MarginRankingLoss", "CosineEmbeddingLoss",
                        "TripletMarginLoss",
                        "TripletMarginWithDistanceLoss") else 2
    arrays = CASES[case][1]()[:n_in]
    r = getattr(paddle.nn, cls)(**kwargs)(*[paddle.to_tensor(a)
                                            for a in arrays])
    p = getattr(pnn, cls)(**kwargs)(*[torch.tensor(a) for a in arrays])
    np.testing.assert_allclose(p.numpy(), r.numpy(), **VALUE_TOL)


def test_loss_layers_are_plain_modules():
    """A loss without parameters is a torch.nn.Module that takes no
    device: it runs wherever its inputs are."""
    layer = pnn.CrossEntropyLoss(weight=torch.tensor([1.0, 2.0, 3.0]))
    assert isinstance(layer, torch.nn.Module)
    assert list(layer.parameters()) == []
    x, y = torch.tensor(_f(4, 3)), torch.tensor(_i(3, 4))
    want = PF.cross_entropy(x, y, weight=torch.tensor([1.0, 2.0, 3.0]))
    assert torch.equal(layer(x, y), want)
    meta = pnn.MSELoss()(x.to("meta"), x.to("meta"))
    assert meta.device.type == "meta"


def test_ctc_and_hsigmoid_layers():
    layer = pnn.HSigmoidLoss(4, 7, device="cpu")
    assert sorted(n for n, _ in layer.named_parameters()) == ["bias",
                                                              "weight"]
    out = layer(torch.tensor(_f(6, 4)), torch.tensor(_i(7, 6)))
    want = PF.hsigmoid_loss(torch.tensor(_f(6, 4)), torch.tensor(_i(7, 6)),
                            7, layer.weight, layer.bias)
    assert torch.equal(out, want) and tuple(out.shape) == (6, 1)
    lp = torch.tensor(_log_softmax(_f(6, 2, 4)))
    ctc = pnn.CTCLoss(blank=0, reduction="sum")
    args = (lp, torch.tensor(_i(3, 2, 2) + 1), torch.tensor([6, 5]),
            torch.tensor([2, 1]))
    assert torch.equal(ctc(*args), PF.ctc_loss(*args, reduction="sum"))
