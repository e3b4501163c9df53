"""The BERT/ERNIE slice of the port against the JAX reference on the host.

A small BERT (and ERNIE) classifier is built by paddle_tpu, its weights are
carried into paddle_tpu_torch by name, and the same token ids, attention
masks and labels (from a seeded RandomState) run through both in f32: the
loss to 1e-5 relative and every parameter's grad to 1e-4 / 1e-5. At s =
256 with head dim 64 and no mask, the port is forced onto the flash path
(the plain versions of B1, B2 and B3, non-causal, which the card replaces
by its kernels) and the reference onto its Pallas kernels in interpret
mode. The state dict's names, the .pdparams files between the packages and
cross_entropy with (B,) labels are checked too.
"""
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as RF
import paddle_tpu.ops.attention as ref_attn
from paddle_tpu.text.models.bert import BertConfig as RefBertConfig
from paddle_tpu.text.models.bert import \
    BertForSequenceClassification as RefBert
from paddle_tpu.text.models.ernie import ErnieConfig as RefErnieConfig
from paddle_tpu.text.models.ernie import \
    ErnieForSequenceClassification as RefErnie

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.text.models import (BertConfig,
                                          BertForSequenceClassification,
                                          ErnieConfig,
                                          ErnieForSequenceClassification)

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(vocab_size=120, hidden_size=64, num_layers=2, num_heads=4,
             intermediate_size=128, max_position=64, dropout=0.0)
# head dim 64 (128 / 2): the flash path's shape contract at s = 256
FLASH = dict(vocab_size=120, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=256, max_position=256, dropout=0.0)
MODELS = {
    "bert": (lambda kw: RefBert(RefBertConfig(**kw), num_classes=2),
             lambda kw: BertForSequenceClassification(
                 BertConfig(**kw), num_classes=2, device="cpu",
                 generator=pt.make_generator(1))),
    "ernie": (lambda kw: RefErnie(RefErnieConfig(**kw), num_classes=2),
              lambda kw: ErnieForSequenceClassification(
                  ErnieConfig(**kw), num_classes=2, device="cpu",
                  generator=pt.make_generator(1))),
}


def _pair(arch, kw):
    paddle.seed(0)
    make_ref, make_port = MODELS[arch]
    ref = make_ref(kw)
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    port = make_port(kw)
    pt.load_numpy_state_dict(port, arrays)
    return ref, port


def _batch(seed, b, s, vocab, masked):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype("int64")
    labels = rng.randint(0, 2, (b,)).astype("int64")
    mask = None
    if masked:
        # each row keeps a prefix of random length (padding at the end)
        lengths = rng.randint(s // 2, s + 1, (b,))
        mask = (np.arange(s)[None, :] < lengths[:, None]).astype("int64")
    return ids, labels, mask


def _loss_and_grads(ref, port, ids, labels, mask):
    r_mask = None if mask is None else paddle.to_tensor(mask)
    p_mask = None if mask is None else torch.tensor(mask)
    r_loss = ref(paddle.to_tensor(ids), attention_mask=r_mask,
                 labels=paddle.to_tensor(labels))
    r_loss.backward()
    p_loss = port(torch.tensor(ids), attention_mask=p_mask,
                  labels=torch.tensor(labels))
    p_loss.backward()
    r_grads = {n: np.asarray(p.grad._val) for n, p in ref.named_parameters()}
    p_grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    return float(r_loss), float(p_loss.detach()), r_grads, p_grads


def _assert_match(r_loss, p_loss, r_grads, p_grads):
    np.testing.assert_allclose(p_loss, r_loss, rtol=LOSS_RTOL)
    assert sorted(p_grads) == sorted(r_grads)
    for name, g in r_grads.items():
        np.testing.assert_allclose(p_grads[name], g, err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("arch", ["bert", "ernie"])
def test_state_dict_names_and_shapes_are_the_references(arch):
    ref, port = _pair(arch, SMALL)
    r_sd, p_sd = ref.state_dict(), port.state_dict()
    assert list(p_sd) == list(r_sd)
    assert len(p_sd) == 41
    assert {k: tuple(v.shape) for k, v in p_sd.items()} == \
        {k: tuple(v.shape) for k, v in r_sd.items()}
    assert "bert.encoder.layers.1.self_attn.q_proj.weight" in p_sd
    assert "bert.pooler.weight" in p_sd and "classifier.weight" in p_sd


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ["bert", "ernie"])
def test_loss_and_every_grad_match_reference(arch, masked):
    ref, port = _pair(arch, SMALL)
    batch = _batch(3, 2, 16, SMALL["vocab_size"], masked)
    _assert_match(*_loss_and_grads(ref, port, *batch))


@pytest.mark.parametrize("arch", ["bert", "ernie"])
def test_flash_path_matches_reference_pallas(arch, monkeypatch):
    """s = 256, head dim 64, no mask: the port takes B1/B2/B3's plain
    versions through _FlashAttentionFn (non-causal), the reference its
    Pallas kernels in interpret mode; loss and every grad agree."""
    port_calls, ref_calls = [], []
    real = port_attn._FlashAttentionFn.apply
    monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
    monkeypatch.setattr(port_attn._FlashAttentionFn, "apply",
                        lambda *a: port_calls.append(a[3]) or real(*a))
    ref_real = ref_attn._flash_attention_diff
    monkeypatch.setattr(ref_attn, "_pallas_available", lambda: True)
    monkeypatch.setattr(ref_attn, "_flash_attention_diff",
                        lambda *a: ref_calls.append(a[3]) or ref_real(*a))
    ref, port = _pair(arch, FLASH)
    batch = _batch(4, 2, 256, FLASH["vocab_size"], False)
    _assert_match(*_loss_and_grads(ref, port, *batch))
    # one non-causal flash call per layer on each side
    assert port_calls == [False] * FLASH["num_layers"]
    assert ref_calls == [False] * FLASH["num_layers"]


def test_use_flash_attention_off_takes_the_math_path(monkeypatch):
    calls = []
    monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
    monkeypatch.setattr(port_attn, "flash_attention",
                        lambda *a, **k: calls.append(1))
    port = BertForSequenceClassification(
        BertConfig(**FLASH, use_flash_attention=False), device="cpu")
    ids, _, _ = _batch(5, 1, 256, FLASH["vocab_size"], False)
    with torch.no_grad():
        logits = port(torch.tensor(ids))
    assert calls == [] and tuple(logits.shape) == (1, 2)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_with_batch_labels(reduction):
    """(B, C) logits against (B,) labels, with one ignored label."""
    rng = np.random.RandomState(6)
    logits = rng.randn(5, 3).astype("float32")
    labels = np.array([0, 2, 1, -100, 2], dtype="int64")
    r_x = paddle.to_tensor(logits, stop_gradient=False)
    p_x = torch.tensor(logits, requires_grad=True)
    r = RF.cross_entropy(r_x, paddle.to_tensor(labels), reduction=reduction)
    p = PF.cross_entropy(p_x, torch.tensor(labels), reduction=reduction)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(r._val),
                               rtol=1e-6, atol=1e-6)
    r.sum().backward()
    p.sum().backward()
    np.testing.assert_allclose(p_x.grad.numpy(), np.asarray(r_x.grad._val),
                               rtol=1e-6, atol=1e-6)


def test_pdparams_round_trip_between_packages(tmp_path):
    ref, port = _pair("bert", SMALL)
    ref_path, port_path = tmp_path / "ref.pdparams", tmp_path / "port.pdparams"
    paddle.save(ref.state_dict(), str(ref_path))
    pt.save(port.state_dict(), str(port_path))
    with open(ref_path, "rb") as f:
        a = pickle.load(f)
    with open(port_path, "rb") as f:
        b = pickle.load(f)
    assert list(a) == list(b)
    for name in a:
        x, y = a[name]["data"], b[name]["data"]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name
    # each package loads the other's file
    port2 = BertForSequenceClassification(BertConfig(**SMALL), device="cpu",
                                          generator=pt.make_generator(7))
    pt.load_numpy_state_dict(port2, pt.load(str(ref_path)))
    ref2 = RefBert(RefBertConfig(**SMALL), num_classes=2)
    ref2.set_state_dict(paddle.load(str(port_path)))
    ids, labels, _ = _batch(8, 2, 16, SMALL["vocab_size"], False)
    with torch.no_grad():
        got = port2(torch.tensor(ids)).numpy()
    want = np.asarray(ref2(paddle.to_tensor(ids))._val)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_reference_init_draws_from_the_generator():
    """N(0, initializer_range) into every Linear and Embedding weight from
    the model's generator: the same seed gives the same weights, another
    seed others; LayerNorms keep 1 and 0."""
    def build(seed):
        return BertForSequenceClassification(
            BertConfig(**SMALL), device="cpu",
            generator=pt.make_generator(seed))
    a, b, c = build(0), build(0), build(1)
    for (name, x), y, z in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(x, y), name
        if name.endswith("layer_norm.weight") or ".norm" in name:
            continue
        if x.dim() == 2:
            assert not torch.equal(x, z), name
            assert abs(float(x.std()) - 0.02) < 0.01, name
    w = a.bert.embeddings.layer_norm.weight
    assert torch.equal(w, torch.ones_like(w))
