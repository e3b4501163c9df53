"""inference.Predictor of the port against the reference's, on the host.

The same models with the same weights (carried by name through
``load_numpy_state_dict``) and the same numpy inputs (from a seeded
RandomState) go through ``paddle_tpu.inference`` (a ``jax.jit`` per input
signature) and ``paddle_tpu_torch.inference`` (``Config.disable_gpu()``:
the plain forward on the host, where the card captures a CUDA graph per
signature). In f32 the outputs agree within 1e-5 relative: an MLP (list
API, zero-copy handles, a PredictorPool) and a 2-layer BERT classifier at
s = 256 with no mask, whose attention takes the flash path on both sides
(the port's plain versions of B1, the reference's Pallas kernel in
interpret mode). A ``set_jit_model`` predictor reads an artifact the
reference's ``jit.save`` wrote, and the reference reads one the port
wrote. The bf16 float-input cache entry is evicted by BucketedExecutor's
LRU (the reference keeps it: ROADMAP C-ref-5). The rest checks the
device rule, bf16 casts, handles and the entry points that raise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference as ref_infer
import paddle_tpu.nn as rnn
import paddle_tpu.ops.attention as ref_attn
from paddle_tpu.text.models.bert import BertConfig as RefBertConfig
from paddle_tpu.text.models.bert import \
    BertForSequenceClassification as RefBert

import paddle_tpu_torch as pt
import paddle_tpu_torch.inference as infer
from paddle_tpu_torch import nn
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               OutOfRangeError)
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.serving import BucketedExecutor
from paddle_tpu_torch.text.models import (BertConfig,
                                          BertForSequenceClassification)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
# head dim 64 (128 / 2) at s = 256: the flash path's shape contract
FLASH = dict(vocab_size=120, hidden_size=128, num_layers=2, num_heads=2,
             intermediate_size=256, max_position=256, dropout=0.0)
# bf16 outputs of the two packages: each rounds its weights, activations
# and matmul results to bf16 (unit roundoff 2^-9), at different places
BF16_REL_L2 = 2 ** -6


class RefMLP(rnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = rnn.Linear(8, 16)
        self.fc2 = rnn.Linear(16, 4)

    def forward(self, x):
        return self.fc2(paddle.nn.functional.relu(self.fc1(x)))


class MLP(nn.Layer):
    def __init__(self, device="cpu"):
        super().__init__(device=device)
        self.fc1 = nn.Linear(8, 16, device=device)
        self.fc2 = nn.Linear(16, 4, device=device)

    def forward(self, x):
        return self.fc2(pt.nn.functional.relu(self.fc1(x)))


def carried(ref, port):
    """``port`` with ``ref``'s weights."""
    pt.load_numpy_state_dict(port, {k: np.asarray(v._val)
                                    for k, v in ref.state_dict().items()})
    return port


def mlp_pair():
    paddle.seed(7)
    ref = RefMLP()
    return ref, carried(ref, MLP())


def configs(ref_layer, port_layer, bf16=False):
    rc, pc = ref_infer.Config(), infer.Config()
    pc.disable_gpu()
    rc.set_layer(ref_layer)
    pc.set_layer(port_layer)
    if bf16:
        rc.enable_low_precision(ref_infer.DataType.BFLOAT16)
        pc.enable_low_precision(infer.DataType.BFLOAT16)
    return rc, pc


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_mlp_predictor_matches_reference():
    rc, pc = configs(*mlp_pair())
    rp, pp = ref_infer.create_predictor(rc), infer.create_predictor(pc)
    rng = np.random.RandomState(2)
    for rows in (4, 1, 4):
        x = rng.randn(rows, 8).astype("float32")
        [want], [got] = rp.run([x]), pp.run([x])
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    # one entry per signature, under the same keys in f32
    assert sorted(pp._jit_cache) == sorted(rp._jit_cache)
    assert len(pp._jit_cache) == 2


def test_zero_copy_handles_match_reference():
    rc, pc = configs(*mlp_pair())
    outs = []
    for mod, cfg in ((ref_infer, rc), (infer, pc)):
        p = mod.create_predictor(cfg)
        x = np.random.RandomState(3).randn(2, 8).astype("float32")
        name = p.get_input_names()[0]
        p.get_input_handle(name).copy_from_cpu(x)
        assert p.run() is True
        h = p.get_output_handle(p.get_output_names()[0])
        outs.append((np.asarray(h.copy_to_cpu()), h.shape(), h.type(),
                     p.get_input_names(), p.get_output_names()))
    (r, *r_meta), (o, *o_meta) = outs
    np.testing.assert_allclose(o, r, rtol=RTOL, atol=ATOL)
    assert o_meta == r_meta


def test_predictor_pool_shares_the_cache():
    ref, port = mlp_pair()
    _, pc = configs(ref, port)
    pool = infer.PredictorPool(pc, size=3)
    x = np.random.RandomState(5).randn(1, 8).astype("float32")
    outs = [pool.retrieve(i).run([x])[0] for i in range(3)]
    assert all(np.array_equal(o, outs[0]) for o in outs)
    caches = {id(pool.retrieve(i)._jit_cache) for i in range(3)}
    assert len(caches) == 1 and len(pool.retrieve(2)._jit_cache) == 1
    with pytest.raises(InvalidArgumentError, match="size must be >= 1"):
        infer.PredictorPool(pc, size=0)
    with pytest.raises(OutOfRangeError, match=r"retrieve\(3\).*valid: 0..2"):
        pool.retrieve(3)


@pytest.fixture()
def flash_both(monkeypatch):
    """Attention on the flash path on both sides at s = 256: the port's
    plain version of B1 (non-causal), the reference's Pallas kernel in
    interpret mode. Records each side's flash calls."""
    calls = {"port": 0, "ref": 0}
    monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
    real = port_attn.flash_attention
    monkeypatch.setattr(port_attn, "flash_attention",
                        lambda *a, **k: calls.__setitem__(
                            "port", calls["port"] + 1) or real(*a, **k))
    monkeypatch.setattr(ref_attn, "_pallas_available", lambda: True)
    ref_real = ref_attn._flash_attention_diff
    monkeypatch.setattr(ref_attn, "_flash_attention_diff",
                        lambda *a: calls.__setitem__(
                            "ref", calls["ref"] + 1) or ref_real(*a))
    return calls


def bert_pair():
    paddle.seed(0)
    ref = RefBert(RefBertConfig(**FLASH), num_classes=2)
    port = BertForSequenceClassification(
        BertConfig(**FLASH), num_classes=2, device="cpu",
        generator=pt.make_generator(1))
    return ref, carried(ref, port)


def bert_ids(seed, b=2, s=256):
    return np.random.RandomState(seed).randint(
        0, FLASH["vocab_size"], (b, s)).astype("int64")


def test_bert_predictor_on_the_flash_path_matches_reference(flash_both):
    rc, pc = configs(*bert_pair())
    ids = bert_ids(11)
    [want] = ref_infer.create_predictor(rc).run([ids])
    [got] = infer.create_predictor(pc).run([ids])
    assert got.shape == (2, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    # one non-causal flash call per layer on each side (the reference's
    # traced once, by its jit)
    assert flash_both["port"] == flash_both["ref"] == FLASH["num_layers"]


def test_bf16_predictor_matches_reference():
    """bf16 through enable_low_precision: parameters cast once, float
    inputs per call, ids kept int64; the bf16 output comes back widened to
    float32 (numpy has no bfloat16)."""
    rc, pc = configs(*mlp_pair(), bf16=True)
    x = np.random.RandomState(4).randn(8, 8).astype("float32")
    [want] = ref_infer.create_predictor(rc).run([x])
    p = infer.create_predictor(pc)
    [got] = p.run([x])
    assert got.dtype == np.float32
    want = np.asarray(want).astype(np.float32)
    assert rel_l2(got, want) <= BF16_REL_L2
    # the bf16 output's values are bf16 values
    as_bf16 = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
    assert np.array_equal(got, as_bf16)
    [prog] = p._jit_cache.values()
    assert {v.dtype for v in prog._state.values()} == {torch.bfloat16}


def test_bf16_bert_keeps_ids_integer(flash_both):
    rc, pc = configs(*bert_pair(), bf16=True)
    ids = bert_ids(12)
    [want] = ref_infer.create_predictor(rc).run([ids])
    p = infer.create_predictor(pc)
    [got] = p.run([ids])
    assert rel_l2(got, np.asarray(want).astype(np.float32)) <= BF16_REL_L2
    assert list(p._jit_cache) == [(((2, 256), "int64"),)]


def test_set_jit_model_reads_the_references_artifact(tmp_path):
    ref = RefMLP()
    prefix = str(tmp_path / "ref_mlp")
    paddle.jit.save(ref, prefix)
    cfg = infer.Config()
    cfg.disable_gpu()
    cfg.set_jit_model(prefix, MLP)
    x = np.random.RandomState(6).randn(3, 8).astype("float32")
    [got] = infer.create_predictor(cfg).run([x])
    want = ref(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_reference_reads_the_ports_jit_artifact(tmp_path):
    _, port = mlp_pair()
    prefix = str(tmp_path / "port_mlp")
    pt.jit.save(port, prefix)
    rc = ref_infer.Config()
    rc.set_jit_model(prefix, RefMLP)
    x = np.random.RandomState(7).randn(3, 8).astype("float32")
    [want] = ref_infer.create_predictor(rc).run([x])
    with torch.no_grad():
        got = port(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    loaded = pt.jit.load(prefix)
    assert loaded._meta["class"] == "MLP"
    with pytest.raises(RuntimeError, match="bind"):
        loaded(torch.tensor(x))


def test_bf16_float_entry_is_evicted_with_its_program():
    """BucketedExecutor's LRU drops the predictor's entry for a float
    input under bf16: the port keys its cache by the caller's signature.
    The reference keys after its cast, so its entry stays (C-ref-5)."""
    seen = {}
    for mod, cfg in zip((ref_infer, infer), configs(*mlp_pair(),
                                                    bf16=True)):
        p = mod.create_predictor(cfg)
        ex = BucketedExecutor(p, max_cached=1)
        ex.run([np.ones((2, 8), "float32")])
        first = dict(p._jit_cache)
        ex.run([np.ones((4, 8), "float32")])
        seen[mod] = (first, dict(p._jit_cache), ex.compile_count)
    first, after, compiles = seen[infer]
    assert list(first) == [(((2, 8), "float32"),)]
    assert list(after) == [(((4, 8), "float32"),)] and compiles == 2
    ref_first, ref_after, _ = seen[ref_infer]
    assert len(ref_after) == 2 and \
        str(list(ref_first)[0][0][1]) == "bfloat16"


def test_predictor_moves_the_layer_and_sets_eval():
    layer = nn.Sequential(nn.Linear(8, 8, device="cpu"),
                          nn.Dropout(0.5, device="cpu"))
    layer.train()
    cfg = infer.Config()
    cfg.disable_gpu()
    cfg.set_layer(layer)
    p = infer.create_predictor(cfg)
    assert not layer.training and p.device == torch.device("cpu")
    x = np.ones((2, 8), "float32")
    assert np.array_equal(p.run([x])[0], p.run([x])[0])


def test_the_card_is_the_default_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = infer.Config()
    assert cfg.use_gpu() and cfg.gpu_device_id() == 0
    cfg.set_layer(MLP())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.create_predictor(cfg)
    cfg.disable_gpu()
    assert infer.create_predictor(cfg).device.type == "cpu"


@pytest.mark.parametrize("call", [
    lambda tmp: infer.save_predictor_model(tmp, lambda a: a, []),
    lambda tmp: infer.convert_to_mixed_precision(tmp, tmp + "2"),
    lambda tmp: _exported_config(tmp),
], ids=["save_predictor_model", "convert_to_mixed_precision",
        "set_exported_model"])
def test_serialized_programs_raise(call, tmp_path):
    with pytest.raises(NotImplementedError, match="A12"):
        call(str(tmp_path / "m"))


def _exported_config(path):
    cfg = infer.Config()
    cfg.disable_gpu()
    cfg.set_exported_model(path)
    return infer.create_predictor(cfg)


def test_handles_and_enums_match_reference():
    for mod in (ref_infer, infer):
        h = mod.Tensor("x", predictor=None, is_input=True)
        h.copy_from_cpu(np.arange(6, dtype="float32").reshape(2, 3))
        with pytest.raises(ValueError, match="does not match"):
            h.reshape([4, 4])
        h.reshape([3, 2])
        assert h.shape() == [3, 2] and h.type() == mod.DataType.FLOAT32
    for dt in list(range(7)) + ["float32", "int64", "bfloat16", "uint8"]:
        assert infer.get_num_bytes_of_data_type(dt) == \
            ref_infer.get_num_bytes_of_data_type(dt)
    cfg = infer.Config()
    with pytest.warns(UserWarning, match="enable_mkldnn is a no-op"):
        cfg.enable_mkldnn()
    with pytest.warns(UserWarning, match="no TensorRT subgraphs"):
        cfg.enable_tensorrt_engine(precision_mode=infer.DataType.FLOAT16)
    assert cfg._precision == infer.DataType.BFLOAT16
    assert '"place": "gpu"' in cfg.summary()
