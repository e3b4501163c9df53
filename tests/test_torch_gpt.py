"""The serving slice of the PyTorch/CUDA port against the JAX reference.

A tiny GPT is built by paddle_tpu, its weights are carried into
paddle_tpu_torch with load_numpy_state_dict, and both run on the host:
full-forward logits, prefill plus KV-cached greedy decode, and the
.pdparams round trip. The prompt is 256 tokens long, so on a card the
port's prefill would take the flash kernel; here the same path runs its
plain version when the selection is forced. Logits are held to 1e-4, the
tolerance of the reference's own decode parity test.
"""
import ast
import json
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

# The shapes here are tiny: one intra-op thread is enough, and it keeps
# torch's spinning OpenMP pool from taking cores from the timing-sensitive
# tests that other workers run beside these.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
           max_position_embeddings=512, dropout=0.0)
PROMPT, STEPS = 256, 6
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefGPT(RefConfig(**CFG))
    ref.eval()
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    port = GPTForCausalLM(GPTConfig(**CFG), device="cpu",
                          generator=pt.make_generator(1))
    port.eval()
    pt.load_numpy_state_dict(port, arrays)
    return ref, port, arrays


@pytest.fixture(scope="module")
def ids():
    return np.random.RandomState(9).randint(
        0, CFG["vocab_size"], size=(2, PROMPT)).astype("int64")


@pytest.fixture
def forced_flash(monkeypatch):
    """Take the flash path as on a card (its plain version on the host)
    and count the prefill calls that reach it."""
    calls = []
    real = port_attn.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
    monkeypatch.setattr(port_attn, "flash_attention", spy)
    return calls


def _ref_greedy(model, ids):
    caches = model.gpt.init_decode_caches()
    logits, caches = model(paddle.to_tensor(ids), caches=caches)
    out = [np.asarray(logits._val)]
    tok = out[-1][:, -1].argmax(-1)[:, None]
    toks = [tok]
    for _ in range(STEPS):
        logits, caches = model(paddle.to_tensor(tok), caches=caches)
        out.append(np.asarray(logits._val))
        tok = out[-1][:, -1].argmax(-1)[:, None]
        toks.append(tok)
    return out, np.concatenate(toks, axis=1)


def _port_greedy(model, ids):
    with torch.inference_mode():
        caches = model.gpt.init_decode_caches()
        logits, caches = model(torch.from_numpy(ids), caches=caches)
        out = [logits.numpy()]
        tok = logits[:, -1].argmax(-1, keepdim=True)
        toks = [tok]
        for _ in range(STEPS):
            logits, caches = model(tok, caches=caches)
            out.append(logits.numpy())
            tok = logits[:, -1].argmax(-1, keepdim=True)
            toks.append(tok)
    assert caches[0][0].shape == (2, PROMPT + STEPS, 2, 64)
    return out, torch.cat(toks, dim=1).numpy()


@pytest.fixture(scope="module")
def ref_decode(models, ids):
    return _ref_greedy(models[0], ids)


def test_state_dict_names_and_layouts_match(models):
    ref, port, arrays = models
    port_sd = port.state_dict()
    assert list(port_sd) == list(arrays)
    for name, arr in arrays.items():
        assert np.array_equal(port_sd[name].numpy(), arr), name
    # paddle's (in, out) Linear layout: the qkv weight is (hidden, 3*hidden)
    assert tuple(port_sd["gpt.h.0.attn.qkv.weight"].shape) == (128, 384)


def test_full_forward_logits_match(models, ids):
    ref, port, _ = models
    want = np.asarray(ref(paddle.to_tensor(ids))._val)
    with torch.inference_mode():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_full_forward_through_flash_path_matches(models, ids, forced_flash):
    ref, port, _ = models
    want = np.asarray(ref(paddle.to_tensor(ids))._val)
    with torch.inference_mode():
        got = port(torch.from_numpy(ids)).numpy()
    assert len(forced_flash) == CFG["num_layers"]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_prefill_and_cached_greedy_decode_match(models, ids, ref_decode,
                                                request, flash):
    if flash:
        calls = request.getfixturevalue("forced_flash")
    want_logits, want_toks = ref_decode
    got_logits, got_toks = _port_greedy(models[1], ids)
    if flash:
        # the prefill takes flash in every layer; decode steps (s_q = 1)
        # take the math path
        assert len(calls) == CFG["num_layers"]
    for g, w in zip(got_logits, want_logits):
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_array_equal(got_toks, want_toks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pdparams_round_trip_is_bit_exact(models, tmp_path, dtype):
    ref, _, _ = models
    paddle.seed(0)
    src = RefGPT(RefConfig(**CFG))
    if dtype == "bfloat16":
        src.bfloat16()
    ref_path = tmp_path / "ref.pdparams"
    paddle.save(src.state_dict(), str(ref_path))
    loaded = pt.load(str(ref_path))
    port = GPTForCausalLM(GPTConfig(**CFG), device="cpu", dtype=dtype)
    pt.load_numpy_state_dict(port, loaded)
    port_path = tmp_path / "port.pdparams"
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
    # and the port's file loads back into the reference
    ref2 = RefGPT(RefConfig(**CFG))
    ref2.set_state_dict(paddle.load(str(port_path)))


_PURITY = """
import importlib, json, pkgutil, sys
before = set(sys.modules)
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                               "paddle_tpu_torch."):
    importlib.import_module(m.name)
new = set(sys.modules) - before
print(json.dumps({
    "foreign": sorted(m for m in new
                      if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")),
    "port": sorted(m for m in new if m.startswith("paddle_tpu_torch."))}))
"""

# modules the walk must reach, the training surface around the step among
# them (amp, schedulers, clips, flags, the compiled step, recompute), the
# BERT/ERNIE slice, the conv net slice, the serving slice (inference,
# serving, resilience, profiler), the training API slice (io, hapi,
# metric, losses, vision data) and the script surface (ParamAttr, the
# regularizers, sparse rows, devices, the tensor API), the autotuner
# and data parallelism, fleet with its pipeline and checkpoint, and the
# integrity, async checkpoint, profiler and expert-parallel modules, and
# serving over the wire with live rollout, the autoscaler, disaggregated
# prefill/decode and the chaos campaign
PORT_MODULES = {
    "paddle_tpu_torch.amp.auto_cast", "paddle_tpu_torch.amp.grad_scaler",
    "paddle_tpu_torch.optimizer.lr", "paddle_tpu_torch.optimizer.optimizer",
    "paddle_tpu_torch.nn.clip", "paddle_tpu_torch.framework.flags",
    "paddle_tpu_torch.jit.to_static", "paddle_tpu_torch.jit.compiled_step",
    "paddle_tpu_torch.distributed.fleet.utils",
    "paddle_tpu_torch.text.models.gpt",
    "paddle_tpu_torch.ops.cuda.flash_attention",
    # the BERT/ERNIE slice
    "paddle_tpu_torch.nn.layer.transformer",
    "paddle_tpu_torch.nn.functional.activation",
    "paddle_tpu_torch.ops.fused_residual_ln",
    "paddle_tpu_torch.text.models.bert",
    "paddle_tpu_torch.text.models.ernie",
    # the conv net slice
    "paddle_tpu_torch.nn.functional.conv",
    "paddle_tpu_torch.nn.functional.pooling",
    "paddle_tpu_torch.nn.layer.conv",
    "paddle_tpu_torch.nn.layer.pooling",
    "paddle_tpu_torch.nn.layer.activation",
    "paddle_tpu_torch.ops.fused_conv_bn",
    "paddle_tpu_torch.vision.models.resnet",
    "paddle_tpu_torch.vision.models.lenet",
    # the serving slice
    "paddle_tpu_torch.framework.errors",
    "paddle_tpu_torch.resilience.faults",
    "paddle_tpu_torch.resilience.recorder",
    "paddle_tpu_torch.resilience.watchdog",
    "paddle_tpu_torch.resilience.recovery",
    "paddle_tpu_torch.resilience.health",
    "paddle_tpu_torch.profiler.metrics",
    "paddle_tpu_torch.profiler.tracing",
    "paddle_tpu_torch.jit.save_load",
    "paddle_tpu_torch.jit.inference_graph",
    "paddle_tpu_torch.inference",
    "paddle_tpu_torch.serving.batcher",
    "paddle_tpu_torch.serving.metrics",
    "paddle_tpu_torch.serving.overload",
    "paddle_tpu_torch.serving.scheduler",
    "paddle_tpu_torch.serving.server",
    "paddle_tpu_torch.serving.decode.kv_cache",
    "paddle_tpu_torch.serving.decode.prefix",
    "paddle_tpu_torch.serving.decode.specdecode",
    "paddle_tpu_torch.serving.decode.compiled_decode",
    "paddle_tpu_torch.serving.decode.engine",
    # the training API slice
    "paddle_tpu_torch.io", "paddle_tpu_torch.io.worker",
    "paddle_tpu_torch.vision.datasets", "paddle_tpu_torch.vision.transforms",
    "paddle_tpu_torch.metric", "paddle_tpu_torch.nn.layer.loss",
    "paddle_tpu_torch.nn.functional.loss", "paddle_tpu_torch.callbacks",
    "paddle_tpu_torch.hapi.model", "paddle_tpu_torch.hapi.callbacks",
    "paddle_tpu_torch.hapi.prefetch", "paddle_tpu_torch.hapi.model_summary",
    "paddle_tpu_torch.hapi.dynamic_flops",
    "paddle_tpu_torch.profiler.steptimer",
    "paddle_tpu_torch.distributed.env",
    "paddle_tpu_torch.resilience.guard",
    "paddle_tpu_torch.resilience.preempt",
    "paddle_tpu_torch.resilience.snapshot",
    # the script surface
    "paddle_tpu_torch.framework.param_attr", "paddle_tpu_torch.regularizer",
    "paddle_tpu_torch.core.selected_rows", "paddle_tpu_torch.core.device",
    "paddle_tpu_torch.tensor", "paddle_tpu_torch.tensor.attribute",
    "paddle_tpu_torch.tensor.creation", "paddle_tpu_torch.tensor.einsum",
    "paddle_tpu_torch.tensor.linalg", "paddle_tpu_torch.tensor.logic",
    "paddle_tpu_torch.tensor.manipulation", "paddle_tpu_torch.tensor.math",
    "paddle_tpu_torch.tensor.random", "paddle_tpu_torch.tensor.search",
    "paddle_tpu_torch.tensor.stat",
    # the autotuner and data parallelism
    "paddle_tpu_torch.ops.autotune", "paddle_tpu_torch.distributed.mesh",
    "paddle_tpu_torch.distributed.collective",
    "paddle_tpu_torch.distributed.reducer",
    "paddle_tpu_torch.distributed.parallel",
    # fleet's hybrid parallelism, the pipeline and the hybrid checkpoint
    "paddle_tpu_torch.distributed.fleet.meta_parallel",
    "paddle_tpu_torch.distributed.fleet.pipeline_engine",
    "paddle_tpu_torch.distributed.checkpoint",
    # the declarative layouts, ring attention and the SPMD pipeline
    "paddle_tpu_torch.distributed.spec_layout",
    "paddle_tpu_torch.distributed.fleet.sequence_parallel",
    "paddle_tpu_torch.distributed.fleet.spmd_pipeline",
    # auto_parallel, the expert exchange and incubate with the MoE layer
    "paddle_tpu_torch.distributed.auto_parallel",
    "paddle_tpu_torch.distributed.utils",
    "paddle_tpu_torch.incubate", "paddle_tpu_torch.incubate.moe",
    "paddle_tpu_torch.incubate.nn", "paddle_tpu_torch.incubate.optimizer",
    # silent-data-corruption defence, zero-stall checkpoints, the
    # profiler's host API and the elastic expert-parallel engine
    "paddle_tpu_torch.resilience.integrity", "paddle_tpu_torch.profiler",
    "paddle_tpu_torch.distributed.fleet.expert_parallel",
    # serving over the wire, live rollout, the autoscaler, disaggregated
    # prefill/decode and the chaos campaign
    "paddle_tpu_torch.serving.client", "paddle_tpu_torch.serving.rollout",
    "paddle_tpu_torch.serving.autoscaler", "paddle_tpu_torch.serving.disagg",
    "paddle_tpu_torch.serving.decode.kv_migrate",
    "paddle_tpu_torch.resilience.campaign",
    "paddle_tpu_torch.resilience.injection_sites",
}


def test_port_never_imports_jax_or_the_reference():
    r = subprocess.run([sys.executable, "-c", _PURITY], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    seen = json.loads(r.stdout.strip().splitlines()[-1])
    assert seen["foreign"] == []
    assert PORT_MODULES <= set(seen["port"]), PORT_MODULES - set(seen["port"])
    # and no import statement names them, in the package or chip_smoke.py
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "paddle_tpu"), (path, name)
