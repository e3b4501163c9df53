"""The port's autotuner and measured fusion policy (ops/autotune.py)
against the reference's (paddle_tpu/ops/autotune.py).

One case for each of the reference's tests/test_autotune.py cases, run
against the port: the search picks the measured winner and persists it; a
second tuner over the same cache (a second process) searches nothing;
torn, corrupt and foreign records are misses; a source-version bump
invalidates; an unsearchable placement gets the fallback and writes
nothing; FLAGS_fusion_policy auto/always/never, the direction split, the
recorded decision and recompute's direction hint; the flash tiles'
deterministic fallbacks. The port's auto is its measured table on the
card too, and the timed fusion search (a tuner made with
``fusion_search=True``) raises where a form fails and is versioned by the
kernels' CUDA sources. Beside them: the signature helpers equal the
reference's on a grid of shapes; under ``always`` and under ``never``
each fused op and flash attention agree with the reference in forward and
gradients; the CPU never searches.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework.flags import set_flags as ref_set_flags
from paddle_tpu.ops import autotune as ref_autotune

import paddle_tpu_torch as pt
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.ops import autotune
from paddle_tpu_torch.ops.autotune import Autotuner
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)


class ScriptedMeasure:
    """measure_fn double: the scripted time of the candidate build()
    names, and a count of calls."""

    def __init__(self, times):
        self.times = times
        self.calls = 0

    def __call__(self, fn, args):
        self.calls += 1
        return self.times[fn[1]]


def _build(cand):
    return ("cand", cand)


def _get(tuner, version="v1", fallback="b"):
    return tuner.get(
        "testop", "sig1", candidates=("a", "b", "c"), build=_build,
        make_args=lambda: (), fallback=fallback, version=version)


@pytest.fixture(autouse=True)
def _fresh():
    autotune.reset_counters()
    yield
    pt.set_flags({"FLAGS_fusion_policy": "auto"})
    ref_set_flags({"FLAGS_fusion_policy": "auto"})


def _tuner(tmp_path, times, searchable=True):
    return Autotuner(cache_dir=str(tmp_path),
                     measure_fn=ScriptedMeasure(times),
                     searchable=lambda: searchable)


# -- the tuner (reference TestAutotuner) ------------------------------------

def test_search_picks_fastest_and_memoizes(tmp_path):
    t = _tuner(tmp_path, {"a": 3.0, "b": 1.0, "c": 2.0})
    assert _get(t) == "b"
    assert autotune.counters()["searches"] == 1
    # every candidate once a round
    assert t._measure.calls == 3 * t._rounds
    assert _get(t) == "b"
    assert autotune.counters()["searches"] == 1
    assert t._measure.calls == 3 * t._rounds
    assert autotune.counters()["mem_hits"] == 1


def test_search_takes_the_median_of_alternating_rounds(tmp_path):
    """A candidate's one fast round (the first, say) does not win: the
    median of its rounds does, and the order alternates."""
    order = []
    script = {"a": iter([0.5, 3.0, 3.0]), "b": iter([2.0, 2.0, 2.0])}

    def scripted(fn, args):
        order.append(fn[1])
        return next(script[fn[1]])
    t = Autotuner(cache_dir=str(tmp_path), measure_fn=scripted,
                  searchable=lambda: True, rounds=3)
    got = t.get("testop", "sig", candidates=("a", "b"), build=_build,
                make_args=lambda: (), fallback="a")
    assert got == "b"
    assert order == ["a", "b", "b", "a", "a", "b"]


def test_warm_cache_second_process_zero_searches(tmp_path):
    _get(_tuner(tmp_path, {"a": 3.0, "b": 1.0, "c": 2.0}))
    autotune.reset_counters()
    fresh = _tuner(tmp_path, {"a": 0.0, "b": 0.0, "c": 0.0})
    assert _get(fresh) == "b"
    assert autotune.counters()["searches"] == 0
    assert autotune.counters()["disk_hits"] == 1
    assert fresh._measure.calls == 0


def test_corrupt_cache_ignored_and_rebuilt(tmp_path):
    _get(_tuner(tmp_path, {"a": 3.0, "b": 1.0, "c": 2.0}))
    (cache_file,) = tmp_path.glob("*.json")
    cache_file.write_text("{ not json !!")
    autotune.reset_counters()
    t2 = _tuner(tmp_path, {"a": 1.0, "b": 5.0, "c": 5.0})
    assert _get(t2) == "a"
    assert autotune.counters()["searches"] == 1
    assert json.loads(cache_file.read_text())["value"] == "a"


def test_torn_cache_file_is_a_miss(tmp_path):
    _get(_tuner(tmp_path, {"a": 3.0, "b": 1.0, "c": 2.0}))
    (cache_file,) = tmp_path.glob("*.json")
    full = cache_file.read_text()
    cache_file.write_text(full[: len(full) // 2])
    assert _get(_tuner(tmp_path, {"a": 5.0, "b": 5.0, "c": 1.0})) == "c"


def test_wrong_key_record_is_a_miss(tmp_path):
    _get(_tuner(tmp_path, {"a": 3.0, "b": 1.0, "c": 2.0}))
    (cache_file,) = tmp_path.glob("*.json")
    rec = json.loads(cache_file.read_text())
    rec["key"] = "some|other|key"
    cache_file.write_text(json.dumps(rec))
    assert _get(_tuner(tmp_path, {"a": 1.0, "b": 9.0, "c": 9.0})) == "a"
    assert autotune.counters()["cache_errors"] >= 1


def test_source_hash_bump_invalidates(tmp_path):
    _get(_tuner(tmp_path, {"a": 3.0, "b": 1.0, "c": 2.0}), version="v1")
    autotune.reset_counters()
    t2 = _tuner(tmp_path, {"a": 1.0, "b": 9.0, "c": 9.0})
    assert _get(t2, version="v2") == "a"
    assert autotune.counters()["searches"] == 1


def test_key_carries_the_device_name(tmp_path):
    """An answer found on one device never answers for another."""
    t = _tuner(tmp_path, {"a": 3.0, "b": 1.0, "c": 2.0})
    _get(t)
    (cache_file,) = tmp_path.glob("*.json")
    assert json.loads(cache_file.read_text())["key"].endswith("|cpu")


def test_unsearchable_returns_fallback_without_timing(tmp_path):
    t = _tuner(tmp_path, {"a": 1.0, "b": 2.0, "c": 3.0}, searchable=False)
    assert _get(t, fallback="c") == "c"
    assert t._measure.calls == 0
    assert autotune.counters()["fallbacks"] == 1
    assert list(tmp_path.glob("*.json")) == []


def test_all_candidates_failing_returns_fallback(tmp_path):
    def boom(fn, args):
        raise RuntimeError("does not launch")
    t = Autotuner(cache_dir=str(tmp_path), measure_fn=boom,
                  searchable=lambda: True)
    assert _get(t, fallback="b") == "b"
    assert autotune.counters()["candidate_errors"] == 3 * t._rounds
    assert [e[1] for e in t.errors[:3]] == ["a", "b", "c"]


def test_a_candidate_that_fails_to_build_is_skipped(tmp_path):
    def build(cand):
        if cand == "a":
            raise RuntimeError("does not launch")
        return ("cand", cand)
    t = _tuner(tmp_path, {"a": 0.0, "b": 2.0, "c": 1.0})
    got = t.get("testop", "sig", candidates=("a", "b", "c"), build=build,
                make_args=lambda: (), fallback="b")
    assert got == "c" and [e[1] for e in t.errors] == ["a"]


def test_tuple_values_roundtrip_through_disk(tmp_path):
    t = _tuner(tmp_path, {(128, 64): 2.0, (64, 64): 1.0})
    got = t.get("blocks", "s", candidates=((128, 64), (64, 64)),
                build=_build, make_args=lambda: (), fallback=(128, 64),
                version="v")
    assert got == (64, 64)
    got2 = _tuner(tmp_path, {}).get(
        "blocks", "s", candidates=((128, 64), (64, 64)), build=_build,
        make_args=lambda: (), fallback=(128, 64), version="v")
    assert got2 == (64, 64) and isinstance(got2, tuple)


def test_default_tuner_unsearchable_on_cpu():
    assert not autotune.get_tuner().searchable()
    assert not autotune.get_tuner().searchable("cpu")


def test_default_cache_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("PADDLE_TPU_AUTOTUNE_CACHE", raising=False)
    assert autotune.default_cache_dir().endswith(
        "/.cache/paddle_tpu_torch/autotune")
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(tmp_path))
    assert autotune.AutotuneCache().path == str(tmp_path)


# -- the signature helpers (reference TestSignatureHelpers) -------------------

SHAPES = [(1,), (3, 100, 1024), (2, 7), (64, 1024, 1024, 64), (5, 129, 1),
          (16, 512, 12, 64), (1000, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_shape_bucket_equals_the_reference(shape):
    assert autotune.shape_bucket(shape) == ref_autotune.shape_bucket(shape)


def test_short_dtype():
    import jax.numpy as jnp
    assert autotune.short_dtype(torch.bfloat16) == "bf16" \
        == ref_autotune.short_dtype(jnp.bfloat16)
    assert autotune.short_dtype(torch.float32) == "f32" \
        == ref_autotune.short_dtype(jnp.float32)


def test_device_platform_is_the_lead_tensors():
    assert autotune.device_platform(3, torch.zeros(1)) == "cpu"
    assert autotune.device_platform(torch.zeros(1, device="meta")) == "meta"
    assert autotune.device_platform("no tensor") == "cpu"


def test_source_version_stable_and_real():
    v1 = autotune.source_version("paddle_tpu_torch.ops.cuda.flash_attention")
    v2 = autotune.source_version("paddle_tpu_torch.ops.cuda.flash_attention")
    assert v1 == v2 and v1 != "unknown" and len(v1) == 12
    with_cu = autotune.source_version(
        "paddle_tpu_torch.ops.cuda.flash_attention",
        str(port_fa.CSRC / "flash_attn_fwd_tc.cu"))
    assert with_cu != v1 and len(with_cu) == 12


class _RecordingTuner:
    """Stands in for a tuner: records the signatures it is asked."""

    def __init__(self):
        self.sigs = []

    def get(self, op, sig, **kw):
        self.sigs.append(sig)
        return kw["fallback"]

    def searchable(self, platform=None):
        return True


@pytest.mark.parametrize("bh, s, d, causal", [
    (64, 1024, 64, True), (96, 512, 64, False), (32, 1024, 128, True),
    (12, 512, 64, False), (100, 2048, 64, True)])
def test_flash_signatures_equal_the_reference(bh, s, d, causal,
                                              monkeypatch):
    """The port's tile signatures are the reference's strings."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas import flash_attention as ref_fa
    rec = _RecordingTuner()
    prev = ref_autotune.set_tuner(rec)
    try:
        ref_fa._tuned_fwd_blocks(bh, s, s, d, jnp.bfloat16, causal, False)
        ref_fa._tuned_bwd_blocks(bh, s, s, d, jnp.bfloat16, causal, False)
    finally:
        ref_autotune.set_tuner(prev)
    assert rec.sigs == [
        port_fa._signature("fwd", bh, s, s, d, torch.bfloat16, causal),
        port_fa._signature("bwd", bh, s, s, d, torch.bfloat16, causal)]


# -- the fusion policy (reference TestFusionPolicy) -------------------------

def _ffn_args(dtype=torch.float32, grad=True):
    rng = np.random.RandomState(0)
    arrs = [rng.randn(4, 8), rng.randn(8, 16), rng.randn(16),
            rng.randn(16, 8), rng.randn(8)]
    return [torch.tensor(a.astype("float32"), dtype=dtype,
                         requires_grad=grad) for a in arrs]


def test_auto_cpu_uses_fallback_table(monkeypatch):
    """Off the card the table answers: an entry routes its (op, dtype,
    direction) unfused, everything else stays fused."""
    from paddle_tpu_torch.ops.fused_ffn import fused_ffn
    monkeypatch.setitem(autotune._POLICY_FALLBACK,
                        ("fused_ffn", "bf16", "fwd_bwd"), "unfused")
    y32 = fused_ffn(*_ffn_args(torch.float32))
    assert autotune.counters()["policy_fused"] == 1
    assert "FusedFFN" in type(y32.grad_fn).__name__
    ybf = fused_ffn(*_ffn_args(torch.bfloat16))
    assert autotune.counters()["policy_unfused"] == 1
    assert "FusedFFN" not in type(ybf.grad_fn).__name__
    assert autotune.counters()["searches"] == 0


def test_auto_direction_split(monkeypatch):
    """One op and dtype, two directions: flash attention's f32 forward
    routes to the math path by the table, its training call stays on the
    kernel (the plain versions, on the host)."""
    monkeypatch.setitem(autotune._POLICY_FALLBACK,
                        ("flash_attention", "f32", "fwd"), "unfused")
    monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
    rng = np.random.RandomState(1)
    qkv = [torch.tensor(rng.randn(1, 256, 2, 64).astype("float32"))
           for _ in range(3)]
    with torch.no_grad():
        port_attn.scaled_dot_product_attention(*qkv, is_causal=True)
    assert autotune.counters()["policy_unfused"] == 1
    qkv = [t.requires_grad_() for t in qkv]
    out = port_attn.scaled_dot_product_attention(*qkv, is_causal=True)
    assert autotune.counters()["policy_fused"] == 1
    assert "FlashAttention" in type(out.grad_fn).__name__


def _timed_tuner(tmp_path, times, seen, fusion_search=True):
    """A searchable stand-in for the card whose measurement runs the probe
    and returns the scripted time of the form it ran."""
    def measure(fn, args):
        fn(*args)
        return times[seen[-1]]
    return Autotuner(cache_dir=str(tmp_path), measure_fn=measure,
                     searchable=lambda: True, fusion_search=fusion_search)


def _forms(seen, fail=None):
    def fused(t):
        seen.append("fused")
        if fail == "fused":
            raise RuntimeError("the fused form does not launch")
        return t * 2.0

    def unfused(t):
        seen.append("unfused")
        return t + t
    return fused, unfused


def test_auto_is_the_table_on_a_card_too(tmp_path):
    """Under auto a searchable placement still takes the table's form: the
    scripted timings favour the unfused form, nothing is timed, and the
    cache stays empty."""
    seen = []
    prev = autotune.set_tuner(_timed_tuner(
        tmp_path, {"fused": 2.0, "unfused": 1.0}, seen, fusion_search=False))
    try:
        _, choice = autotune.choose_fused("scripted_op", *_forms(seen),
                                          (torch.ones(3),))
    finally:
        autotune.set_tuner(prev)
    assert choice == "fused" and seen == []
    assert autotune.counters()["searches"] == 0
    assert list(tmp_path.iterdir()) == []


def test_fusion_search_picks_the_measured_winner(tmp_path):
    """A tuner made with fusion_search=True times the two forms (the
    reference's auto on its device): the faster wins, once a signature."""
    seen = []
    prev = autotune.set_tuner(_timed_tuner(
        tmp_path, {"fused": 2.0, "unfused": 1.0}, seen))
    try:
        picks = [autotune.choose_fused("scripted_op", *_forms(seen),
                                       (torch.ones(3),))[1]
                 for _ in range(2)]
    finally:
        autotune.set_tuner(prev)
    assert picks == ["unfused", "unfused"]
    assert autotune.counters()["searches"] == 1
    assert autotune.counters()["mem_hits"] == 1


def test_fusion_search_raises_when_a_form_fails(tmp_path):
    """A fused form that fails to launch in the search raises: the math
    or plain form never wins by the other's failure."""
    seen = []
    prev = autotune.set_tuner(_timed_tuner(
        tmp_path, {"fused": 1.0, "unfused": 2.0}, seen))
    try:
        with pytest.raises(RuntimeError, match="does not launch"):
            autotune.choose_fused("scripted_op", *_forms(seen, "fused"),
                                  (torch.ones(3),))
    finally:
        autotune.set_tuner(prev)
    assert autotune.counters()["candidate_errors"] == 0
    assert list(tmp_path.iterdir()) == []


def test_fusion_search_off_under_a_data_parallel_group(tmp_path,
                                                       monkeypatch):
    """One rank of several never times a form, even when asked: the
    table's answer is every rank's."""
    seen = []
    monkeypatch.setattr(autotune, "_data_parallel", lambda: True)
    prev = autotune.set_tuner(_timed_tuner(
        tmp_path, {"fused": 2.0, "unfused": 1.0}, seen))
    try:
        _, choice = autotune.choose_fused("scripted_op", *_forms(seen),
                                          (torch.ones(3),))
    finally:
        autotune.set_tuner(prev)
    assert choice == "fused" and seen == []


def test_flash_decision_is_versioned_by_the_kernel_sources(monkeypatch):
    """A searched flash decision is keyed by the CUDA sources of B1-B3 as
    well as by attention.py: an edited kernel is searched again."""
    rec = []

    class Recording(_RecordingTuner):
        fusion_search = True

        def get(self, op, sig, **kw):
            rec.append(kw["version"])
            return kw["fallback"]
    monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
    prev = autotune.set_tuner(Recording())
    try:
        q = torch.randn(1, 256, 2, 64)
        port_attn.scaled_dot_product_attention(q, q, q)
    finally:
        autotune.set_tuner(prev)
    assert set(port_fa.SOURCES) == {
        str(port_fa.CSRC / f) for f in (
            "flash_attn_fwd.cu", "flash_attn_fwd_tc.cu", "flash_attn_bwd.cu",
            "flash_attn_dkv_tc.cu", "flash_attn_dq_tc.cu")}
    assert rec == [autotune.source_version(
        "paddle_tpu_torch.ops.attention", *port_fa.SOURCES)]
    assert rec[0] != autotune.source_version(
        "paddle_tpu_torch.ops.attention")


def test_always_and_never_force():
    from paddle_tpu_torch.ops.fused_ffn import fused_ffn
    pt.set_flags({"FLAGS_fusion_policy": "always"})
    fused_ffn(*_ffn_args(torch.bfloat16))
    assert autotune.counters()["policy_fused"] == 1
    pt.set_flags({"FLAGS_fusion_policy": "never"})
    y = fused_ffn(*_ffn_args(torch.float32))
    assert autotune.counters()["policy_unfused"] == 1
    assert "FusedFFN" not in type(y.grad_fn).__name__


def test_policy_parity_fused_vs_unfused():
    """Both forms compute the same function: forcing either gives the
    same output and gradients."""
    from paddle_tpu_torch.ops.fused_ffn import fused_ffn
    ct = torch.tensor(np.random.RandomState(5).randn(4, 8).astype("float32"))
    got = {}
    for pol in ("always", "never"):
        pt.set_flags({"FLAGS_fusion_policy": pol})
        args = _ffn_args()
        y = fused_ffn(*args)
        (y * ct).sum().backward()
        got[pol] = [y.detach()] + [a.grad for a in args]
    for a, b in zip(got["always"], got["never"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)


def test_invalid_policy_raises():
    pt.set_flags({"FLAGS_fusion_policy": "sometimes"})
    with pytest.raises(ValueError):
        autotune.fusion_policy()


def test_decision_recorded_as_a_sample(monkeypatch):
    from paddle_tpu_torch.ops.fused_ffn import fused_ffn
    events = []
    monkeypatch.setattr(autotune, "_record",
                        lambda name, value: events.append((name, value)))
    monkeypatch.setitem(autotune._POLICY_FALLBACK,
                        ("fused_ffn", "bf16", "fwd_bwd"), "unfused")
    fused_ffn(*_ffn_args(torch.bfloat16))
    assert ("fusion_policy/fused_ffn", 0.0) in events


def test_decision_reaches_the_metrics_registry():
    from paddle_tpu_torch.ops.fused_ffn import fused_ffn
    from paddle_tpu_torch.profiler.metrics import get_registry
    before = len(get_registry().counter_samples("fusion_policy/fused_ffn"))
    fused_ffn(*_ffn_args())
    samples = get_registry().counter_samples("fusion_policy/fused_ffn")
    assert len(samples) == before + 1 and samples[-1][-1] == 1.0


def test_recompute_direction_hint():
    """Inside recompute the region's decisions are for a differentiated
    region, even where the body runs under no_grad."""
    from paddle_tpu_torch.distributed.fleet.utils import recompute
    seen = []

    def body(x):
        with torch.no_grad():
            seen.append(autotune.current_direction())
        return x * 2.0
    with torch.no_grad():
        assert autotune.current_direction() == "fwd"
    x = torch.ones(3, requires_grad=True)
    recompute(body, x).sum().backward()
    assert seen[0] == "fwd_bwd"
    assert autotune._FORCE_DIRECTION[0] is None


# -- the flash tiles (reference TestFlashBlockFallbacks) ---------------------

def test_tile_fallbacks_deterministic():
    cpu = torch.device("cpu")
    bf16 = torch.bfloat16
    assert port_fa._tuned_fwd_blocks(64, 1024, 1024, 64, bf16, True,
                                     cpu) == (64, 64)
    assert port_fa._tuned_bwd_blocks(64, 1024, 1024, 64, bf16, True,
                                     cpu) == (64, 64, 64, 64)
    # B2's query step is 32 at head dim 128, fixed in the kernel
    assert port_fa._tuned_bwd_blocks(32, 1024, 1024, 128, bf16, True,
                                     cpu) == (32, 64, 64, 64)
    # f32 keeps one tile: no search even where one could run
    assert port_fa._tuned_fwd_blocks(64, 1024, 1024, 64, torch.float32,
                                     True, torch.device("cuda", 0)) \
        == (64, 64)
    assert autotune.counters()["searches"] == 0


def test_backward_plain_version_matches_the_reference_at_any_blocks():
    """Blocks change scheduling, never numerics: the reference's backward
    at its tuned and at pinned blocks, and the port's plain version (what
    every tile is held to on the card), agree."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.flash_attention import (flash_attention_bwd,
                                                       flash_attention_fwd)
    rng = np.random.RandomState(0)
    arrs = [rng.randn(1, 256, 2, 64).astype("float32") for _ in range(4)]
    q, k, v, do = (jnp.asarray(a) for a in arrs)
    out, lse = flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    tuned = flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                scale=0.125)
    pinned = flash_attention_bwd(q, k, v, out, lse, do, causal=True,
                                 scale=0.125, block_q=128, block_k=64)
    tq, tk, tv, tdo = (torch.tensor(a) for a in arrs)
    tout, tlse = port_fa.flash_attention_fwd(tq, tk, tv, True, 0.125)
    port = port_fa.flash_attention_bwd(tq, tk, tv, tout, tlse, tdo, True,
                                       0.125)
    for a, b, c in zip(tuned, pinned, port):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=2e-4,
                                   atol=2e-4)


# -- both packages under always and never -----------------------------------

def _ref_grads(fn, arrays, ct, low=()):
    """The reference's output and gradients of sum(out * ct) through its
    eager autograd, as f32 numpy; the operands at indices ``low`` in
    bf16."""
    ts = []
    for i, a in enumerate(arrays):
        t = paddle.to_tensor(a)
        if i in low:
            t = t.astype("bfloat16")
        t.stop_gradient = False
        ts.append(t)
    out = fn(*ts)
    out = out[0] if isinstance(out, (tuple, list)) else out
    (out.astype("float32") * paddle.to_tensor(ct)).sum().backward()
    return [np.asarray(v._val).astype(np.float32)
            for v in [out] + [t.grad for t in ts]]


def _port_grads(fn, arrays, ct, low=()):
    ts = [torch.tensor(a, dtype=torch.bfloat16 if i in low
                       else torch.float32, requires_grad=True)
          for i, a in enumerate(arrays)]
    out = fn(*ts)
    out = out[0] if isinstance(out, (tuple, list)) else out
    (out.float() * torch.tensor(ct)).sum().backward()
    return [v.detach().float().numpy() for v in [out] + [t.grad for t in ts]]


def _op_cases():
    from paddle_tpu.ops.fused_conv_bn import fused_conv_bn as r_cbn
    from paddle_tpu.ops.fused_ffn import fused_ffn as r_ffn
    from paddle_tpu.ops.fused_residual_ln import fused_residual_ln as r_rln

    from paddle_tpu_torch.ops.fused_conv_bn import fused_conv_bn as p_cbn
    from paddle_tpu_torch.ops.fused_ffn import fused_ffn as p_ffn
    from paddle_tpu_torch.ops.fused_residual_ln import \
        fused_residual_ln as p_rln
    rng = np.random.RandomState(2)

    def f(*shape, scale=1.0):
        return (rng.randn(*shape) * scale).astype("float32")
    return {
        "fused_ffn": (lambda *a: r_ffn(*a, activation="gelu"),
                      lambda *a: p_ffn(*a, activation="gelu"),
                      [f(2, 6, 8), f(8, 16, scale=0.3), f(16, scale=0.1),
                       f(16, 8, scale=0.3), f(8, scale=0.1)], (2, 6, 8)),
        "fused_residual_ln": (r_rln, p_rln,
                              [f(2, 6, 16), f(2, 6, 16),
                               1.0 + f(16, scale=0.1), f(16, scale=0.1)],
                              (2, 6, 16)),
        "fused_conv_bn": (
            lambda x, w, g, b: r_cbn(x, w, g, b, training=True, padding=1),
            lambda x, w, g, b: p_cbn(x, w, g, b, training=True, padding=1),
            [f(2, 3, 6, 6), f(4, 3, 3, 3, scale=0.3),
             1.0 + f(4, scale=0.1), f(4, scale=0.1)], (2, 4, 6, 6)),
    }


# the operands each op takes in bf16 in the bf16 cases: every one for the
# FFN and the residual LN, x and w for conv + BN (f32 gamma, beta and
# statistics, as tests/test_torch_fused_conv_bn.py's bf16 case)
BF16_OPERANDS = {"fused_ffn": (0, 1, 2, 3, 4), "fused_residual_ln": (0, 1, 2, 3),
                 "fused_conv_bn": (0, 1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["always", "never"])
@pytest.mark.parametrize("op", ["fused_ffn", "fused_residual_ln",
                                "fused_conv_bn"])
def test_fused_ops_agree_with_the_reference_under_policy(op, policy, dtype):
    """f32 elementwise (1e-5 relative, 2e-5 absolute); bf16 within 2^-6 of
    each output's or grad's largest value, a few bf16 ulps, the bound of
    tests/test_torch_fused_conv_bn.py's bf16 case (both sides compute in
    f32 from the same bf16 operands and round to bf16 at other places)."""
    ref_fn, port_fn, arrays, out_shape = _op_cases()[op]
    low = BF16_OPERANDS[op] if dtype == "bfloat16" else ()
    ct = np.random.RandomState(3).randn(*out_shape).astype("float32")
    ref_set_flags({"FLAGS_fusion_policy": policy})
    pt.set_flags({"FLAGS_fusion_policy": policy})
    want = _ref_grads(ref_fn, arrays, ct, low)
    got = _port_grads(port_fn, arrays, ct, low)
    c = autotune.counters()
    assert c["policy_fused" if policy == "always" else "policy_unfused"] \
        == 1
    for i, (g, w) in enumerate(zip(got, want)):
        if low:
            gap = np.abs(g - w).max()
            assert gap <= 2 ** -6 * (np.abs(w).max() + 1e-6), (i, gap)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["always", "never"])
def test_flash_attention_agrees_with_the_reference_under_policy(
        policy, dtype, monkeypatch):
    """Flash attention's selection on a (stand-in) card: always takes the
    kernel path (its plain versions here), never the math path; both
    agree with the reference's sdpa under the same flag: f32 elementwise,
    bf16 within relative L2 2^-7 (the tensor-core bound of
    tests/test_torch_flash_attention*.py)."""
    from paddle_tpu.ops import attention as ref_attn
    from paddle_tpu.ops.pallas import flash_attention as ref_fa
    monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
    monkeypatch.setattr(ref_attn, "_pallas_available", lambda: True)
    monkeypatch.setattr(ref_fa, "_interpret", lambda x=None: True)
    rng = np.random.RandomState(4)
    arrays = [rng.randn(1, 256, 2, 64).astype("float32") for _ in range(3)]
    ct = rng.randn(1, 256, 2, 64).astype("float32")
    ref_set_flags({"FLAGS_fusion_policy": policy})
    pt.set_flags({"FLAGS_fusion_policy": policy})
    low = (0, 1, 2) if dtype == "bfloat16" else ()
    want = _ref_grads(lambda q, k, v: ref_attn.scaled_dot_product_attention(
        q, k, v, is_causal=True), arrays, ct, low)
    got = _port_grads(lambda q, k, v: port_attn.scaled_dot_product_attention(
        q, k, v, is_causal=True), arrays, ct, low)
    for g, w in zip(got, want):
        if low:
            assert np.linalg.norm(g - w) <= 2 ** -7 * np.linalg.norm(w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-5)


def test_the_cpu_never_searches(tmp_path, monkeypatch):
    """The default tuner on the host: every op decides by the table, no
    search runs and the cache directory stays empty."""
    from paddle_tpu_torch.ops.fused_ffn import fused_ffn
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE", str(tmp_path))
    prev = autotune.set_tuner(Autotuner())
    try:
        monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
        fused_ffn(*_ffn_args()).sum().backward()
        q = torch.randn(1, 256, 2, 64, requires_grad=True)
        port_attn.scaled_dot_product_attention(q, q, q).sum().backward()
        port_fa._tuned_fwd_blocks(2, 256, 256, 64, torch.bfloat16, False,
                                  torch.device("cpu"))
    finally:
        autotune.set_tuner(prev)
    c = autotune.counters()
    assert c["searches"] == 0 and c["fallbacks"] >= 2
    assert list(tmp_path.iterdir()) == []


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__cab54d18_20_flash_attn_fwd_tc_cu_04de1ea619flash_fwd_tc_kernelILi128ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_PfS5_iifixxxxxxxxx' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__cab54d18_20_flash_attn_fwd_tc_cu_04de1ea619flash_fwd_tc_kernelILi128ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_PfS5_iifixxxxxxxxx
0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN53_GLOBAL__N__cab54d18_20_flash_attn_fwd_tc_cu_04de1ea619flash_fwd_tc_kernelILi64ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_PfS5_iifixxxxxxxxx' for 'sm_90a'
ptxas info    : Function properties for _ZN53_GLOBAL__N__cab54d18_20_flash_attn_fwd_tc_cu_04de1ea619flash_fwd_tc_kernelILi64ELi64EEEvPK13__nv_bfloat16S3_S3_PS1_PfS5_iifixxxxxxxxx
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 136 registers, used 1 barriers
"""


def test_a_spilling_tile_is_dropped(tmp_path, monkeypatch):
    """ptxas's report (an nvcc 12.8 one, with a spill written in) keyed
    by (kernel, (D, tile)); a tile that spills is no candidate."""
    from paddle_tpu_torch.ops.cuda import _build
    lib = tmp_path / "libflash_attn_fwd_tc-x.so"
    _build._ptxas_path(lib).write_text(PTXAS)
    monkeypatch.setattr(_build, "library", lambda name: None)
    monkeypatch.setattr(_build, "library_path", lambda name: lib)
    monkeypatch.setattr(port_fa, "kernel_resources",
                        _build.kernel_resources)
    port_fa.tile_candidates.cache_clear()
    try:
        report = _build.kernel_resources("flash_attn_fwd_tc")
        # the template's (D, BQ)
        assert report[("flash_fwd_tc_kernel", (128, 64))] == {
            "spill_stores": 8, "spill_loads": 4, "registers": 255}
        kept, dropped = port_fa.tile_candidates(port_fa.KERNEL_NAME, 64)
        assert kept == (64,) and "not in" in dropped[128]
        kept, dropped = port_fa.tile_candidates(port_fa.KERNEL_NAME, 128)
        assert kept == () and "spills 8 bytes" in dropped[64]
    finally:
        port_fa.tile_candidates.cache_clear()
