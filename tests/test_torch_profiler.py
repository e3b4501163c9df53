"""The port's profiler host API (profiler/__init__.py), case by case with
the host-API cases of the reference's tests/test_observability.py: the
always-on ``record_counter`` bridge and its per-session sample ring, the
scheduler windows, step instants and the samples/sec gauge, RecordEvent's
categories and ``summary``, ``export_rank_trace``'s alignment metadata,
and the step timer's ``step_phase`` spans.

Across the packages: the same span sequence exports a chrome trace whose
events carry the reference's keys and values, ``tools/trace_merge.py``
reads the port's ``trace_rank<N>.json`` files, and the serving metrics'
``export_to_profiler`` lands its counters on both packages' tracks.
Against torch: a RecordEvent is a user annotation of a CPU
``torch.profiler`` window, and a ``Profiler`` with a GPU target writes
that window's own trace. The clocks are faked where a rate is measured.
"""
import json
import sys
import threading
from pathlib import Path

import pytest

pytest.importorskip("jax")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import trace_merge  # noqa: E402

from paddle_tpu import profiler as rprofiler  # noqa: E402
from paddle_tpu.profiler import metrics as rmetrics  # noqa: E402

from paddle_tpu_torch import profiler  # noqa: E402
from paddle_tpu_torch.profiler import metrics as pmetrics  # noqa: E402
from paddle_tpu_torch.profiler import steptimer  # noqa: E402
from paddle_tpu_torch.resilience import faults  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_state():
    for mod in (profiler, rprofiler):
        mod._recorder.enabled = False
        mod.reset_profiler()
    faults.reset()
    pmetrics.reset_registry()
    rmetrics.reset_registry()
    steptimer.reset_steptimer()
    yield
    for mod in (profiler, rprofiler):
        mod._recorder.enabled = False
        mod.reset_profiler()
    faults.reset()
    pmetrics.reset_registry()
    rmetrics.reset_registry()
    steptimer.reset_steptimer()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


# -- record_counter (always on) ------------------------------------------------

def test_record_counter_without_profiler_session():
    profiler.record_counter("integrity.check_ms", 4.0)
    profiler.record_counter("integrity.check_ms", 6.0)
    samples = profiler.counter_samples("integrity.check_ms")
    assert [v for _, _, v in samples] == [4.0, 6.0]
    s = pmetrics.get_registry().histogram_summary("integrity.check_ms")
    assert s["count"] == 2 and s["sum"] == 10.0
    # not tracing: nothing on the chrome track
    assert profiler._recorder.chrome_trace()["traceEvents"] == []


def test_counter_samples_cleared_per_session_aggregates_survive():
    profiler.record_counter("integrity.check_ms", 4.0)
    profiler.start_profiler()
    assert profiler.counter_samples("integrity.check_ms") == []
    profiler.record_counter("integrity.check_ms", 6.0)
    assert len(profiler.counter_samples("integrity.check_ms")) == 1
    counters = [e for e in profiler._recorder.chrome_trace()["traceEvents"]
                if e["ph"] == "C"]
    assert counters[0]["args"] == {"value": 6.0}
    assert counters[0]["cat"] == "counter"
    profiler.stop_profiler()
    s = pmetrics.get_registry().histogram_summary("integrity.check_ms")
    assert s["count"] == 2


# -- the scheduler and step instants --------------------------------------------

def test_profiler_step_scheduler_windows():
    ready = []
    prof = profiler.Profiler(scheduler=(1, 1, 2, 2), timer_only=True,
                             on_trace_ready=lambda p: ready.append(
                                 p._step_num))
    prof.start()
    phases = [prof.phase]
    for _ in range(9):
        prof.step()
        phases.append(prof.phase)
    prof.stop()
    # cycle = skip 1 + warmup 1 + active 2; repeat 2: the active windows
    # end as steps 4 and 8 begin, and stop() fires no third callback
    assert ready == [4, 8]
    assert phases == ["closed", "warmup", "active", "active", "closed",
                      "warmup", "active", "active", "closed", "closed"]


def test_profiler_scheduler_validation():
    with pytest.raises(ValueError):
        profiler.Profiler(scheduler=(0, 0, 0, 1))
    with pytest.raises(ValueError):
        profiler.Profiler(scheduler=(-1, 0, 1, 1))


def test_warmup_spans_are_dropped_active_spans_kept():
    prof = profiler.Profiler(scheduler=(0, 1, 1, 1), timer_only=True)
    prof.start()
    with profiler.RecordEvent("in_warmup"):
        pass
    prof.step()
    with profiler.RecordEvent("in_active"):
        pass
    spans = {e["name"] for e in profiler._recorder.chrome_trace()[
        "traceEvents"] if e["ph"] == "X"}
    assert spans == {"in_active"}
    prof.stop()


def test_profiler_step_instants_and_samples_gauge(monkeypatch):
    ns = [10_000_000]
    monkeypatch.setattr(profiler.time, "perf_counter_ns", lambda: ns[0])
    with profiler.Profiler(timer_only=True) as prof:
        prof.step(num_samples=32)
        ns[0] += 2_000_000        # 2 ms
        prof.step(num_samples=32)
    rate = pmetrics.get_registry().gauge_value("profiler.samples_per_sec")
    assert rate == pytest.approx(32 / 0.002)
    instants = [e for e in profiler._recorder.chrome_trace()["traceEvents"]
                if e.get("ph") == "i"]
    assert [e["args"]["step"] for e in instants] == [0, 1]
    assert all(e["name"] == "profiler.step" for e in instants)


def test_record_event_type_category_filter(capsys):
    with profiler.Profiler(timer_only=True):
        with profiler.RecordEvent("fwd", event_type="Forward"):
            pass
        with profiler.RecordEvent("bwd", event_type="Backward"):
            pass
        with profiler.RecordEvent("plain"):
            pass
    assert set(profiler._recorder.aggregate(event_type="Forward")) == {"fwd"}
    cats = profiler._recorder.categories()
    assert cats["fwd"] == "Forward" and cats["plain"] == "host"
    table = profiler.summary(event_type="Backward")
    assert "bwd" in table and "fwd" not in table
    assert "bwd" in capsys.readouterr().out


def test_record_event_decorator_and_disabled_recorder():
    @profiler.RecordEvent("decorated", event_type="Fn")
    def f(x):
        return x + 1

    assert f(1) == 2   # not recording: the span goes nowhere
    assert profiler._recorder.aggregate() == {}
    with profiler.Profiler(timer_only=True):
        f(2)
        f(3)
    tot, cnt, mx = profiler._recorder.aggregate()["decorated"]
    assert cnt == 2 and tot >= mx >= 0


def test_classic_profiler_context(capsys):
    with profiler.profiler():
        with profiler.RecordEvent("classic"):
            pass
    assert "classic" in capsys.readouterr().out
    profiler.reset_profiler()
    assert profiler._recorder.aggregate() == {}


# -- the step timer's spans ------------------------------------------------------

def test_steptimer_emits_step_phase_spans():
    clk = FakeClock()
    st = steptimer.StepTimer(clock=clk, sync_interval=0, enabled=True,
                             registry=pmetrics.MetricsRegistry())
    with profiler.Profiler(timer_only=True):
        with st.step():
            with st.phase("step/compute"):
                clk.advance(0.010)
                with st.phase("step/collective_wait"):
                    clk.advance(0.004)
            with st.phase("step/integrity"):
                clk.advance(0.002)
    evs = [e for e in profiler._recorder.chrome_trace()["traceEvents"]
           if e["ph"] == "X"]
    by = {e["name"]: e for e in evs}
    assert {e["cat"] for e in evs if e["name"].startswith("step/")} == \
        {"step_phase"}
    assert by["step"]["cat"] == "step"
    assert by["step/compute"]["dur"] == pytest.approx(14_000.0)
    assert by["step/collective_wait"]["dur"] == pytest.approx(4_000.0)
    assert by["step/integrity"]["dur"] == pytest.approx(2_000.0)
    assert by["step"]["dur"] == pytest.approx(16_000.0)
    assert set(profiler._recorder.aggregate(event_type="step_phase")) == \
        {"step/compute", "step/collective_wait", "step/integrity"}


def test_steptimer_spans_cost_nothing_while_not_tracing():
    clk = FakeClock()
    st = steptimer.StepTimer(clock=clk, sync_interval=0, enabled=True,
                             registry=pmetrics.MetricsRegistry())
    with st.step():
        with st.phase("step/compute"):
            clk.advance(0.001)
    assert profiler._recorder.chrome_trace()["traceEvents"] == []


# -- export_rank_trace and the reference's format ------------------------------

def test_export_rank_trace_carries_alignment_metadata(tmp_path):
    with profiler.Profiler(timer_only=True):
        with profiler.RecordEvent("work"):
            pass
        profiler.record_counter("integrity.check_ms", 1.5)
    path = profiler.export_rank_trace(directory=str(tmp_path))
    doc = json.loads(Path(path).read_text())
    assert Path(path).name == "trace_rank0.json"
    assert {"wall_s", "ts_us"} <= set(doc["anchor"])
    assert doc["rank"] == 0 and doc["generation"] == 0
    assert doc["displayTimeUnit"] == "ms"
    assert any(e.get("name") == "work" for e in doc["traceEvents"])
    assert any(e.get("name") == "integrity.check_ms" and e["ph"] == "C"
               for e in doc["traceEvents"])


def test_export_rank_trace_defaults_to_the_artifacts_dir(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "art"))
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    with profiler.Profiler(timer_only=True):
        pass
    path = profiler.export_rank_trace()
    assert path == str(tmp_path / "art" / "trace_rank3.json")
    assert json.loads(Path(path).read_text())["rank"] == 3


def _drive(mod):
    """One span sequence through a package's profiler: a scheduler window
    with nested and categorised spans, a counter and an instant."""
    prof = mod.Profiler(scheduler=(1, 0, 2, 1), timer_only=True)
    prof.start()
    prof.step()
    with mod.RecordEvent("outer", event_type="Forward"):
        with mod.RecordEvent("inner"):
            pass
    mod.record_counter("integrity.check_ms", 2.5)
    prof.step()
    with mod.RecordEvent("second"):
        pass
    trace = mod._recorder.chrome_trace()
    prof.stop()
    return trace


def test_chrome_trace_matches_the_references_keys():
    ours, ref = _drive(profiler), _drive(rprofiler)
    assert set(ours) == set(ref)

    def shape(trace):
        return [(e["ph"], e["name"], e.get("cat"), sorted(e),
                 e.get("args") if e["ph"] != "i" else
                 sorted(e["args"]))
                for e in trace["traceEvents"]]
    assert shape(ours) == shape(ref)
    spans = [e for e in ours["traceEvents"] if e["ph"] == "X"]
    assert {"name", "ph", "cat", "ts", "dur", "tid"} <= set(spans[0])
    # nested: the inner span lies inside the outer one
    by = {e["name"]: e for e in spans}
    assert by["outer"]["ts"] <= by["inner"]["ts"]
    assert by["inner"]["ts"] + by["inner"]["dur"] <= \
        by["outer"]["ts"] + by["outer"]["dur"] + 1e-3


def test_trace_merge_reads_the_ports_rank_traces(tmp_path, monkeypatch):
    clk = FakeClock()
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path))
    for rank, compute in ((0, 0.060), (1, 0.090)):
        monkeypatch.setenv("PADDLE_TRAINER_ID", str(rank))
        steptimer.reset_steptimer()
        st = steptimer.StepTimer(clock=clk, sync_interval=0, enabled=True,
                                 registry=pmetrics.MetricsRegistry())
        with profiler.Profiler(timer_only=True):
            for _ in range(2):
                with st.step():
                    with st.phase("step/compute"):
                        clk.advance(compute)
                    with st.phase("step/input_wait"):
                        clk.advance(0.095 - compute)
            profiler.export_rank_trace()
    assert sorted(p.name for p in tmp_path.glob("trace_rank*.json")) == \
        ["trace_rank0.json", "trace_rank1.json"]
    trace, info = trace_merge.merge(trace_merge.load_inputs([str(tmp_path)]))
    assert info["ranks"] == [0, 1] and info["unaligned_ranks"] == []
    summary = trace_merge.summarize(trace)
    assert summary["step/compute"]["slowest_rank"] == 1
    assert summary["step/compute"]["slowest_ms"] == pytest.approx(180.0)
    assert summary["step/input_wait"]["slowest_rank"] == 0
    assert trace_merge.main([str(tmp_path)]) == 0


def test_serving_metrics_export_to_profiler():
    from paddle_tpu.serving.metrics import ServingMetrics as RefMetrics

    from paddle_tpu_torch.serving.metrics import ServingMetrics
    got = {}
    for name, mod, cls in (("port", profiler, ServingMetrics),
                           ("ref", rprofiler, RefMetrics)):
        m = cls()
        m.inc("admitted", 3)
        m.observe_latency(0.02)
        mod.start_profiler()
        snap = m.export_to_profiler(prefix="srv")
        got[name] = sorted(
            (e["name"], e["args"]["value"])
            for e in mod._recorder.chrome_trace()["traceEvents"]
            if e["ph"] == "C")
        mod._recorder.enabled = False
        assert snap["admitted"] == 3
    assert got["port"] == got["ref"]
    assert ("srv.admitted", 3) in got["port"]


# -- against torch.profiler ----------------------------------------------------

def test_record_event_is_a_user_annotation_in_torch_profiler():
    import torch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.RecordEvent("port.span"):
            torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert "port.span" in names
    # no torch window and no host recording: no annotation is opened
    ev = profiler.RecordEvent("quiet")
    ev.begin()
    assert ev._annotation is None
    ev.end()


def test_gpu_target_writes_its_own_device_trace():
    import torch
    ready = []
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        scheduler=(1, 0, 1, 1), on_trace_ready=lambda p: ready.append(
            p.device_trace_path))
    prof.start()
    assert prof.torch_profiler is None      # skipped step: no window yet
    prof.step()
    with profiler.RecordEvent("step.body"):
        torch.ones(4).add(1)
    prof.step()
    prof.stop()
    assert ready and ready[0] == prof.device_trace_path
    doc = json.loads(Path(ready[0]).read_text())
    assert any(e.get("name") == "step.body" for e in doc["traceEvents"])
    assert any(e.name == "step.body" for e in prof.torch_profiler.events())
    # the host recorder saw the same span
    assert "step.body" in profiler._recorder.aggregate()


def test_timer_only_and_cpu_target_open_no_device_window():
    for kw in ({"timer_only": True},
               {"targets": [profiler.ProfilerTarget.CPU]}):
        with profiler.Profiler(**kw) as prof:
            pass
        assert prof.torch_profiler is None and prof.device_trace_path is None


def test_record_counter_is_thread_safe_while_tracing():
    profiler.start_profiler()

    def work(i):
        for j in range(200):
            profiler.record_counter(f"c{i}", float(j))
    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    counters = [e for e in profiler._recorder.chrome_trace()["traceEvents"]
                if e["ph"] == "C"]
    assert len(counters) == 800
    profiler.stop_profiler()
