"""The chaos campaign of the port against the reference.

The reference's tests/test_campaign.py, case for case, on the port
(paddle_tpu_torch.resilience.campaign): the ``#N-M`` windowed-burst spec
grammar, ``should_inject``'s evaluation count and integrity's
flight-recorder note, the sampler drawing only from the injection-site
manifest (the port's copy, ``resilience/injection_sites.py``), campaign
determinism, the shrinker on a seeded leaky eviction, and the invariant
checks. Then against the reference itself: the same (seed, episodes)
draws identical schedules and identical episode outcomes in both
packages, the port's site names equal the reference tool's
(``tools/check_injection_points.py``), every entry point the port's
manifest lists carries a hook, and the expert engine's dangling-resize
invariant. Everything runs on the host (``set_device("cpu")``) on the
campaign's fake clock.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as ref_paddle
from paddle_tpu.resilience import campaign as R

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.resilience import campaign as C
from paddle_tpu_torch.resilience import faults, recorder
from paddle_tpu_torch.resilience.faults import FaultRegistry, should_inject

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_campaign_state(tmp_path, monkeypatch):
    """Fresh process-global state per test, artifacts into tmp_path, zero
    retry backoff — the same hygiene the engine applies between episodes."""
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "artifacts"))
    before = port_device._current
    paddle.set_device("cpu")
    for P, M in ((paddle, C), (ref_paddle, R)):
        P.set_flags({"FLAGS_retry_backoff_base": 0.0})
        M._reset_globals()
    yield
    for P, M in ((paddle, C), (ref_paddle, R)):
        M._reset_globals()
        P.set_flags({"FLAGS_retry_backoff_base": 0.5})
    port_device._current = before


# ---------------------------------------------------------------------------
# spec grammar: windowed bursts and the truthy-count contract


class TestWindowRule:
    def test_window_fires_inclusive_range(self):
        reg = FaultRegistry()
        reg.configure("x.op:#3-5", seed=1)
        fired = [bool(reg.should_fail("x.op")) for _ in range(7)]
        assert fired == [False, False, True, True, True, False, False]

    def test_single_evaluation_window(self):
        reg = FaultRegistry()
        reg.configure("x.op:#2-2", seed=1)
        fired = [bool(reg.should_fail("x.op")) for _ in range(4)]
        assert fired == [False, True, False, False]

    def test_window_end_before_start_rejected(self):
        reg = FaultRegistry()
        with pytest.raises(ValueError, match="window end"):
            reg.configure("x.op:#5-2")

    def test_window_start_below_one_rejected(self):
        reg = FaultRegistry()
        with pytest.raises(ValueError, match="call index"):
            reg.configure("x.op:#0-5")

    def test_window_missing_end_rejected(self):
        reg = FaultRegistry()
        with pytest.raises(ValueError):
            reg.configure("x.op:#3-")

    def test_window_missing_start_rejected(self):
        reg = FaultRegistry()
        with pytest.raises(ValueError):
            reg.configure("x.op:#-4")

    def test_window_composes_with_other_rules(self):
        # independent per-site streams: the window on one site never
        # perturbs the index rule on another
        reg = FaultRegistry()
        reg.configure("a.op:#2-3,b.op:#4", seed=9)
        a = [bool(reg.should_fail("a.op")) for _ in range(4)]
        b = [bool(reg.should_fail("b.op")) for _ in range(4)]
        assert a == [False, True, True, False]
        assert b == [False, False, False, True]


class TestShouldInjectCount:
    def test_returns_evaluation_count_when_fired(self):
        faults.configure("c.site:#2-3", seed=0)
        assert should_inject("c.site") is False
        assert should_inject("c.site") == 2
        assert should_inject("c.site") == 3
        assert should_inject("c.site") is False

    def test_rate_rule_returns_count_too(self):
        faults.configure("c.site:1.0", seed=0)
        assert should_inject("c.site") == 1
        assert should_inject("c.site") == 2

    def test_inactive_registry_is_falsy_and_uncounted(self):
        faults.reset()
        assert not should_inject("c.site")
        assert faults.stats() == {}

    def test_bitflip_corruption_recorded_in_flight_recorder(self):
        from paddle_tpu_torch.resilience.integrity import checksum_state
        state = {"w": np.ones((2, 2), np.float32)}
        clean = checksum_state(state)
        faults.configure("device.bitflip:#2", seed=0)
        first = checksum_state(state)
        second = checksum_state(state)
        assert first == clean
        assert second != clean
        notes = [e for e in recorder.get_recorder().entries()
                 if e.get("op") == "device.bitflip"]
        assert len(notes) == 1
        # seq pins WHICH evaluation was corrupted, for post-mortems
        # against the fault schedule
        assert notes[0]["seq"] == 2
        assert notes[0]["status"] == "corrupted"


# ---------------------------------------------------------------------------
# the sampler and the injection-site manifest


class TestScheduleSampler:
    def test_sampler_pool_is_the_site_manifest(self):
        assert set(C.ScheduleSampler().sites()) == set(C.known_sites())

    def test_manifest_edit_propagates_without_restart(self, monkeypatch):
        mod = C._site_manifest_module()
        monkeypatch.setattr(mod, "SITES", ["fake.alpha", "fake.beta"])
        assert C.known_sites() == ("fake.alpha", "fake.beta")
        sampler = C.ScheduleSampler()
        import random
        sched = sampler.sample(random.Random("edit-test"))
        assert {site for site, _ in sched.rules} <= {"fake.alpha",
                                                     "fake.beta"}

    def test_sampled_specs_parse_and_stay_on_manifest(self):
        import random
        sampler = C.ScheduleSampler()
        manifest = set(C.known_sites())
        for i in range(20):
            sched = sampler.sample(random.Random(f"sample:{i}"))
            assert 1 <= len(sched) <= 4
            assert {site for site, _ in sched.rules} <= manifest
            # every sampled spec must be a valid registry program
            reg = FaultRegistry()
            reg.configure(sched.spec(), seed=1)
            assert reg.active

    def test_schedule_without_drops_one_rule(self):
        sched = C.Schedule([("a.x", "#1"), ("b.y", "0.5"), ("c.z", "#2-4")])
        assert sched.without(1).spec() == "a.x:#1,c.z:#2-4"
        assert len(sched.without(0)) == 2


# ---------------------------------------------------------------------------
# determinism


class TestDeterminism:
    def test_schedules_are_byte_identical_across_engines(self):
        e1 = C.CampaignEngine(episodes=12, seed=7)
        e2 = C.CampaignEngine(episodes=12, seed=7)
        specs1 = [e1.schedule_for(i).spec() for i in range(12)]
        specs2 = [e2.schedule_for(i).spec() for i in range(12)]
        assert specs1 == specs2
        # a different campaign seed draws different schedules
        e3 = C.CampaignEngine(episodes=12, seed=8)
        assert specs1 != [e3.schedule_for(i).spec() for i in range(12)]

    def test_campaign_outcomes_identical_across_runs(self):
        r1 = C.CampaignEngine(episodes=4, seed=3).run()
        r2 = C.CampaignEngine(episodes=4, seed=3).run()
        assert (json.dumps(r1["episodes"], sort_keys=True)
                == json.dumps(r2["episodes"], sort_keys=True))
        assert r1["coverage"] == r2["coverage"]


# ---------------------------------------------------------------------------
# the shrinker on a seeded known-bad mutation


def _leaky_evict_for(DecodeEngine):
    """Plant the bug the campaign exists to catch: an eviction path that,
    when the injected decode.evict fault fires, marks the stream done
    WITHOUT returning its KV blocks to the pool. The fault-free path
    mirrors the real eviction (release, terminate, finish the trace)."""
    from paddle_tpu_torch.resilience.faults import maybe_inject
    from paddle_tpu_torch.profiler.tracing import get_tracer

    def buggy(self, stream, error):
        leak = False
        try:
            maybe_inject("decode.evict", ConnectionError)
        except ConnectionError:
            leak = True
        if stream.done:
            return
        self._streams.pop(stream.id, None)
        if stream._admitted and self._admission is not None:
            stream._admitted = False
            self._admission.note_done()
        if not leak and stream.table is not None:
            # BUG under injection: the block-table release is skipped,
            # so the stream's KV blocks never go back to the pool
            stream.table.release()
        stream.error = error
        stream.done = True
        get_tracer().finish(stream.trace, status="error", error=error)
        stream._done_evt.set()

    return buggy


class TestShrinker:
    def test_leak_detected_and_shrunk_to_minimal_repro(self, tmp_path):
        from paddle_tpu_torch.serving.decode.engine import DecodeEngine
        buggy = _leaky_evict_for(DecodeEngine)
        engine = C.CampaignEngine(episodes=1, seed=0,
                                  scenarios=[C.ServingScenario()])
        # a 4-rule schedule where only decode.evict matters: the shrinker
        # must strip the three decoys
        sched = C.Schedule([("decode.evict", "#1+"),
                            ("fs.download", "0.05"),
                            ("serving.hedge", "#9"),
                            ("kv.transfer", "#12+")])
        import unittest.mock
        with unittest.mock.patch.object(DecodeEngine, "_evict", buggy):
            info, violations = engine.run_episode(
                engine.scenarios[0], sched, fault_seed=11)
            assert any(v["invariant"] == "kv-leak" for v in violations), \
                violations
            minimal, runs = engine.shrink_schedule(
                engine.scenarios[0], sched, fault_seed=11,
                violations=violations)
        assert len(minimal) <= 2, minimal.spec()
        assert ("decode.evict", "#1+") in minimal.rules
        assert runs <= engine.max_shrink_runs

    def test_campaign_run_emits_bundle_for_violation(self, tmp_path,
                                                     monkeypatch):
        from paddle_tpu_torch.serving.decode.engine import DecodeEngine
        monkeypatch.setattr(DecodeEngine, "_evict",
                            _leaky_evict_for(DecodeEngine))
        engine = C.CampaignEngine(episodes=1, seed=0,
                                  scenarios=[C.ServingScenario()])
        monkeypatch.setattr(
            engine, "schedule_for",
            lambda i: C.Schedule([("decode.evict", "#1+"),
                                  ("rollout.watch", "#20")]))
        report = engine.run()
        assert report["violations_total"] >= 1
        ep = report["episodes"][0]
        assert any(v["invariant"] == "kv-leak" for v in ep["violations"])
        assert ep["minimal_spec"] is not None
        assert "decode.evict:#1+" in ep["minimal_spec"]
        assert report["artifact_bundles"]
        bundle = report["artifact_bundles"][0]
        repro = json.loads(
            open(os.path.join(bundle, "repro.json")).read())
        assert repro["minimal_spec"] == ep["minimal_spec"]
        assert repro["scenario"] == "serving"
        assert "paddle_tpu_torch.resilience.campaign" in repro["replay"]


# ---------------------------------------------------------------------------
# invariant checks on synthetic episode infos


class TestInvariants:
    def test_untyped_failure_flagged(self):
        info = {"scenario": "serving", "outcome": "completed",
                "untyped": ["ValueError: boom"], "requests": []}
        viol = C.check_invariants(info)
        assert any(v["invariant"] == "typed-termination" for v in viol)

    def test_unterminated_request_flagged(self):
        info = {"scenario": "serving", "outcome": "completed", "untyped": [],
                "requests": [{"id": "r1", "kind": "infer", "done": False,
                              "error": None, "typed": True}]}
        viol = C.check_invariants(info)
        assert any(v["invariant"] == "typed-termination" for v in viol)

    def test_leak_flagged(self):
        info = {"scenario": "serving", "outcome": "completed", "untyped": [],
                "requests": [], "leaked_blocks": 3}
        viol = C.check_invariants(info)
        assert any(v["invariant"] == "kv-leak" for v in viol)

    def test_dangling_migration_flagged(self):
        info = {"scenario": "serving", "outcome": "completed", "untyped": [],
                "requests": [],
                "journal": [{"event": "migration_export", "stream": "s1"}]}
        viol = C.check_invariants(info)
        assert any(v["invariant"] == "journal-consistency" for v in viol)

    def test_terminal_migration_clean(self):
        info = {"scenario": "serving", "outcome": "completed", "untyped": [],
                "requests": [],
                "journal": [{"event": "migration_export", "stream": "s1"},
                            {"event": "migration_release", "stream": "s1"}]}
        assert not C.check_invariants(info)

    def test_stall_flagged_as_bounded_progress(self):
        info = {"scenario": "serving", "outcome": "stalled", "untyped": [],
                "requests": [], "deadlock": True}
        viol = C.check_invariants(info)
        assert any(v["invariant"] == "bounded-progress" for v in viol)

    def test_training_parity_mismatch_flagged(self):
        golden = {"final_digest": "aaa", "losses": [1.0, 0.5]}
        info = {"scenario": "training", "outcome": "completed",
                "untyped": [], "requests": [],
                "final_digest": "bbb", "losses": [1.0, 0.5]}
        viol = C.check_invariants(info, golden=golden)
        assert any(v["invariant"] == "training-parity" for v in viol)


# ---------------------------------------------------------------------------
# the port against the reference


def _tool():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_injection_points",
        os.path.join(REPO, "tools", "check_injection_points.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestAgainstReference:
    def test_site_names_equal_the_tools(self):
        from paddle_tpu_torch.resilience import injection_sites
        tool = _tool()
        assert injection_sites.SITES == tool.SITES
        assert C.known_sites() == R.known_sites()
        assert injection_sites.HOOK_CALLS == tool.HOOK_CALLS
        # the same entry points, at the port's paths
        assert [(p.replace("paddle_tpu_torch/", "paddle_tpu/"), sc, names)
                for p, sc, names in injection_sites.REQUIRED] == \
            tool.REQUIRED

    def test_every_listed_entry_point_carries_a_hook(self):
        """The reference's injection-points lint over the port's files:
        each listed function the scope defines calls a hook or hands one
        on (``retry_call(self._injected_run, ...)``)."""
        import ast
        from paddle_tpu_torch.resilience import injection_sites
        missing = []
        for path, scope, names in injection_sites.REQUIRED:
            tree = ast.parse(open(os.path.join(REPO, path)).read())
            if scope == "module":
                body = tree.body
            else:
                cls = [n for n in tree.body if isinstance(n, ast.ClassDef)
                       and n.name == scope.split(":", 1)[1]]
                assert cls, (path, scope)
                body = cls[0].body
            funcs = {n.name: n for n in body
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))}
            for name in names:
                if name not in funcs:
                    continue
                used = {n.id if isinstance(n, ast.Name) else n.attr
                        for n in ast.walk(funcs[name])
                        if isinstance(n, (ast.Name, ast.Attribute))}
                if not used & injection_sites.HOOK_CALLS:
                    missing.append(f"{path}:{scope}.{name}")
        assert not missing, missing

    def test_every_site_is_evaluated_somewhere_in_the_port(self):
        import re
        names = set()
        for root, _, files in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
            for f in files:
                if f.endswith(".py"):
                    names |= set(re.findall(
                        r'(?:maybe_inject|should_inject|fault_point|'
                        r'_injected_run)\(\s*f?"([a-z_0-9.]+)"',
                        open(os.path.join(root, f)).read()))
        # fs.py's HDFS paths pass their site through _injected_run's
        # argument; every other site is named at its call
        assert set(C.known_sites()) - names <= {"fs.upload", "fs.download",
                                               "fs.mv"}

    def test_schedules_identical_to_the_references(self):
        port = C.CampaignEngine(episodes=12, seed=7)
        ref = R.CampaignEngine(episodes=12, seed=7)
        specs = [port.schedule_for(i).spec() for i in range(12)]
        assert specs == [ref.schedule_for(i).spec() for i in range(12)]
        assert [port.episode_seed(i) for i in range(12)] == \
            [ref.episode_seed(i) for i in range(12)]

    @pytest.mark.parametrize("seed", [0, 7])
    def test_episode_outcomes_identical_to_the_references(self, seed):
        """Both packages run the same schedules through both scenarios:
        the same outcomes, typed faults, violations (none) and coverage."""
        port = C.CampaignEngine(episodes=6, seed=seed).run()
        C._reset_globals()
        ref = R.CampaignEngine(episodes=6, seed=seed).run()
        assert port["violations_total"] == ref["violations_total"] == 0
        assert port["episodes"] == ref["episodes"]
        assert port["coverage"] == ref["coverage"]

    def test_campaign_invariant_flags_dangling_resize(self):
        """The expert engine's case (the reference's
        tests/test_expert_parallel.py): a moe_resize_started with no
        terminal record violates journal consistency, a completed one
        does not."""
        info = {"journal": [{"event": "moe_resize_started",
                             "resize": "resize-1"}]}
        v = C.check_invariants(info)
        assert any(x["invariant"] == "journal-consistency" for x in v)
        assert v == R.check_invariants(info)
        info["journal"].append({"event": "moe_resize_completed",
                                "resize": "resize-1"})
        assert not C.check_invariants(info)

    def test_command_line_replays_one_episode(self, capsys):
        rc = C.main(["--scenario", "serving", "--spec",
                     "decode.evict:#2,kv.transfer:#1", "--fault-seed", "3"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0 and out["violations"] == []
        assert out["outcome"] == "completed"
        assert out["spec"] == "decode.evict:#2,kv.transfer:#1"
