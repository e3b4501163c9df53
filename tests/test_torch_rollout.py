"""Live rollout and the autoscaler of the port against the reference.

The reference's tests/test_rollout.py, case for case, on the port
(paddle_tpu_torch.serving.rollout): the manifest watcher (newest committed,
torn manifests skipped, kills at every commit boundary), the canary →
roll → complete/rollback machine with its golden gate, pins, chaos seams
``rollout.{watch,load,swap,verify}``, restart through the version loader,
resume from the journal, version stamps on the wire and the soak; then
the autoscaler cases of the reference's tests/test_overload.py on the
port (warm scale-up, drain-first scale-down, forced fencing, the band,
injected ``serving.scale`` failures, concurrent tick/describe, the 10x
overload soak with an attached autoscaler). Then both packages on the same
schedule: the same journal events, version stamps, replies and replica
counts, and manifests that one package's checkpointer committed found and
loaded by the other's watcher. All on injected fake clocks with no real
sleeps; the predictors are exact doubles, so replies compare exactly.
"""
import json
import os
import threading

import numpy as np
import pytest

import paddle_tpu as ref_paddle
import paddle_tpu.serving as ref_serving
from paddle_tpu.profiler import metrics as ref_pmetrics
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.resilience import recovery as ref_recovery
from paddle_tpu.resilience import snapshot as ref_snapshot

import paddle_tpu_torch as paddle
from paddle_tpu_torch import serving
from paddle_tpu_torch.distributed import wire
from paddle_tpu_torch.profiler import metrics as pmetrics
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.resilience import recovery
from paddle_tpu_torch.resilience import snapshot as port_snapshot
from paddle_tpu_torch.resilience.snapshot import (
    AsyncCheckpointer, list_manifests, load_manifest_blob, manifest_name,
    pinned_manifests, read_pins, write_pin,
)
from paddle_tpu_torch.serving import (
    Autoscaler, AutoscalerConfig, GoldenMismatch, InferenceServer,
    ManifestWatcher, RolloutConfig, RolloutController, RolloutError,
    ServingConfig,
)

class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class ScalePredictor:
    """Multiplies input[0] by ``scale`` — the output proves which weights
    served it. Optionally advances a clock (synthetic service time)."""

    def __init__(self, scale=2.0, clock=None, service_s=0.0):
        self.scale = float(scale)
        self.calls = 0
        self._clock = clock
        self._service_s = service_s

    def run(self, arrays):
        self.calls += 1
        if self._clock is not None and self._service_s:
            self._clock.advance(self._service_s)
        return [np.asarray(arrays[0]) * self.scale]


DEFAULT_FLAGS = {
    "FLAGS_rollout_poll_interval": 30.0,
    "FLAGS_rollout_golden_max_drift": 1.0,
    "FLAGS_rollout_drain_timeout": 60.0,
    "FLAGS_rollout_max_step_failures": 3,
    "FLAGS_preflight_checks": True,
    "FLAGS_serving_step_timeout": 60.0,
    "FLAGS_serving_max_queue": 256,
    "FLAGS_serving_admission_target_ms": 100.0,
    "FLAGS_serving_breaker_failures": 5,
    "FLAGS_serving_breaker_window": 30.0,
    "FLAGS_serving_breaker_cooldown": 10.0,
    "FLAGS_serving_hedge_budget": 0.05,
    "FLAGS_serving_hedge_min_ms": 10.0,
    "FLAGS_serving_retry_after": 0.1,
}


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    """Both packages' fault registries and metric registries fresh, and
    their flags at the defaults, before and after every case."""
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "artifacts"))
    for P, flt, reg in ((paddle, faults, pmetrics),
                        (ref_paddle, ref_faults, ref_pmetrics)):
        flt.reset()
        reg.reset_registry()
        P.set_flags(DEFAULT_FLAGS)
    yield
    for P, flt, reg in ((paddle, faults, pmetrics),
                        (ref_paddle, ref_faults, ref_pmetrics)):
        flt.reset()
        reg.reset_registry()
        P.set_flags(DEFAULT_FLAGS)


def _counters():
    return pmetrics.get_registry().snapshot()["counters"]


GOLDEN = [[np.ones((1, 3), "float32")]]


def loader_for(root):
    def loader(path, idx):
        blob = load_manifest_blob(path)
        return ScalePredictor(blob["model"]["scale"])
    return loader


def commit(ckpt, scale):
    """One committed version; returns its manifest seq."""
    path = ckpt.save({"model.pdparams": ({"scale": float(scale)}, "model")})
    return int(os.path.basename(path).split("-")[1].split(".")[0])


def make_rollout(tmp_path, replicas=2, goldens=GOLDEN, launch_scale=2.0,
                 **cfg_kw):
    clock = FakeClock()
    srv = InferenceServer(
        lambda i: ScalePredictor(launch_scale),
        ServingConfig(max_batch_size=4, replicas=replicas), clock=clock)
    root = str(tmp_path / "ckpt")
    ckpt = AsyncCheckpointer(root, keep=cfg_kw.pop("keep", 3),
                             background=False)
    cfg_kw.setdefault("poll_interval", 1.0)
    cfg_kw.setdefault("golden_max_drift", 10.0)
    rc = srv.attach_rollout(root, loader_for(root), goldens=goldens,
                            config=RolloutConfig(**cfg_kw))
    return srv, rc, ckpt, clock


def settle(rc, clock, rounds=30, dt=0.5):
    """Tick until the controller returns to IDLE (or rounds exhaust). The
    clock advances first and a few rounds always run, so a poll interval
    armed by an earlier pump/tick can't mask the pending roll."""
    for i in range(rounds):
        clock.advance(dt)
        st = rc.tick()
        if i >= 2 and st == RolloutController.IDLE and rc.target is None:
            return
    raise AssertionError(f"controller never settled: {rc.describe()}")


def x(rows=1, fill=1.0):
    return [np.full((rows, 3), fill, "float32")]


# -- wire stamp helpers ------------------------------------------------------

class TestWireStamp:
    def test_roundtrip(self):
        frame = wire.stamp_model_version({"outputs": []}, 7)
        assert frame["model_version"] == 7
        assert wire.frame_model_version(frame) == 7

    def test_absent_means_unstamped(self):
        assert wire.frame_model_version({"outputs": []}) is None
        assert wire.frame_model_version(b"not a dict") is None

    def test_none_version_leaves_frame_unstamped(self):
        frame = wire.stamp_model_version({"outputs": []}, None)
        assert "model_version" not in frame


# -- manifest watcher --------------------------------------------------------

class TestManifestWatcher:
    def test_empty_root_returns_none(self, tmp_path):
        assert ManifestWatcher(str(tmp_path)).poll() is None

    def test_picks_newest_committed(self, tmp_path):
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, background=False)
        commit(ckpt, 3.0)
        s2 = commit(ckpt, 4.0)
        seq, path = ManifestWatcher(root).poll()
        assert seq == s2 and os.path.basename(path) == manifest_name(s2)

    def test_nothing_newer_than_current(self, tmp_path):
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, background=False)
        s1 = commit(ckpt, 3.0)
        assert ManifestWatcher(root).poll(current_seq=s1) is None

    def test_rejected_seq_skipped(self, tmp_path):
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, background=False)
        s1 = commit(ckpt, 3.0)
        s2 = commit(ckpt, 4.0)
        seq, _ = ManifestWatcher(root).poll(rejected={s2})
        assert seq == s1

    def test_torn_manifest_skipped_counted_never_loaded(self, tmp_path):
        # a manifest referencing files that never landed (the torn window
        # an interrupted writer without atomic rename would leave)
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, background=False)
        s1 = commit(ckpt, 3.0)
        torn = os.path.join(root, manifest_name(99))
        with open(torn, "w") as f:
            f.write('{"seq": 99, "files": {"data-0000000099/m.pdparams": '
                    '{"sha256": "' + "0" * 64 + '", "bytes": 1}}}')
        seq, path = ManifestWatcher(root).poll()
        assert seq == s1            # fell through to the older good one
        assert _counters().get("rollout.skipped_torn_total") == 1.0

    def test_torn_then_clean_commit_picked_up(self, tmp_path):
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, background=False)
        commit(ckpt, 3.0)
        with open(os.path.join(root, manifest_name(50)), "w") as f:
            f.write('{"seq": 50, "files": {"data-0000000050/m.pdparams": '
                    '{"sha256": "' + "1" * 64 + '", "bytes": 1}}}')
        w = ManifestWatcher(root)
        assert w.poll()[0] == 1
        # a clean commit past the torn one is discovered on the next poll
        ckpt._seq = 50              # force the next save past the torn seq
        s = commit(ckpt, 5.0)
        assert w.poll()[0] == s
        assert load_manifest_blob(
            os.path.join(root, manifest_name(s)))["model"]["scale"] == 5.0

    # two data-file boundaries don't exist here (single file), so each save
    # has two ckpt.commit evaluations: before the data file and before the
    # manifest rename. A kill at either leaves NO new manifest (the rename
    # IS the commit) — the watcher must keep answering with the old one.
    @pytest.mark.parametrize("boundary", [1, 2])
    def test_kill_at_every_commit_boundary(self, tmp_path, boundary):
        from paddle_tpu_torch.resilience.snapshot import CheckpointCommitError
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, background=False)
        s1 = commit(ckpt, 3.0)
        w = ManifestWatcher(root)
        faults.configure(f"ckpt.commit:#{boundary}")
        with pytest.raises(CheckpointCommitError):
            ckpt.save({"model.pdparams": ({"scale": 9.0}, "model")},
                      blocking=True)
        faults.reset()
        found = w.poll()
        assert found[0] == s1       # never a torn/uncommitted manifest
        s3 = commit(ckpt, 4.0)      # clean commit past the gap
        assert w.poll()[0] == s3

    def test_watch_fault_site(self, tmp_path):
        faults.configure("rollout.watch:1.0")
        with pytest.raises(RolloutError):
            ManifestWatcher(str(tmp_path)).poll()


# -- happy-path roll ---------------------------------------------------------

class TestRollHappyPath:
    def test_canary_then_full_roll(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        before = {r.idx for r in srv.scheduler.replicas}
        s1 = commit(ckpt, 3.0)
        settle(rc, clock)
        assert rc.version == s1 and rc.state == RolloutController.IDLE
        reps = srv.scheduler.replicas
        assert len(reps) == 2
        assert all(r.version == s1 and r.healthy for r in reps)
        # every original replica was drained out, none force-fenced
        assert not ({r.idx for r in reps} & before)
        out = srv.infer(x())
        assert np.allclose(out[0], 3.0)
        assert srv.stats()["shed"] == 0

    def test_journal_and_metrics(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        commit(ckpt, 3.0)
        settle(rc, clock)
        events = [e["event"] for e in rc.journal.entries()]
        assert events == ["rollout_started", "rollout_canary_passed",
                          "rollout_completed"]
        c = _counters()
        assert c.get("rollout.started_total") == 1.0
        assert c.get("rollout.completed_total") == 1.0

    def test_replies_version_stamped(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        req0 = srv.submit(x())
        srv.pump_until_done(req0)
        assert req0.version is None          # launch weights: unstamped
        s1 = commit(ckpt, 3.0)
        settle(rc, clock)
        req = srv.submit(x())
        srv.pump_until_done(req)
        assert req.version == s1
        snap = srv.metrics.snapshot()
        assert snap["requests_vunset"] == 1
        assert snap[f"requests_v{s1}"] == 1
        assert _counters().get(
            f'serving.requests_total{{version="{s1}"}}') == 1.0

    def test_poll_interval_gates_watching(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path, poll_interval=10.0)
        rc.tick()                            # first tick always polls
        commit(ckpt, 3.0)
        rc.tick()
        assert rc.state == RolloutController.IDLE   # interval not elapsed
        clock.advance(10.5)
        rc.tick()
        assert rc.state == RolloutController.CANARY

    def test_pins_written_for_incumbent_and_prior(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s1 = commit(ckpt, 3.0)
        settle(rc, clock)
        s2 = commit(ckpt, 4.0)
        clock.advance(2.0)
        settle(rc, clock)
        assert rc.version == s2 and rc.prior == s1
        pinned = pinned_manifests(rc.root)
        assert manifest_name(s1) in pinned and manifest_name(s2) in pinned
        assert read_pins(rc.root)["serving"] == sorted(
            [manifest_name(s1), manifest_name(s2)])
        import json
        from paddle_tpu_torch.resilience.snapshot import pin_path
        with open(pin_path(rc.root, "serving")) as f:
            doc = json.load(f)
        assert doc["incumbent"] == s2 and doc["prior"] == s1

    def test_sequential_versions_roll_in_order(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        for scale in (3.0, 4.0, 5.0):
            s = commit(ckpt, scale)
            clock.advance(2.0)
            settle(rc, clock)
            assert rc.version == s
            assert np.allclose(srv.infer(x())[0], scale)
        completed = [e["version"] for e in rc.journal.entries()
                     if e["event"] == "rollout_completed"]
        assert completed == [1, 2, 3]

    def test_capacity_held_during_roll(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path, replicas=3)
        commit(ckpt, 3.0)
        low = 99
        for _ in range(40):
            st = rc.tick()
            placeable = len([r for r in srv.scheduler.replicas
                             if r.placeable()])
            if st != RolloutController.IDLE:
                low = min(low, placeable)
            clock.advance(0.5)
            if st == RolloutController.IDLE and rc.version is not None:
                break
        assert rc.version == 1
        assert low >= 3              # never dipped below roll-start capacity


# -- canary failure / rollback ----------------------------------------------

class TestRollback:
    def test_nan_golden_fails_canary(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s_bad = commit(ckpt, float("nan"))
        settle(rc, clock)
        assert rc.version is None and s_bad in rc._rejected
        assert all(r.version is None and r.healthy
                   for r in srv.scheduler.replicas)
        assert np.allclose(srv.infer(x())[0], 2.0)   # incumbent serving
        events = [e["event"] for e in rc.journal.entries()]
        assert "rollout_canary_failed" in events
        assert "rollout_rolled_back" in events
        assert srv.stats()["shed"] == 0
        assert _counters().get("rollout.rolled_back_total") == 1.0

    def test_golden_drift_gate(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path,
                                            golden_max_drift=0.25)
        # scale 2.0 -> 3.0 is 50% relative drift: over the 25% gate
        s_bad = commit(ckpt, 3.0)
        settle(rc, clock)
        assert s_bad in rc._rejected and rc.version is None
        failed = [e for e in rc.journal.entries()
                  if e["event"] == "rollout_canary_failed"]
        assert "drift" in failed[0]["error"]

    def test_custom_golden_check(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(
            tmp_path, golden_check=lambda outs, ref: False)
        s_bad = commit(ckpt, 3.0)
        settle(rc, clock)
        assert s_bad in rc._rejected

    def test_rejected_version_never_retried(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        commit(ckpt, float("nan"))
        settle(rc, clock)
        started = len([e for e in rc.journal.entries()
                       if e["event"] == "rollout_started"])
        for _ in range(5):
            rc.tick()
            clock.advance(2.0)
        assert len([e for e in rc.journal.entries()
                    if e["event"] == "rollout_started"]) == started
        # only a NEWER commit ends the quarantine
        s_good = commit(ckpt, 4.0)
        clock.advance(2.0)
        settle(rc, clock)
        assert rc.version == s_good

    def test_rollback_restores_prior_checkpoint_version(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s1 = commit(ckpt, 3.0)
        settle(rc, clock)
        commit(ckpt, float("nan"))
        clock.advance(2.0)
        settle(rc, clock)
        # rollback restored the CHECKPOINTED incumbent, not launch weights
        assert rc.version == s1
        assert all(r.version == s1 for r in srv.scheduler.replicas)
        assert np.allclose(srv.infer(x())[0], 3.0)

    def test_canary_death_rolls_back(self, tmp_path):
        class DyingPredictor(ScalePredictor):
            def run(self, arrays):
                raise ConnectionError("device lost")

        clock = FakeClock()
        srv = InferenceServer(lambda i: ScalePredictor(2.0),
                              ServingConfig(max_batch_size=4, replicas=2),
                              clock=clock)
        root = str(tmp_path / "ckpt")
        ckpt = AsyncCheckpointer(root, background=False)

        def loader(path, idx):
            return DyingPredictor()
        rc = srv.attach_rollout(root, loader, goldens=GOLDEN,
                                config=RolloutConfig(poll_interval=1.0,
                                                     golden_max_drift=10.0))
        s_bad = commit(ckpt, 3.0)
        settle(rc, clock, rounds=60)
        assert s_bad in rc._rejected
        assert "rollout_canary_failed" in [
            e["event"] for e in rc.journal.entries()]
        assert np.allclose(srv.infer(x())[0], 2.0)

    def test_midroll_goal_replica_death_rolls_back(self, tmp_path):
        # the goal version passes its canary, then a goal replica dies
        # mid-roll: evidence against the target -> reverse the roll
        state = {"alive": True}

        class FlakyPredictor(ScalePredictor):
            def run(self, arrays):
                if not state["alive"]:
                    raise ConnectionError("died mid-roll")
                return super().run(arrays)

        clock = FakeClock()
        srv = InferenceServer(lambda i: ScalePredictor(2.0),
                              ServingConfig(max_batch_size=4, replicas=3),
                              clock=clock)
        root = str(tmp_path / "ckpt")
        ckpt = AsyncCheckpointer(root, background=False)

        def loader(path, idx):
            return FlakyPredictor(3.0)
        rc = srv.attach_rollout(root, loader, goldens=GOLDEN,
                                config=RolloutConfig(poll_interval=1.0,
                                                     golden_max_drift=10.0))
        s_bad = commit(ckpt, 3.0)
        # pass the canary, enter ROLLING
        for _ in range(20):
            if rc.tick() == RolloutController.ROLLING:
                break
            clock.advance(0.5)
        assert rc.state == RolloutController.ROLLING
        # kill the canary by running traffic through it while poisoned
        state["alive"] = False
        goal = [r for r in srv.scheduler.replicas if r.version == s_bad]
        try:
            goal[0].executor.run(x())
        except ConnectionError:
            pass
        from paddle_tpu_torch.serving.scheduler import ReplicaDead
        srv.scheduler._mark_dead(goal[0], ReplicaDead("mid-roll death"))
        state["alive"] = True
        settle(rc, clock, rounds=60)
        assert s_bad in rc._rejected and rc.version is None
        assert "rollout_rollback_begin" in [
            e["event"] for e in rc.journal.entries()]
        assert all(r.version is None for r in srv.scheduler.replicas)
        assert np.allclose(srv.infer(x())[0], 2.0)


# -- chaos seams -------------------------------------------------------------

class TestInjectionSites:
    def test_load_failure_journals_and_rolls_back(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s_bad = commit(ckpt, 3.0)
        faults.configure("rollout.load:1.0")
        settle(rc, clock, rounds=60)
        faults.reset()
        assert s_bad in rc._rejected
        events = [e["event"] for e in rc.journal.entries()]
        assert "rollout_step_failed" in events
        assert "rollout_rolled_back" in events
        assert srv.stats()["shed"] == 0
        assert np.allclose(srv.infer(x())[0], 2.0)

    def test_verify_failure_rolls_back(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s_bad = commit(ckpt, 3.0)
        faults.configure("rollout.verify:1.0")
        settle(rc, clock, rounds=60)
        faults.reset()
        assert s_bad in rc._rejected
        assert _counters().get("rollout.canary_failures_total") == 1.0

    def test_watch_failure_retries_next_poll(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s1 = commit(ckpt, 3.0)
        faults.configure("rollout.watch:#1")    # first poll only
        rc.tick()
        assert rc.state == RolloutController.IDLE
        assert "rollout_step_failed" in [
            e["event"] for e in rc.journal.entries()]
        faults.reset()
        clock.advance(2.0)
        settle(rc, clock)
        assert rc.version == s1                 # recovered on the next poll

    def test_transient_swap_failure_retried(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s1 = commit(ckpt, 3.0)
        faults.configure("rollout.swap:#1")     # one failed roll step
        settle(rc, clock, rounds=60)
        faults.reset()
        assert rc.version == s1                 # retried, then completed
        assert _counters().get("rollout.step_failures_total") == 1.0

    def test_persistent_swap_failure_rolls_back(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path,
                                            max_step_failures=2)
        s_bad = commit(ckpt, 3.0)
        # fail every swap: the roll exhausts max_step_failures and flips
        # into ROLLBACK — which keeps retrying and never abandons, so the
        # fault lifts once rollback has begun (a stuck rollback is the
        # runbook's pager case, not an automatic give-up)
        faults.configure("rollout.swap:1.0")
        for _ in range(40):
            clock.advance(0.5)
            if rc.tick() == RolloutController.ROLLBACK:
                break
        assert rc.state == RolloutController.ROLLBACK
        faults.reset()
        settle(rc, clock, rounds=60)
        assert s_bad in rc._rejected and rc.version is None
        assert np.allclose(srv.infer(x())[0], 2.0)
        assert srv.stats()["shed"] == 0


# -- retention pins (GC satellite) -------------------------------------------

class TestRetentionPins:
    def test_pinned_manifest_survives_aggressive_keep(self, tmp_path):
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, keep=1, background=False)
        s1 = commit(ckpt, 3.0)
        write_pin(root, "serving", [manifest_name(s1)])
        for scale in (4.0, 5.0, 6.0):
            commit(ckpt, scale)
        ckpt.gc()
        live = {s for s, _ in list_manifests(root)}
        assert s1 in live                     # pinned: survived keep=1
        assert 2 not in live and 3 not in live
        # the pinned manifest still LOADS (its data files survived too)
        blob = load_manifest_blob(os.path.join(root, manifest_name(s1)))
        assert blob["model"]["scale"] == 3.0

    def test_unpinned_manifests_still_collected(self, tmp_path):
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, keep=2, background=False)
        for scale in (3.0, 4.0, 5.0, 6.0):
            commit(ckpt, scale)
        ckpt.gc()
        assert [s for s, _ in list_manifests(root)] == [4, 3]

    def test_clear_pin_releases_retention(self, tmp_path):
        from paddle_tpu_torch.resilience.snapshot import clear_pin
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, keep=1, background=False)
        s1 = commit(ckpt, 3.0)
        write_pin(root, "serving", [manifest_name(s1)])
        commit(ckpt, 4.0)
        commit(ckpt, 5.0)
        clear_pin(root, "serving")
        ckpt.gc()
        assert [s for s, _ in list_manifests(root)] == [3]

    def test_damaged_pin_file_skipped_fail_open(self, tmp_path):
        root = str(tmp_path / "ck")
        ckpt = AsyncCheckpointer(root, keep=1, background=False)
        commit(ckpt, 3.0)
        os.makedirs(os.path.join(root, "pins"), exist_ok=True)
        with open(os.path.join(root, "pins", "bad.json"), "w") as f:
            f.write("{not json")
        assert pinned_manifests(root) == set()
        commit(ckpt, 4.0)
        ckpt.gc()                             # must not raise
        assert [s for s, _ in list_manifests(root)] == [2]

    def test_rollout_keeps_rollback_manifest_under_gc(self, tmp_path):
        # the full satellite scenario: aggressive keep-K churns while a
        # rollout holds incumbent+prior — rollback must still be loadable
        srv, rc, ckpt, clock = make_rollout(tmp_path, keep=1)
        s1 = commit(ckpt, 3.0)
        settle(rc, clock)
        s2 = commit(ckpt, 4.0)
        clock.advance(2.0)
        settle(rc, clock)
        for scale in (5.0, 6.0):              # churn past keep=1...
            commit(ckpt, scale)
        ckpt.gc()
        live = {s for s, _ in list_manifests(rc.root)}
        assert s1 in live and s2 in live      # ...but the pins held


# -- restart_dead versioning (scheduler satellite) ---------------------------

class TestRestartVersioning:
    def test_restart_uses_current_version_loader(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s1 = commit(ckpt, 3.0)
        settle(rc, clock)
        from paddle_tpu_torch.serving.scheduler import ReplicaDead
        rep = srv.scheduler.replicas[0]
        srv.scheduler._mark_dead(rep, ReplicaDead("host died"))
        restarted = srv.scheduler.restart_dead()
        assert rep.idx in restarted
        # the regression: WITHOUT the fix this resurrects launch weights
        # (scale 2.0, version None); WITH it the replica rejoins at the
        # rolled-out version
        assert rep.version == s1
        assert np.allclose(rep.executor.run(x())[0], 3.0)

    def test_restart_without_rollout_keeps_launch_factory(self, tmp_path):
        clock = FakeClock()
        srv = InferenceServer(lambda i: ScalePredictor(2.0),
                              ServingConfig(max_batch_size=4, replicas=2),
                              clock=clock)
        from paddle_tpu_torch.serving.scheduler import ReplicaDead
        rep = srv.scheduler.replicas[0]
        srv.scheduler._mark_dead(rep, ReplicaDead("died"))
        assert rep.idx in srv.scheduler.restart_dead()
        assert rep.version is None
        assert np.allclose(rep.executor.run(x())[0], 2.0)

    def test_restarted_replica_reply_stamped(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path, replicas=1)
        s1 = commit(ckpt, 3.0)
        settle(rc, clock, rounds=60)
        from paddle_tpu_torch.serving.scheduler import ReplicaDead
        rep = srv.scheduler.replicas[0]
        srv.scheduler._mark_dead(rep, ReplicaDead("died"))
        srv.scheduler.restart_dead()
        req = srv.submit(x())
        srv.pump_until_done(req)
        assert req.version == s1


# -- resume across restart ---------------------------------------------------

class TestResume:
    def _respawn(self, rc, tmp_path, replicas=2):
        """A 'restarted' server: fresh process state, same journal file
        (same job_id under the same artifacts dir)."""
        clock = FakeClock(t=100.0)
        srv = InferenceServer(
            lambda i: ScalePredictor(2.0),
            ServingConfig(max_batch_size=4, replicas=replicas), clock=clock)
        rc2 = srv.attach_rollout(
            rc.root, loader_for(rc.root), goldens=GOLDEN,
            config=RolloutConfig(poll_interval=1.0, golden_max_drift=10.0))
        return srv, rc2, clock

    def test_completed_version_adopted(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s1 = commit(ckpt, 3.0)
        settle(rc, clock)
        srv2, rc2, clock2 = self._respawn(rc, tmp_path)
        assert rc2.version == s1
        # launch-built replicas adopt the incumbent stamp, and rebuilds go
        # through the incumbent loader (operator contract: the launch
        # factory serves the newest completed version)
        assert all(r.version == s1 for r in srv2.scheduler.replicas)
        assert srv2.scheduler.current_version() == s1
        req = srv2.submit(x())
        srv2.pump_until_done(req)
        assert req.version == s1

    def test_inflight_roll_reenters_canary(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s1 = commit(ckpt, 3.0)
        rc.tick()                            # started: journal has no terminal
        assert rc.state == RolloutController.CANARY
        srv2, rc2, clock2 = self._respawn(rc, tmp_path)
        # re-proves the target on the fresh process before converging
        assert rc2.state == RolloutController.CANARY
        assert rc2.target == s1
        assert "rollout_resumed" in [
            e["event"] for e in rc2.journal.entries()]
        settle(rc2, clock2)
        assert rc2.version == s1
        assert all(r.version == s1 for r in srv2.scheduler.replicas)

    def test_rejected_versions_survive_restart(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s_bad = commit(ckpt, float("nan"))
        settle(rc, clock)
        assert s_bad in rc._rejected
        srv2, rc2, clock2 = self._respawn(rc, tmp_path)
        assert s_bad in rc2._rejected
        for _ in range(5):                   # never re-rolls the bad seq
            rc2.tick()
            clock2.advance(2.0)
        assert rc2.state == RolloutController.IDLE and rc2.target is None

    def test_rollback_restored_version_adopted(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        s1 = commit(ckpt, 3.0)
        settle(rc, clock)
        commit(ckpt, float("nan"))
        clock.advance(2.0)
        settle(rc, clock)
        assert rc.version == s1
        srv2, rc2, clock2 = self._respawn(rc, tmp_path)
        assert rc2.version == s1
        assert all(r.version == s1 for r in srv2.scheduler.replicas)


# -- autoscaler interaction --------------------------------------------------

class TestAutoscalerHold:
    def test_resizes_held_while_rolling(self, tmp_path):
        srv, rc, ckpt, clock = make_rollout(tmp_path)
        scaler = srv.attach_autoscaler(AutoscalerConfig(
            min_replicas=1, max_replicas=4, up_stable=1, down_stable=1))
        commit(ckpt, 3.0)
        rc.tick()
        assert rc.state == RolloutController.CANARY
        action = scaler.tick()
        assert action.get("held_for_rollout") is True
        assert not action["scaled_up"] and not action["scaled_down"]
        settle(rc, clock)
        # roll done: the autoscaler resumes normal decisions
        action = scaler.tick()
        assert "held_for_rollout" not in action


# -- socket/client stamp -----------------------------------------------------

class TestClientStamp:
    def test_client_sees_model_version(self, tmp_path):
        srv = InferenceServer(lambda i: ScalePredictor(2.0),
                              ServingConfig(max_batch_size=4, replicas=1,
                                            batch_wait=0.005))
        srv.scheduler.stamp_versions(7, only_unversioned=True)
        srv.start()
        try:
            with serving.SocketFrontend(srv) as fe:
                with serving.InferenceClient(fe.address) as cli:
                    assert cli.last_model_version is None
                    out = cli.infer(x(), timeout=30.0)
                    assert np.allclose(out[0], 2.0)
                    assert cli.last_model_version == 7
        finally:
            srv.stop()


# -- soak acceptance ---------------------------------------------------------

class TestSoakAcceptance:
    def test_rollout_soak(self, tmp_path):
        """The acceptance soak: traffic flowing + checkpoints committing
        mid-traffic -> the fleet converges to each new version with ZERO
        rollout-attributable sheds, every reply stamped with the version
        that served it, and an injected bad version (NaN goldens) rolls
        back with 100% incumbent serving restored."""
        clock = FakeClock()
        service_s = 0.005
        srv = InferenceServer(
            lambda i: ScalePredictor(2.0, clock=clock, service_s=service_s),
            ServingConfig(max_batch_size=4, replicas=2), clock=clock)
        root = str(tmp_path / "ckpt")
        ckpt = AsyncCheckpointer(root, keep=3, background=False)

        def loader(path, idx):
            blob = load_manifest_blob(path)
            return ScalePredictor(blob["model"]["scale"], clock=clock,
                                  service_s=service_s)
        rc = srv.attach_rollout(root, loader, goldens=GOLDEN,
                                config=RolloutConfig(poll_interval=0.4,
                                                     golden_max_drift=10.0,
                                                     drain_timeout=5.0))
        plan = [(1.5, 3.0), (3.0, float("nan")), (4.5, 5.0)]
        scales = {None: 2.0}
        committed = []
        accepted, sheds = [], 0
        dt = service_s / 2
        rate = 0.5 * 2 * 4 / service_s
        credit = 0.0
        while clock() < 6.0:
            while plan and clock() >= plan[0][0]:
                _, scale = plan.pop(0)
                seq = commit(ckpt, scale)
                committed.append((seq, scale))
                if np.isfinite(scale):
                    scales[seq] = scale
            credit += rate * dt
            while credit >= 1.0:
                credit -= 1.0
                try:
                    accepted.append(srv.submit(x()))
                except serving.ServerOverloaded:
                    sheds += 1
            srv.pump(4)
            clock.advance(dt)
        last_good = max(s for s, sc in committed if np.isfinite(sc))
        for _ in range(5000):
            ran = srv.pump(4)
            clock.advance(dt)
            if not ran and not rc.active() and rc.version == last_good \
                    and all(r.done() for r in accepted):
                break
        assert sheds == 0
        assert all(r.done() and r.error is None for r in accepted)
        # every reply's output matches the version it claims served it
        for req in accepted:
            assert req.version in scales
            assert np.allclose(np.asarray(req.result[0]),
                               scales[req.version])
        # fleet converged to the newest good version, the poison journaled
        assert rc.version == last_good
        assert all(r.version == last_good
                   for r in srv.scheduler.replicas)
        bad_seq = next(s for s, sc in committed if not np.isfinite(sc))
        rb = [e for e in rc.journal.entries()
              if e["event"] == "rollout_rolled_back"]
        assert any(e["failed"] == bad_seq for e in rb)
        # at least one request was actually served by each good version
        versions_seen = {r.version for r in accepted}
        assert last_good in versions_seen
        assert bad_seq not in versions_seen


# -- the autoscaler (the reference's tests/test_overload.py) -----------------

class DoublingPredictor:
    """Doubles input[0]; optionally advances a clock per call (synthetic
    service time) and counts distinct signatures (stand-in compiles)."""

    def __init__(self, clock=None, service_s=0.0, on_run=None):
        self.calls = 0
        self.signatures = set()
        self._clock = clock
        self._service_s = service_s
        self._on_run = on_run

    def run(self, arrays):
        self.calls += 1
        if self._clock is not None and self._service_s:
            self._clock.advance(self._service_s)
        if self._on_run is not None:
            self._on_run(self)
        self.signatures.add(tuple(
            (tuple(a.shape), str(a.dtype)) for a in arrays))
        return [np.asarray(arrays[0]) * 2.0]


class TestAutoscaler:
    def make(self, tmp_path, min_r=1, max_r=3, **kw):
        # NOT attached to the server: these tests drive tick() by hand
        # (an attached autoscaler is ticked by every pump round — the soak
        # test covers that wiring)
        clock = FakeClock()
        cfg = ServingConfig(max_batch_size=4, replicas=min_r, max_queue=256)
        srv = InferenceServer(
            lambda i: DoublingPredictor(clock=clock, service_s=0.002),
            cfg, clock=clock)
        srv.warmup((((3,), "float32"),))
        asc = Autoscaler(srv, AutoscalerConfig(
            min_replicas=min_r, max_replicas=max_r, high_watermark=4.0,
            low_watermark=1.0, up_stable=2, down_stable=3,
            drain_timeout=10.0, **kw))
        return srv, asc, clock

    def journal_events(self, asc):
        path = asc.journal.path
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def test_scales_up_under_sustained_pressure(self, tmp_path):
        srv, asc, clock = self.make(tmp_path)
        for _ in range(40):
            srv.submit(x())
        for _ in range(2):          # two ticks over the high watermark
            asc.tick()
            clock.advance(0.1)
        assert asc.replica_count() == 2
        assert srv.metrics.get("scale_ups") == 1
        # the new replica came in warm: zero compiles on live traffic
        new = srv.scheduler.find_replica(1)
        warmed = new.executor.compile_count
        while srv.pump(4):
            pass
        assert new.executor.compile_count == warmed
        events = [e["event"] for e in self.journal_events(asc)]
        assert "serving_scale_up" in events

    def test_single_spike_does_not_resize(self, tmp_path):
        srv, asc, clock = self.make(tmp_path)
        for _ in range(40):
            srv.submit(x())
        asc.tick()                  # one tick over watermark: streak = 1
        while srv.pump(4):          # drain the spike
            pass
        asc.tick()                  # back under: streak reset
        asc.tick()
        assert asc.replica_count() == 1
        assert srv.metrics.get("scale_ups") == 0

    def test_scales_down_by_draining_first(self, tmp_path):
        srv, asc, clock = self.make(tmp_path)
        for _ in range(40):
            srv.submit(x())
        for _ in range(2):
            asc.tick()
            clock.advance(0.1)
        assert asc.replica_count() == 2
        while srv.pump(4):
            pass
        gen_before = srv.scheduler.generation
        for _ in range(3):          # down_stable idle ticks begin a drain
            asc.tick()
            clock.advance(0.1)
        # idle replica: drain completes on the next tick, not by force
        asc.tick()
        assert asc.replica_count() == 1
        assert srv.metrics.get("scale_downs") == 1
        assert srv.scheduler.generation == gen_before + 1
        ev = [e for e in self.journal_events(asc)
              if e["event"] == "serving_scale_down"]
        assert ev and ev[0]["forced"] is False
        assert ev[0]["scheduler_generation"] == srv.scheduler.generation

    def test_drain_timeout_force_fences(self, tmp_path):
        srv, asc, clock = self.make(tmp_path)
        srv.scheduler.add_replica()
        victim = srv.scheduler.replicas[-1].idx
        asc.scale_down()
        srv.scheduler.find_replica(victim).inflight = 1   # stuck batch
        clock.advance(11.0)          # past drain_timeout
        removed = asc.tick()["removed"]
        assert removed == [victim]
        assert srv.scheduler.find_replica(victim) is None
        ev = [e for e in self.journal_events(asc)
              if e["event"] == "serving_scale_down"]
        assert ev and ev[-1]["forced"] is True

    def test_never_leaves_min_max_band(self, tmp_path):
        srv, asc, clock = self.make(tmp_path, min_r=1, max_r=2)
        for _ in range(200):
            srv.submit(x())
        for _ in range(20):
            asc.tick()
            clock.advance(0.1)
        assert asc.replica_count() <= 2
        while srv.pump(8):
            pass
        for _ in range(20):
            asc.tick()
            clock.advance(0.1)
        assert asc.replica_count() >= 1

    def test_injected_scale_failure_is_journaled_not_raised(self, tmp_path):
        srv, asc, clock = self.make(tmp_path)
        faults.configure("serving.scale:#1")
        for _ in range(40):
            srv.submit(x())
        for _ in range(2):
            asc.tick()
            clock.advance(0.1)
        # the injected failure was swallowed, journaled, counted
        assert asc.replica_count() == 1
        assert srv.metrics.get("scale_failures") == 1
        events = [e["event"] for e in self.journal_events(asc)]
        assert "serving_scale_failed" in events
        # and the next pressure window retries successfully
        for _ in range(2):
            asc.tick()
            clock.advance(0.1)
        assert asc.replica_count() == 2

    def test_concurrent_tick_and_describe(self, tmp_path):
        """Satellite: describe() reads the streak/drain state tick()
        mutates — both now serialize on the autoscaler lock, so threads
        hammering both must never see an exception or a torn snapshot
        (streaks are ints, draining is a list, the band holds)."""
        srv, asc, clock = self.make(tmp_path, min_r=1, max_r=3)
        for _ in range(80):
            srv.submit(x())
        stop = threading.Event()
        failures = []

        def ticker():
            try:
                for _ in range(2000):
                    asc.tick()
                    clock.advance(0.01)
            except BaseException as e:   # pragma: no cover - failure path
                failures.append(e)
            finally:
                stop.set()

        def reader():
            try:
                while not stop.is_set():
                    d = asc.describe()
                    assert isinstance(d["up_streak"], int)
                    assert isinstance(d["down_streak"], int)
                    assert isinstance(d["draining"], list)
                    assert 1 <= d["replicas"] <= 3
            except BaseException as e:   # pragma: no cover - failure path
                failures.append(e)

        threads = [threading.Thread(target=ticker),
                   threading.Thread(target=reader),
                   threading.Thread(target=reader)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not failures
        assert 1 <= asc.replica_count() <= 3


@pytest.mark.chaos
class TestOverloadSoak:
    def test_sustained_10x_with_replica_death_mid_soak(self, tmp_path):
        """The overload acceptance scenario, fake clock, zero real sleeps:

        sustained ~10x admission pressure with a replica death and a 5%
        dispatch-hang rate injected mid-soak. Every accepted request
        terminates (result or typed error), goodput stays positive,
        admitted p99 holds under the deadline, a breaker opens AND
        re-closes, and after the storm the autoscaler converges back to
        min replicas.
        """
        paddle.set_flags({"FLAGS_serving_breaker_failures": 2,
                          "FLAGS_serving_breaker_window": 1000.0,
                          "FLAGS_serving_breaker_cooldown": 0.5})
        clock = FakeClock()
        service_s = 0.005
        deadline = 2.0
        cfg = ServingConfig(max_batch_size=8, replicas=2, max_queue=64,
                            default_deadline=deadline, max_retries=2,
                            admission_target_ms=40.0)
        srv = InferenceServer(
            lambda i: DoublingPredictor(clock=clock, service_s=service_s),
            cfg, clock=clock)
        srv.warmup((((3,), "float32"),))
        asc = srv.attach_autoscaler(AutoscalerConfig(
            min_replicas=2, max_replicas=4, high_watermark=4.0,
            low_watermark=1.0, up_stable=2, down_stable=4,
            drain_timeout=5.0))
        # chaos mid-soak: one replica death, then 5% of dispatches hang
        faults.configure("serving.replica_run:#40,serving.dispatch:0.05")

        capacity = 2 * 8 / service_s           # rows/s
        rate = capacity * 10.0
        dt = 0.005
        credit, accepted, sheds, hints = 0.0, [], 0, 0
        while clock() < 3.0:
            credit += rate * dt
            while credit >= 1.0:
                credit -= 1.0
                try:
                    accepted.append(srv.submit(x()))
                except serving.ServerOverloaded as e:
                    sheds += 1
                    if e.retry_after is not None:
                        hints += 1
            srv.pump(4)
            clock.advance(dt)
        # storm over: drain, then idle ticks for the autoscaler
        rounds = 0
        while srv.pump(4):
            rounds += 1
            assert rounds < 20000
        for _ in range(30):
            srv.pump(1)
            clock.advance(0.5)

        snap = srv.stats()
        # every accepted request terminated — nothing went silent
        assert all(r.done() for r in accepted)
        ok = [r for r in accepted if r.error is None]
        errs = [r for r in accepted if r.error is not None]
        assert len(ok) > 0                        # goodput stayed positive
        for r in errs:                            # typed errors only
            assert isinstance(r.error, Exception)
        # overload was actually exercised, and every shed carried a hint
        assert sheds > 0 and hints == sheds
        # admitted work held its SLO while excess load was shed
        assert snap["latency_p99"] <= deadline
        # the injected hang rate tripped at least one breaker, and the
        # cooldown + preflight + canary closed it again
        assert snap["breaker_opens"] >= 1
        assert snap["breaker_closes"] >= 1
        # the dead replica restarted and re-warmed
        assert snap["replica_deaths"] >= 1
        assert snap["replica_restarts"] >= 1
        # elastic: scaled up under pressure, converged back to min after
        assert snap["scale_ups"] >= 1
        assert asc.replica_count() == 2
        assert not asc._draining
        # the AIMD limiter actually cut below its ceiling under overload
        assert snap["admission"]["limit"] < srv.admission.max_limit


# -- the port against the reference ------------------------------------------

PKGS = {
    "paddle_tpu": (ref_serving, ref_snapshot, ref_faults, ref_recovery,
                   ref_pmetrics),
    "paddle_tpu_torch": (serving, port_snapshot, faults, recovery,
                         pmetrics),
}


def rollout_story(name, tmp_path):
    """One schedule through one package, in pump mode on a fake clock: a
    2-replica server with an attached autoscaler (1..3) and rollout;
    traffic throughout; a good version (scale 3) rolls, a NaN version is
    refused at the canary and rolled back, a third version (scale 5) rolls
    through an injected ``rollout.swap`` failure and an injected
    ``serving.scale`` failure. Returns every reply with its version, the
    journal (fake-clock timestamps included), the controller's and the
    autoscaler's state, the replicas' versions and the counters."""
    srv_mod, snap, flt, rec, reg = PKGS[name]
    clock = FakeClock()
    srv = srv_mod.InferenceServer(
        lambda i: ScalePredictor(2.0, clock=clock, service_s=0.005),
        srv_mod.ServingConfig(max_batch_size=4, replicas=2), clock=clock)
    srv.warmup((((3,), "float32"),))
    root = str(tmp_path / name / "ckpt")
    ckpt = snap.AsyncCheckpointer(root, keep=3, background=False)
    journal = rec.RecoveryJournal(job_id="story",
                                  dir=str(tmp_path / name / "journal"),
                                  clock=clock)

    def loader(path, idx):
        return ScalePredictor(snap.load_manifest_blob(path)["model"]["scale"],
                              clock=clock, service_s=0.005)
    rc = srv.attach_rollout(root, loader, goldens=GOLDEN,
                            config=srv_mod.RolloutConfig(
                                poll_interval=0.2, golden_max_drift=10.0,
                                drain_timeout=5.0),
                            journal=journal)
    asc = srv.attach_autoscaler(srv_mod.AutoscalerConfig(
        min_replicas=1, max_replicas=3, high_watermark=4.0,
        low_watermark=1.0, up_stable=2, down_stable=6), journal=journal)
    flt.configure("rollout.swap:#2,serving.scale:#1", seed=5)
    plan = [(0.5, 3.0), (1.5, float("nan")), (2.5, 5.0)]
    reqs, sheds = [], 0
    while clock() < 4.0:
        if plan and clock() >= plan[0][0]:
            ckpt.save({"model.pdparams": ({"scale": plan.pop(0)[1]},
                                          "model")})
        burst = 12 if 1.0 <= clock() < 1.2 else 1
        for _ in range(burst):
            try:
                reqs.append(srv.submit(x(fill=float(len(reqs) % 7))))
            except srv_mod.ServerOverloaded:
                sheds += 1
        srv.pump(2)
        clock.advance(0.01)
    flt.reset()
    for _ in range(2000):
        if not srv.pump(4) and not rc.active() \
                and all(r.done() for r in reqs):
            break
        clock.advance(0.01)
    counters = reg.get_registry().snapshot()["counters"]
    return {
        "replies": [(float(np.asarray(r.result[0])[0, 0]), r.version)
                    if r.error is None else type(r.error).__name__
                    for r in reqs],
        "sheds": sheds,
        "journal": [{k: v for k, v in e.items() if k != "job"}
                    for e in journal.entries()],
        "rollout": rc.describe(), "autoscaler": asc.describe(),
        "versions": [(r.idx, r.version) for r in srv.scheduler.replicas],
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("rollout.", "serving.requests_total"))},
        "stats": {k: v for k, v in srv.stats().items()
                  if k in ("shed", "failed", "completed", "scale_ups",
                           "scale_downs", "scale_failures")}}


def test_rollout_story_matches_reference(tmp_path):
    ref = rollout_story("paddle_tpu", tmp_path)
    port = rollout_story("paddle_tpu_torch", tmp_path)
    events = [e["event"] for e in port["journal"]]
    failed = [e for e in port["journal"]
              if e["event"] == "rollout_canary_failed"]
    assert failed and GoldenMismatch.__name__ in failed[0]["error"]
    assert events.count("rollout_completed") == 2
    assert "serving_scale_failed" in events
    assert port["sheds"] == 0 and port["rollout"]["version"] == 3
    assert port["replies"] == ref["replies"]
    assert port["journal"] == ref["journal"]
    for key in ("rollout", "autoscaler", "versions", "counters", "stats",
                "sheds"):
        assert port[key] == ref[key], key
    # every reply carries the scale of the version that served it
    scales = {None: 2.0, 1: 3.0, 3: 5.0}
    for i, reply in enumerate(port["replies"]):
        value, version = reply
        assert value == (i % 7) * scales[version]


@pytest.mark.parametrize("writer", ["paddle_tpu", "paddle_tpu_torch"])
def test_manifest_committed_by_either_package_rolls_in_the_other(
        tmp_path, writer):
    """One package's checkpointer commits; the other package's watcher
    finds the manifest, verifies it and loads its blob, and its server
    rolls to it."""
    reader = "paddle_tpu_torch" if writer == "paddle_tpu" else "paddle_tpu"
    root = str(tmp_path / "ckpt")
    w_snap = PKGS[writer][1]
    ckpt = w_snap.AsyncCheckpointer(root, keep=3, background=False)
    ckpt.save({"model.pdparams": ({"scale": 3.0}, "model")})
    ckpt.save({"model.pdparams": ({"scale": 4.0}, "model")})
    srv_mod, r_snap = PKGS[reader][:2]
    seq, path = srv_mod.ManifestWatcher(root).poll()
    assert seq == 2 and os.path.basename(path) == r_snap.manifest_name(2)
    assert r_snap.load_manifest_blob(path)["model"]["scale"] == 4.0
    clock = FakeClock()
    srv = srv_mod.InferenceServer(
        lambda i: ScalePredictor(2.0),
        srv_mod.ServingConfig(max_batch_size=4, replicas=2), clock=clock)
    rc = srv.attach_rollout(
        root, lambda p, i: ScalePredictor(
            r_snap.load_manifest_blob(p)["model"]["scale"]),
        goldens=GOLDEN, config=srv_mod.RolloutConfig(
            poll_interval=1.0, golden_max_drift=10.0))
    settle(rc, clock)
    assert rc.version == 2
    req = srv.submit(x())
    srv.pump_until_done(req)
    assert req.version == 2 and np.allclose(req.result[0], 4.0)
