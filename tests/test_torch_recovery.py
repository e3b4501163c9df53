"""The port's elastic recovery (paddle_tpu_torch/resilience/recovery.py,
distributed/fleet/elastic.py, distributed/p2p.py's generation fence)
against the reference's chaos suite, tests/test_recovery.py, ported case
by case with the same fake clock: the generation-fenced rendezvous
through the FileStore, the StaleGeneration fence at the watch_section
and p2p frame levels, the RecoveryManager's detect -> teardown ->
re-rendezvous -> restore loop with its budget and journal, the FileStore
hardening (key encoding, idempotent delete, tmp GC), the SIGTERM preempt
-> resume case and the kill + hang acceptance case on a port model with
carried weights: its losses equal the port's uninterrupted run to the bit
and the reference's within f32 1e-6. The reference's in-process
MultiTrainer restarts wait for framework/trainer.py (ROADMAP A13).

Beside them, the two packages on one directory: a reference and a port
ElasticManager converge on one generation, and each reads the other's
store keys and journal.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.distributed import p2p
from paddle_tpu_torch.distributed.checkpoint import (
    load_hybrid_checkpoint, save_hybrid_checkpoint,
)
from paddle_tpu_torch.distributed.fleet.elastic import (
    ElasticManager, ElasticStatus, FileStore,
)
from paddle_tpu_torch.distributed.fleet.fs import ExecuteError
from paddle_tpu_torch.distributed.launch_utils import find_free_ports
from paddle_tpu_torch.resilience import (faults, preempt, recorder, recovery,
                                         watchdog)
from paddle_tpu_torch.resilience.recorder import FlightRecorder
from paddle_tpu_torch.resilience.recovery import (
    MembershipChange, RecoveryExhausted, RecoveryJournal, RecoveryManager,
    RendezvousTimeout, StaleGeneration,
)
from paddle_tpu_torch.resilience.watchdog import (
    DistributedTimeout, PeerAbort, Watchdog, watch_section,
)

pytestmark = pytest.mark.chaos
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_recovery_state(tmp_path, monkeypatch):
    """Fresh faults/recorder/watchdog/generation/journal per test;
    artifacts into tmp_path; zero retry backoff so nothing really
    sleeps."""
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "artifacts"))
    paddle.set_flags({"FLAGS_retry_backoff_base": 0.0})
    faults.reset()
    recorder.reset()
    watchdog.reset()
    recovery.reset_generation()
    recovery.reset_journal()
    yield
    faults.reset()
    recorder.reset()
    watchdog.reset()
    recovery.reset_generation()
    recovery.reset_journal()
    preempt.uninstall()
    p2p.shutdown()
    # a rendezvous points the next process group at its FileStore
    from paddle_tpu_torch.distributed import env
    env._STATE["rendezvous"] = None
    paddle.set_flags({"FLAGS_retry_backoff_base": 0.5})


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _ref_arrays(seed):
    """The reference's nn.Linear(4, 4) after paddle.seed(seed)."""
    import paddle_tpu
    paddle_tpu.seed(seed)
    layer = paddle_tpu.nn.Linear(4, 4)
    return {k: np.asarray(v._val) for k, v in layer.state_dict().items()}


def _make(seed=0):
    """The port's Linear(4, 4) with the reference's weights for ``seed``,
    and SGD(0.1)."""
    model = paddle.nn.Linear(4, 4, device="cpu")
    paddle.load_numpy_state_dict(model, _ref_arrays(seed))
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=model.parameters())
    return model, opt


def _batch(step):
    rng = np.random.RandomState(1000 + step)
    return (rng.randn(8, 4).astype(np.float32),
            rng.randn(8, 4).astype(np.float32))


def _sgd_step(model, opt, step):
    """One deterministic step: the data depends only on `step`, so an
    interrupted run that replays a step computes the identical update."""
    x, y = _batch(step)
    loss = F.mse_loss(model(torch.tensor(x)), torch.tensor(y))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


def _ref_golden(seed, steps=6):
    """The reference's uninterrupted run of the same steps."""
    import paddle_tpu
    import paddle_tpu.nn.functional as RF
    paddle_tpu.seed(seed)
    model = paddle_tpu.nn.Linear(4, 4)
    opt = paddle_tpu.optimizer.SGD(learning_rate=0.1,
                                   parameters=model.parameters())
    out = []
    for s in range(steps):
        x, y = _batch(s)
        loss = RF.mse_loss(model(paddle_tpu.to_tensor(x)),
                           paddle_tpu.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out


# -- generation state ---------------------------------------------------------

class TestGenerationState:
    def test_monotonic_set(self):
        assert recovery.current_generation() == 0
        assert recovery.set_generation(3) == 3
        # a stale rank must never drag the fence backwards
        assert recovery.set_generation(1) == 3
        assert recovery.current_generation() == 3
        recovery.reset_generation()
        assert recovery.current_generation() == 0


# -- FileStore satellites -----------------------------------------------------

class TestFileStoreKeyEncoding:
    """S1: `key.replace("/", "_")` collided "job/node.1" with a literal
    "job_node.1" and made alive_values prefix matching ambiguous."""

    def test_slash_and_underscore_keys_do_not_collide(self, tmp_path):
        st = FileStore(str(tmp_path), ttl=60.0)
        st.put("job/node.1", {"v": "slash"})
        st.put("job_node.1", {"v": "underscore"})
        assert st.get("job/node.1") == {"v": "slash"}
        assert st.get("job_node.1") == {"v": "underscore"}

    def test_alive_values_prefix_is_unambiguous(self, tmp_path):
        st = FileStore(str(tmp_path), ttl=60.0)
        st.put("job/node.0", {"rank": 0})
        st.put("job_node.1", {"rank": "impostor"})
        assert st.alive_values("job/node.") == [{"rank": 0}]

    def test_delete_targets_exactly_one_key(self, tmp_path):
        st = FileStore(str(tmp_path), ttl=60.0)
        st.put("job/node.1", {"v": "slash"})
        st.put("job_node.1", {"v": "underscore"})
        st.delete("job/node.1")
        assert st.get("job/node.1") is None
        assert st.get("job_node.1") == {"v": "underscore"}


class TestFileStoreDeleteAndGC:
    """S2: idempotent delete + GC of orphaned tmp staging files."""

    def test_delete_is_idempotent(self, tmp_path):
        st = FileStore(str(tmp_path), ttl=60.0)
        st.put("k", 1)
        st.delete("k")
        st.delete("k")  # concurrent-delete race loser: must not raise
        st.delete("never-existed")
        assert st.get("k") is None

    def test_gc_removes_only_stale_tmp_files(self, tmp_path):
        st = FileStore(str(tmp_path), ttl=10.0)
        st.put("job/node.0", {"rank": 0})
        old = tmp_path / "dead.tmp.12345"
        old.write_text("{torn")
        past = time.time() - 100
        os.utime(old, (past, past))
        young = tmp_path / "inflight.tmp.999"
        young.write_text("{writing")
        removed = st.gc_tmp()
        assert removed == ["dead.tmp.12345"]
        assert not old.exists()
        assert young.exists()  # may be an in-flight put about to replace
        assert st.get("job/node.0") == {"rank": 0}
        assert st.gc_tmp() == []  # idempotent

    def test_gc_is_fault_injectable(self, tmp_path):
        st = FileStore(str(tmp_path), ttl=10.0)
        faults.configure("store.gc:#1")
        with pytest.raises(ExecuteError):
            st.gc_tmp()
        assert st.gc_tmp() == []


# -- HOLD transition (S3) -----------------------------------------------------

class TestHoldTransition:
    def _pair(self, tmp_path, np_min=2):
        st = FileStore(str(tmp_path), ttl=1e6)
        a = ElasticManager(st, "j", np_min=np_min, np_max=2, rank=0,
                           endpoint="a:1")
        b = ElasticManager(st, "j", np_min=np_min, np_max=2, rank=1,
                           endpoint="b:1")
        a.register()
        b.register()
        while a.poll() != "ok":  # settle after both registrations
            pass
        return st, a, b

    def test_hold_then_recover_to_same_np_emits_restart(self, tmp_path):
        """The S3 bug: recovering ABOVE np_min with the same count as before
        the dip never emitted RESTART, so survivors kept stale endpoints."""
        _, a, b = self._pair(tmp_path)
        b.exit()
        assert a.poll() == ElasticStatus.HOLD
        assert a.poll() == ElasticStatus.HOLD  # held, not flapping
        replacement = ElasticManager(a.store, "j", np_min=2, np_max=2,
                                     rank=1, endpoint="b2:1")
        replacement.register()
        assert a.poll() == ElasticStatus.RESTART
        assert a.poll() == "ok"

    def test_plain_scale_change_still_restarts(self, tmp_path):
        st, a, b = self._pair(tmp_path, np_min=1)
        b.exit()
        assert a.poll() == ElasticStatus.RESTART  # 2 -> 1, above np_min
        assert a.poll() == "ok"


# -- rendezvous ---------------------------------------------------------------

class TestRendezvous:
    def _mgr(self, tmp_path, rank=0, np_min=1, np_max=1, clock=None,
             sleep=None, job="job"):
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        return ElasticManager(st, job, np_min=np_min, np_max=np_max,
                              rank=rank, endpoint=f"h{rank}:1",
                              clock=clock, sleep=sleep)

    def test_single_rank_generations_are_monotonic(self, tmp_path):
        clock = FakeClock()
        m = self._mgr(tmp_path, clock=clock, sleep=clock.advance)
        m.register()
        gen, eps = m.rendezvous(timeout=5.0)
        assert (gen, eps) == (1, ["h0:1"])
        assert recovery.current_generation() == 1
        gen2, _ = m.rendezvous(timeout=5.0)
        assert gen2 == 2
        assert recovery.current_generation() == 2

    def test_two_ranks_converge_on_one_generation(self, tmp_path):
        clock = FakeClock()
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        m1 = ElasticManager(st, "job", np_min=1, np_max=2, rank=1,
                            endpoint="h1:1", clock=clock)
        m1.register()
        joined = []

        def sleep(dt):
            clock.advance(dt)
            if not joined:  # peer shows up during the wait
                rec = st.get("job/gen") or {}
                m1.announce(rec.get("gen", 1))
                joined.append(1)

        m0 = ElasticManager(st, "job", np_min=1, np_max=2, rank=0,
                            endpoint="h0:1", clock=clock, sleep=sleep)
        m0.register()
        gen, eps = m0.rendezvous(timeout=30.0)
        assert gen == 1
        assert eps == ["h0:1", "h1:1"]  # sorted by rank

    def test_adopts_higher_competing_proposal(self, tmp_path):
        clock = FakeClock()
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        m1 = ElasticManager(st, "job", np_min=1, np_max=2, rank=1,
                            endpoint="h1:1", clock=clock)
        m1.register()

        def sleep(dt):
            clock.advance(dt)
            # a survivor with a longer memory proposes a HIGHER generation
            # mid-wait: everyone must converge on it
            cur = (st.get("job/gen") or {}).get("gen", 0)
            if cur < 7:
                st.put("job/gen", {"gen": 7})
            m1.announce(7)

        m0 = ElasticManager(st, "job", np_min=1, np_max=2, rank=0,
                            endpoint="h0:1", clock=clock, sleep=sleep)
        m0.register()
        gen, eps = m0.rendezvous(timeout=30.0)
        assert gen == 7
        assert eps == ["h0:1", "h1:1"]
        assert recovery.current_generation() == 7

    def test_scaled_in_after_timeout_at_np_min(self, tmp_path):
        clock = FakeClock()
        m = self._mgr(tmp_path, np_min=1, np_max=2, clock=clock,
                      sleep=clock.advance)
        m.register()
        gen, eps = m.rendezvous(timeout=5.0)
        assert gen == 1
        assert eps == ["h0:1"]  # nobody else came: proceed scaled-in
        assert clock.t >= 5.0  # waited the full replacement window

    def test_below_np_min_raises_rendezvous_timeout(self, tmp_path):
        clock = FakeClock()
        m = self._mgr(tmp_path, np_min=2, np_max=2, clock=clock,
                      sleep=clock.advance)
        m.register()
        with pytest.raises(RendezvousTimeout, match="needs at least 2"):
            m.rendezvous(timeout=5.0)

    def test_arrival_lease_survives_wait_longer_than_ttl(self, tmp_path):
        """Regression: the rdzv.{gen}/rank.N arrival record is TTL-leased,
        and with real settings (ttl=10s, timeout=300s) a waiting rank's
        record expired mid-wait, so the scaled-in path undercounted the
        group and raised RendezvousTimeout despite a live quorum. Every
        poll must re-announce. The sleep hook force-expires every store
        entry (mtime backdating — zero real sleeps), so only a record
        re-announced in the same poll iteration can ever be counted."""
        clock = FakeClock()
        st = FileStore(str(tmp_path / "store"), ttl=10.0)

        def sleep(dt):
            clock.advance(dt)
            past = time.time() - st.ttl - 1
            for name in os.listdir(st.root):
                os.utime(os.path.join(st.root, name), (past, past))

        m = ElasticManager(st, "job", np_min=1, np_max=2, rank=0,
                           endpoint="h0:1", clock=clock, sleep=sleep)
        m.register()
        gen, eps = m.rendezvous(timeout=5.0)  # timeout >> effective ttl
        assert gen == 1
        assert eps == ["h0:1"]  # still counted at the np_min decision

    def test_wait_loop_repairs_regressed_gen_key(self, tmp_path):
        """Regression: generation agreement was last-writer-wins — a slow
        proposer's stale put could overwrite a higher generation other
        ranks already adopted, and nobody re-published, so subgroups could
        settle at different generations (split-brain). The wait loop must
        re-put the maximum until the store converges."""
        clock = FakeClock()
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        regressed = []

        def sleep(dt):
            clock.advance(dt)
            if not regressed:  # slow proposer's read-then-put lands late
                st.put("job/gen", {"gen": 1})
                regressed.append(1)

        m = ElasticManager(st, "job", np_min=1, np_max=2, rank=0,
                           endpoint="h0:1", clock=clock, sleep=sleep)
        m._generation = 4  # survivor with a longer memory: proposes 5
        m.register()
        gen, _ = m.rendezvous(timeout=5.0)
        assert gen == 5
        # the store converged back to the maximum: a rank arriving later
        # joins generation 5, not the regressed 1
        assert (st.get("job/gen") or {}).get("gen") == 5

    def test_env_generation_is_proposal_floor_not_frame_stamp(
            self, tmp_path, monkeypatch):
        """Regression: a relaunched child whose launcher counter ran ahead
        of the store-agreed generation used to stamp frames straight from
        PADDLE_TPU_GENERATION, making healthy survivors latch themselves
        stale. The env var must only floor rendezvous proposals; the
        process generation is adopted from the agreed rendezvous."""
        from paddle_tpu_torch.distributed import wire
        monkeypatch.setenv("PADDLE_TPU_GENERATION", "5")
        clock = FakeClock()
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        m = ElasticManager(st, "job", np_min=1, np_max=1, rank=0,
                           endpoint="h0:1", clock=clock, sleep=clock.advance)
        # before rendezvous the process is unfenced: frames stay unstamped
        assert recovery.current_generation() == 0
        assert "gen" not in wire.stamp_generation({"src": 0, "tag": "t"})
        m.register()
        gen, _ = m.rendezvous(timeout=5.0)
        assert gen == 6  # floor honoured: proposes above every prior gen
        assert recovery.current_generation() == 6

    def test_rendezvous_clears_unhealthy_markers(self, tmp_path):
        clock = FakeClock()
        m = self._mgr(tmp_path, clock=clock, sleep=clock.advance)
        m.register()
        m.mark_unhealthy("collective.all_reduce")
        m.store.put("job/unhealthy.7", {"rank": 7})  # dead incarnation's
        assert m.unhealthy_nodes()
        m.rendezvous(timeout=5.0)
        assert m.unhealthy_nodes() == []

    def test_rendezvous_is_fault_injectable(self, tmp_path):
        clock = FakeClock()
        m = self._mgr(tmp_path, clock=clock, sleep=clock.advance)
        m.register()
        faults.configure("recovery.rendezvous:#1")
        with pytest.raises(ExecuteError):
            m.rendezvous(timeout=5.0)


# -- recovery journal ---------------------------------------------------------

class TestRecoveryJournal:
    def test_record_roundtrip_and_auto_fields(self, tmp_path):
        clock = FakeClock(42.0)
        j = RecoveryJournal("job/with:odd chars", dir=str(tmp_path),
                            clock=clock)
        recovery.set_generation(5)
        j.record("restart", cause="PeerAbort", np=2)
        j.record("restart", cause="DistributedTimeout", generation=9)
        ents = j.entries()
        assert [e["event"] for e in ents] == ["restart", "restart"]
        assert ents[0]["ts"] == 42.0 and ents[0]["generation"] == 5
        assert ents[0]["cause"] == "PeerAbort" and ents[0]["np"] == 2
        assert ents[1]["generation"] == 9  # explicit field wins
        assert os.path.basename(j.path).startswith("recovery_journal_")

    def test_torn_final_line_is_skipped(self, tmp_path):
        j = RecoveryJournal("t", dir=str(tmp_path))
        j.record("restart", cause="x")
        with open(j.path, "a") as f:
            f.write('{"event": "rest')  # writer died mid-append
        assert [e["event"] for e in j.entries()] == ["restart"]

    def test_default_journal_lands_in_artifacts_dir(self, tmp_path):
        j = recovery.get_journal()
        j.record("worker_restart", rank=1)
        assert j.path.startswith(os.environ["PADDLE_TPU_ARTIFACTS_DIR"])
        assert j.entries()[0]["rank"] == 1


# -- StaleGeneration fencing --------------------------------------------------

class TestWatchSectionFence:
    def _wd(self):
        clock = FakeClock()
        rec = FlightRecorder(size=8, rank=0, clock=clock)
        return Watchdog(clock=clock, recorder=rec), clock

    def test_generation_change_inside_section_raises_stale(self):
        wd, _ = self._wd()
        recovery.set_generation(3)
        with pytest.raises(StaleGeneration) as exc:
            with watch_section("collective.all_reduce", watchdog=wd):
                # the group re-rendezvoused while this section was blocked:
                # its late "success" belongs to the dead incarnation
                recovery.set_generation(4)
        assert exc.value.stale_gen == 3
        assert exc.value.current_gen == 4
        assert "collective.all_reduce" in str(exc.value)

    def test_steady_generation_passes(self):
        wd, _ = self._wd()
        recovery.set_generation(3)
        with watch_section("collective.all_reduce", watchdog=wd):
            pass

    def test_stale_generation_raised_inside_passes_through(self):
        wd, _ = self._wd()
        with pytest.raises(StaleGeneration) as exc:
            with watch_section("p2p.recv", watchdog=wd):
                raise StaleGeneration(1, 2, section="p2p.recv")
        assert exc.value.stale_gen == 1  # not re-wrapped


class TestP2PGenerationFence:
    @pytest.fixture
    def chan_pair(self, monkeypatch):
        ports = find_free_ports(2)
        monkeypatch.setenv(
            "PADDLE_TPU_P2P_ENDPOINTS",
            f"127.0.0.1:{ports[0]},127.0.0.1:{ports[1]}")
        chans = []
        for r in (0, 1):
            monkeypatch.setattr(p2p, "_rank_world", lambda r=r: (r, 2))
            chans.append(p2p._Channel())
        yield chans
        for c in chans:
            c.close()

    def _wait(self, cond, timeout=10):
        deadline = time.monotonic() + timeout
        while not cond() and time.monotonic() < deadline:
            time.sleep(0.01)  # blocking-ok: poll interval, deadline above
        assert cond()

    def test_generation_zero_frames_roundtrip_unstamped(self, chan_pair):
        a, b = chan_pair
        a.send(1, ("t", 1), {"x": np.arange(3, dtype="int64")})
        got = b.recv(0, ("t", 1), timeout=10)
        np.testing.assert_array_equal(got["x"], np.arange(3))

    def test_matching_generations_roundtrip(self, chan_pair):
        a, b = chan_pair
        a._gen_fn = b._gen_fn = lambda: 4
        a.send(1, ("t", 1), "hello")
        assert b.recv(0, ("t", 1), timeout=10) == "hello"

    def test_replaying_old_generation_raises_stale_not_hang(self, chan_pair):
        """The acceptance property: a rank replaying generation-g traffic
        into the g+1 group gets a typed StaleGeneration in bounded time —
        on both its recv AND its next send — instead of hanging."""
        a, b = chan_pair
        a._gen_fn = lambda: 2  # the re-rendezvoused survivor
        b._gen_fn = lambda: 1  # still replaying the old incarnation
        t0 = time.monotonic()
        b.send(0, ("t", 1), "stale payload")
        # the survivor drops the frame (never delivered to its queue) and
        # notifies the sender, whose channel latches stale
        self._wait(lambda: b.stale is not None)
        with pytest.raises(StaleGeneration) as exc:
            b.recv(0, ("r", 1), timeout=10)
        assert exc.value.stale_gen == 1 and exc.value.current_gen == 2
        with pytest.raises(StaleGeneration):
            b.send(0, ("t", 2), "more stale")
        assert time.monotonic() - t0 < 8
        assert (0, ("t", 1)) not in a.inbox  # stale frame never queued

    def test_delayed_stale_notice_at_current_gen_is_ignored(self, chan_pair):
        """Regression: a delayed __stale__ frame about traffic this rank
        sent BEFORE it recovered used to latch the channel permanently,
        failing a rank that is actually current. Notices at or below the
        channel's current generation must be ignored."""
        a, b = chan_pair
        a._gen_fn = b._gen_fn = lambda: 2  # b already recovered to gen 2
        b._on_stale(2, src=0)  # late notice about pre-recovery traffic
        assert b.stale is None
        b._on_stale(1, src=0)  # even older news
        assert b.stale is None
        b.send(0, ("t", 1), "still current")  # channel not poisoned
        assert a.recv(1, ("t", 1), timeout=10) == "still current"
        b._on_stale(3, src=0)  # genuinely newer: must still latch
        assert b.stale == 3

    def test_newer_frame_makes_blocked_receiver_stale(self, chan_pair):
        a, b = chan_pair
        a._gen_fn = lambda: 2
        b._gen_fn = lambda: 3  # b moved on without a
        out = {}

        def run():
            try:
                a.recv(1, ("t", 1), timeout=30)
            except BaseException as e:  # noqa: BLE001 - captured for asserts
                out["err"] = e

        th = threading.Thread(target=run, daemon=True)
        th.start()
        self._wait(lambda: a.inbox)
        b.send(0, ("t", 1), "from the future")
        th.join(timeout=10)
        assert not th.is_alive()
        assert isinstance(out["err"], StaleGeneration)
        assert out["err"].current_gen == 3


# -- RecoveryManager ----------------------------------------------------------

def _single_rank_setup(tmp_path, np_min=1, np_max=1):
    clock = FakeClock()
    st = FileStore(str(tmp_path / "store"), ttl=1e6)
    m = ElasticManager(st, "job", np_min=np_min, np_max=np_max, rank=0,
                       endpoint="h0:1", clock=clock, sleep=clock.advance)
    m.register()
    return clock, st, m


class TestRecoveryManager:
    def test_restart_rendezvouses_restores_and_journals(self, tmp_path):
        clock, _, m = _single_rank_setup(tmp_path)
        journal = RecoveryJournal("job", dir=str(tmp_path), clock=clock)
        restored = []

        def restore(gen):
            restored.append(gen)
            return {"resumed_at": gen}

        rm = RecoveryManager(m, restore=restore, max_restarts=3,
                             rendezvous_timeout=5.0, backoff_base=1.0,
                             sleep=clock.advance, journal=journal)
        calls = []

        def train(resume):
            calls.append(resume)
            if len(calls) == 1:
                raise PeerAbort(1, section="collective.all_reduce",
                                reason="injected")
            return resume

        assert rm.run(train) == {"resumed_at": 1}
        assert calls == [None, {"resumed_at": 1}]
        assert restored == [1]
        (entry,) = journal.entries()
        assert entry["event"] == "restart"
        assert entry["cause"] == "PeerAbort"
        assert entry["generation"] == 1 and entry["np"] == 1

    def test_budget_exhaustion_with_exponential_backoff(self, tmp_path):
        clock, _, m = _single_rank_setup(tmp_path)
        journal = RecoveryJournal("job", dir=str(tmp_path), clock=clock)
        sleeps = []

        def sleep(dt):
            sleeps.append(dt)
            clock.advance(dt)

        rm = RecoveryManager(m, max_restarts=2, rendezvous_timeout=5.0,
                             backoff_base=1.0, sleep=sleep, journal=journal)

        def always_dies(resume):
            raise DistributedTimeout("collective.all_reduce", 0, 60.0, 61.0)

        with pytest.raises(RecoveryExhausted, match="after 2 restart"):
            rm.run(always_dies)
        assert sleeps == [1.0, 2.0]  # backoff doubles per restart
        events = [e["event"] for e in journal.entries()]
        assert events == ["restart", "restart", "recovery_exhausted"]
        assert journal.entries()[-1]["cause"] == "DistributedTimeout"

    def test_non_recoverable_error_propagates(self, tmp_path):
        clock, _, m = _single_rank_setup(tmp_path)
        rm = RecoveryManager(m, max_restarts=3, rendezvous_timeout=5.0,
                             backoff_base=0.0, sleep=clock.advance,
                             journal=RecoveryJournal("j", dir=str(tmp_path)))
        with pytest.raises(ValueError, match="deterministic bug"):
            rm.run(lambda resume: (_ for _ in ()).throw(
                ValueError("deterministic bug")))
        assert rm.restarts == 0

    def test_restart_is_fault_injectable(self, tmp_path):
        clock, _, m = _single_rank_setup(tmp_path)
        rm = RecoveryManager(m, max_restarts=3, rendezvous_timeout=5.0,
                             backoff_base=0.0, sleep=clock.advance,
                             journal=RecoveryJournal("j", dir=str(tmp_path)))
        faults.configure("recovery.restart:#1")
        with pytest.raises(ConnectionError):
            rm.restart(cause=RuntimeError("x"))

    def test_budget_refills_after_sustained_healthy_progress(self, tmp_path):
        """Regression: `restarts` accumulated for the life of the job, so
        unrelated transient faults days apart eventually raised
        RecoveryExhausted even though every recovery succeeded."""
        clock, _, m = _single_rank_setup(tmp_path)
        journal = RecoveryJournal("job", dir=str(tmp_path), clock=clock)
        rm = RecoveryManager(m, max_restarts=1, rendezvous_timeout=5.0,
                             backoff_base=0.0, sleep=clock.advance,
                             journal=journal, restart_reset_steps=3)
        rm.restart(cause=ConnectionError("blip 1"))
        assert rm.restarts == 1
        rm.note_progress()
        rm.note_progress()
        assert rm.restarts == 1  # streak not long enough yet
        rm.note_progress()
        assert rm.restarts == 0  # budget refilled
        rm.restart(cause=ConnectionError("blip 2, days later"))
        assert rm.restarts == 1  # did NOT raise RecoveryExhausted
        events = [e["event"] for e in journal.entries()]
        assert events == ["restart", "budget_reset", "restart"]

    def test_clean_check_counts_as_progress(self, tmp_path):
        clock, _, m = _single_rank_setup(tmp_path)
        rm = RecoveryManager(m, max_restarts=1, rendezvous_timeout=5.0,
                             backoff_base=0.0, sleep=clock.advance,
                             journal=RecoveryJournal("j", dir=str(tmp_path)),
                             restart_reset_steps=1)
        rm.restart(cause=ConnectionError("x"))
        assert rm.restarts == 1
        rm.check()  # clean step-boundary poll
        assert rm.restarts == 0

    def test_restart_reset_zero_keeps_lifetime_budget(self, tmp_path):
        clock, _, m = _single_rank_setup(tmp_path)
        rm = RecoveryManager(m, max_restarts=2, rendezvous_timeout=5.0,
                             backoff_base=0.0, sleep=clock.advance,
                             journal=RecoveryJournal("j", dir=str(tmp_path)),
                             restart_reset_steps=0)
        rm.restart(cause=ConnectionError("a"))
        for _ in range(50):
            rm.note_progress()
        assert rm.restarts == 1  # refill disabled: per-job-lifetime budget
        rm.restart(cause=ConnectionError("b"))
        with pytest.raises(RecoveryExhausted):
            rm.restart(cause=ConnectionError("c"))

    def test_failure_resets_healthy_streak(self, tmp_path):
        clock, _, m = _single_rank_setup(tmp_path)
        rm = RecoveryManager(m, max_restarts=3, rendezvous_timeout=5.0,
                             backoff_base=0.0, sleep=clock.advance,
                             journal=RecoveryJournal("j", dir=str(tmp_path)),
                             restart_reset_steps=3)
        rm.restart(cause=ConnectionError("a"))
        rm.note_progress()
        rm.note_progress()
        rm.restart(cause=ConnectionError("b"))  # breaks the streak at 2
        rm.note_progress()
        assert rm.restarts == 2  # needs 3 healthy steps SINCE the failure
        rm.note_progress()
        rm.note_progress()
        assert rm.restarts == 0

    def test_check_raises_membership_change_on_hold(self, tmp_path):
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        a = ElasticManager(st, "j", np_min=2, np_max=2, rank=0,
                           endpoint="a:1")
        b = ElasticManager(st, "j", np_min=2, np_max=2, rank=1,
                           endpoint="b:1")
        a.register()
        b.register()
        rm = RecoveryManager(a, max_restarts=1, rendezvous_timeout=1.0,
                             backoff_base=0.0,
                             journal=RecoveryJournal("j", dir=str(tmp_path)))
        while True:  # settle registrations
            try:
                rm.check()
                break
            except MembershipChange:
                continue
        b.exit()
        with pytest.raises(MembershipChange, match="hold"):
            rm.check()

    def test_check_raises_on_unhealthy_peer(self, tmp_path):
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        a = ElasticManager(st, "j", np_min=1, np_max=2, rank=0,
                           endpoint="a:1")
        b = ElasticManager(st, "j", np_min=1, np_max=2, rank=1,
                           endpoint="b:1")
        a.register()
        b.register()
        rm = RecoveryManager(a, max_restarts=1, rendezvous_timeout=1.0,
                             backoff_base=0.0,
                             journal=RecoveryJournal("j", dir=str(tmp_path)))
        while True:
            try:
                rm.check()
                break
            except MembershipChange:
                continue
        b.mark_unhealthy("collective.all_reduce")
        with pytest.raises(MembershipChange) as exc:
            rm.check()
        assert exc.value.unhealthy == [1]


# -- end-to-end: preempt → resume at generation g+1 (S4) ----------------------

class TestPreemptResume:
    def test_sigterm_snapshot_resumes_at_next_generation(self, tmp_path):
        """PR 1's SIGTERM snapshot + this PR's rendezvous: a preempted rank
        snapshots mid-run, a NEW incarnation rendezvouses at g+1, restores
        step/optimizer state, and the loss curve continues exactly."""
        golden_model, golden_opt = _make(seed=7)
        golden = [_sgd_step(golden_model, golden_opt, s) for s in range(6)]

        clock = FakeClock()
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        m = ElasticManager(st, "job", np_min=1, np_max=1, rank=0,
                           endpoint="h0:1", clock=clock, sleep=clock.advance)
        m.register()
        g1, _ = m.rendezvous(timeout=5.0)
        assert g1 == 1

        model, opt = _make(seed=7)
        ckpt = str(tmp_path / "ckpt.pdparams")
        state = {"step": 0}
        handler = preempt.PreemptionHandler()
        handler.add_action(lambda: save_hybrid_checkpoint(
            ckpt, model, opt, meta={"step": state["step"],
                                    "preempted": True}))
        losses = []
        with pytest.raises(preempt.Preempted) as exc:
            for step in range(6):
                handler.check()  # drains the snapshot action, then raises
                losses.append(_sgd_step(model, opt, step))
                state["step"] = step + 1
                if step == 2:
                    handler.notify()  # SIGTERM equivalent, no real signal
        assert exc.value.code == 143  # 128 + SIGTERM

        # --- new process: fresh model/optimizer, fresh generation state ---
        recovery.reset_generation()
        model2, opt2 = _make(seed=99)  # junk init: the load must win
        m2 = ElasticManager(st, "job", np_min=1, np_max=1, rank=0,
                            endpoint="h0:1", clock=clock,
                            sleep=clock.advance)
        m2.register()
        g2, _ = m2.rendezvous(timeout=5.0)
        assert g2 == g1 + 1

        meta = load_hybrid_checkpoint(ckpt, model2, opt2)
        assert meta["step"] == 3
        assert meta["preempted"] is True
        assert meta["generation"] == g1  # snapshot names its incarnation
        losses += [_sgd_step(model2, opt2, s) for s in range(meta["step"], 6)]
        np.testing.assert_allclose(losses, golden, rtol=0, atol=0)
        np.testing.assert_allclose(losses, _ref_golden(7), rtol=1e-6,
                                   atol=1e-6)
        for (k, want), (_, got) in zip(
                golden_model.state_dict().items(),
                model2.state_dict().items()):
            assert torch.equal(want, got), k


# -- acceptance: kill + hang → re-rendezvous → resume, zero real sleeps -------

class TestChaosElasticRecoveryAcceptance:
    def test_kill_and_hang_recover_with_no_lost_steps(self, tmp_path):
        """ISSUE 4 acceptance: fault injection kills one rank mid-step and
        hangs another's collective; the job re-rendezvouses at a higher
        generation each time (once WITH a replacement, once scaled-in),
        resumes from the last checkpoint, completes training with no lost
        accepted steps, and the journal names every restart cause."""
        t0 = time.monotonic()
        golden_model, golden_opt = _make(seed=3)
        golden = [_sgd_step(golden_model, golden_opt, s) for s in range(6)]

        clock = FakeClock()
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        m1 = ElasticManager(st, "jobA", np_min=1, np_max=2, rank=1,
                            endpoint="h1:1", clock=clock)
        m1.register()
        allow_join = [True]

        def sleep(dt):
            clock.advance(dt)
            if allow_join[0]:  # rank 1 (or its replacement) shows up
                rec = st.get("jobA/gen") or {}
                if rec.get("gen"):
                    m1.announce(rec["gen"])

        m0 = ElasticManager(st, "jobA", np_min=1, np_max=2, rank=0,
                            endpoint="h0:1", clock=clock, sleep=sleep)
        m0.register()
        gen0, eps0 = m0.rendezvous(timeout=5.0)
        assert gen0 == 1 and len(eps0) == 2

        model, opt = _make(seed=3)
        ckpt = str(tmp_path / "ckpt.pdparams")
        journal = RecoveryJournal("jobA", dir=str(tmp_path), clock=clock)
        # step attempts across all incarnations: s0 s1 s2(kill) | s2 s3
        # s4(hang) | s4 s5 — the kill is the 3rd kill-site evaluation, the
        # hang the 5th hang-site evaluation (the killed attempt never
        # reaches the hang site)
        faults.configure("chaos.kill:#3,chaos.hang:#5")
        reg = faults._REGISTRY
        accepted = []
        losses = {}

        def train(resume):
            start = resume["step"] if resume else 0
            for step in range(start, 6):
                if reg.should_fail("chaos.kill"):
                    # rank 1 died mid-step and its abort reached us
                    raise PeerAbort(1, section="collective.all_reduce",
                                    reason="rank killed mid-step")
                if reg.should_fail("chaos.hang"):
                    # our collective hung and the watchdog expired it; also
                    # the signal to run the next rendezvous without rank 1
                    allow_join[0] = False
                    raise DistributedTimeout("collective.all_reduce", 0,
                                             60.0, 61.0)
                losses[step] = _sgd_step(model, opt, step)
                save_hybrid_checkpoint(ckpt, model, opt,
                                       meta={"step": step + 1})
                accepted.append(step)
            return "done"

        def restore(gen):
            return load_hybrid_checkpoint(ckpt, model, opt)

        rm = RecoveryManager(m0, restore=restore, max_restarts=3,
                             rendezvous_timeout=5.0, backoff_base=1.0,
                             sleep=sleep, journal=journal)
        assert rm.run(train) == "done"

        # no lost accepted steps: every step committed exactly once
        assert accepted == list(range(6))
        assert rm.restarts == 2
        assert recovery.current_generation() == 3  # 1 → kill → 2 → hang → 3
        ents = [e for e in journal.entries() if e["event"] == "restart"]
        assert [e["cause"] for e in ents] == \
            ["PeerAbort", "DistributedTimeout"]
        assert [e["generation"] for e in ents] == [2, 3]
        # first restart got the replacement; second proceeded scaled-in
        assert [e["np"] for e in ents] == [2, 1]
        # the recovered run's loss curve matches an uninterrupted one, and
        # the reference's uninterrupted run in f32
        np.testing.assert_allclose([losses[s] for s in range(6)], golden,
                                   rtol=0, atol=0)
        np.testing.assert_allclose(golden, _ref_golden(3), rtol=1e-6,
                                   atol=1e-6)

        # a rank replaying generation-g work into g+1 fails typed, not hung
        wd = Watchdog(clock=FakeClock(),
                      recorder=FlightRecorder(size=8, rank=0,
                                              clock=FakeClock()))
        with pytest.raises(StaleGeneration) as exc:
            with watch_section("collective.all_reduce", watchdog=wd):
                recovery.set_generation(4)  # the group moved on mid-section
        assert exc.value.stale_gen == 3 and exc.value.current_gen == 4
        assert time.monotonic() - t0 < 30.0  # fake clock: no real sleeps


# -- the two packages on one store --------------------------------------------

class TestAcrossPackages:
    def test_reference_and_port_managers_converge_on_one_generation(
            self, tmp_path):
        """A reference rank and a port rank on one directory: whichever
        proposes first, both leave the rendezvous at one generation, with
        both endpoints, and each store reads the other's keys."""
        from paddle_tpu.distributed.fleet import elastic as ref_elastic
        from paddle_tpu.resilience import recovery as ref_recovery
        root = str(tmp_path / "store")
        ref_recovery.reset_generation()
        try:
            for first in ("ref", "port"):
                job = f"mixed-{first}"
                clock = FakeClock()
                ref_m = ref_elastic.ElasticManager(
                    ref_elastic.FileStore(root, ttl=1e6), job, np_min=2,
                    np_max=2, rank=0, endpoint="h0:1", clock=clock,
                    sleep=lambda dt: clock.advance(dt))
                port_m = ElasticManager(
                    FileStore(root, ttl=1e6), job, np_min=2, np_max=2,
                    rank=1, endpoint="h1:1", clock=clock,
                    sleep=lambda dt: clock.advance(dt))
                ref_m.register()
                port_m.register()
                out = {}

                def run(name, m):
                    out[name] = m.rendezvous(timeout=60.0,
                                             poll_interval=0.01)
                order = [("ref", ref_m), ("port", port_m)]
                if first == "port":
                    order.reverse()
                threads = [threading.Thread(target=run, args=o)
                           for o in order]
                for th in threads:
                    th.start()
                    time.sleep(0.05)  # blocking-ok: staggers the proposals
                for th in threads:
                    th.join(timeout=30)
                assert out["ref"] == out["port"], out
                gen, eps = out["port"]
                assert eps == ["h0:1", "h1:1"] and gen >= 1
                # each package's FileStore reads the other's keys
                assert ref_m.store.get(f"{job}/node.1")["endpoint"] == "h1:1"
                assert port_m.store.get(f"{job}/node.0")["endpoint"] == "h0:1"
                assert sorted(v["rank"] for v in port_m.alive_nodes()) == \
                    sorted(v["rank"] for v in ref_m.alive_nodes()) == [0, 1]
        finally:
            ref_recovery.reset_generation()

    def test_journals_read_across_packages(self, tmp_path):
        from paddle_tpu.resilience.recovery import \
            RecoveryJournal as RefJournal
        clock = FakeClock(5.0)
        mine = RecoveryJournal("j/x", dir=str(tmp_path), clock=clock)
        theirs = RefJournal("j/x", dir=str(tmp_path), clock=clock)
        assert mine.path == theirs.path
        recovery.set_generation(2)
        mine.record("restart", cause="PeerAbort", np=2, restart=1)
        theirs.record("worker_restart", rank=1, code=9, generation=1)
        want = [{"event": "restart", "job": "j/x", "ts": 5.0,
                 "generation": 2, "cause": "PeerAbort", "np": 2,
                 "restart": 1},
                {"event": "worker_restart", "job": "j/x", "ts": 5.0,
                 "generation": 1, "rank": 1, "code": 9}]
        assert mine.entries() == theirs.entries() == want

    def test_file_store_layout_is_the_references(self, tmp_path):
        from paddle_tpu.distributed.fleet.elastic import FileStore as RefStore
        mine, theirs = FileStore(str(tmp_path)), RefStore(str(tmp_path))
        mine.put("job/node.0", {"rank": 0})
        theirs.put("job_node.1", {"rank": 1})
        assert sorted(os.listdir(tmp_path)) == ["job%2Fnode.0", "job_node.1"]
        assert theirs.get("job/node.0") == {"rank": 0}
        assert mine.get("job_node.1") == {"rank": 1}
        theirs.delete("job/node.0")
        assert mine.get("job/node.0") is None


class TestOpenRound:
    def test_arrivals_one_after_the_other_meet_one_above_the_last_round(
            self, tmp_path):
        """A survivor (at the gathered generation 1) and a replacement
        the launcher relaunched (floor 1, PADDLE_TPU_GENERATION) meet at
        generation 2 whichever reaches the rendezvous first: the second
        joins the open round instead of proposing above it."""
        for first in (0, 1):
            st = FileStore(str(tmp_path / f"s{first}"), ttl=1e6)
            clock = FakeClock()
            ms = [ElasticManager(st, "j", np_min=2, np_max=2, rank=r,
                                 endpoint=f"h{r}:1", clock=clock,
                                 sleep=lambda dt: clock.advance(dt))
                  for r in (0, 1)]
            st.put("j/gen", {"gen": 1, "closed": True})
            ms[0]._generation = 1   # the survivor
            ms[1]._generation = 1   # the launcher's floor
            out = {}

            def run(m):
                m.register()
                out[m.rank] = m.rendezvous(timeout=60.0,
                                           poll_interval=0.01)
            threads = [threading.Thread(target=run, args=(ms[r],))
                       for r in (first, 1 - first)]
            for th in threads:
                th.start()
                time.sleep(0.1)  # blocking-ok: the second arrives later
            for th in threads:
                th.join(timeout=30)
            assert out[0] == out[1] == (2, ["h0:1", "h1:1"]), out
            assert st.get("j/gen") == {"gen": 2, "closed": True}
            recovery.reset_generation()


def test_hybrid_load_fallback_journals_corrupt_restore(tmp_path):
    """A corrupted checkpoint's load falls back to ``.old`` and journals
    ``corrupt_restore`` in the reference's fields."""
    model, opt = _make(seed=1)
    path = str(tmp_path / "ck.pdparams")
    _sgd_step(model, opt, 0)
    save_hybrid_checkpoint(path, model, opt, meta={"step": 1})
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    _sgd_step(model, opt, 1)
    save_hybrid_checkpoint(path, model, opt, meta={"step": 2})
    with open(path, "r+b") as f:
        f.seek(40)
        byte = f.read(1)
        f.seek(40)
        f.write(bytes([byte[0] ^ 0xFF]))
    fresh, fresh_opt = _make(seed=5)
    meta = load_hybrid_checkpoint(path, fresh, fresh_opt)
    assert meta["step"] == 1 and meta["restored_from_fallback"] is True
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, saved[k]), k
    (entry,) = recovery.get_journal().entries()
    assert entry["event"] == "corrupt_restore"
    assert entry["path"] == path and entry["fallback"] == path + ".old"
    assert "sha256" in entry["detail"] or "mismatch" in entry["detail"] or \
        entry["detail"], entry
