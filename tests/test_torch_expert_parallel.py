"""The port's elastic expert-parallel engine
(distributed/fleet/expert_parallel.py), case by case with the reference's
tests/test_expert_parallel.py and the same fake clocks: the placement map,
capacity routing with token-drop accounting and the typed overflow, the
generation-fenced exchanges and their fault sites, expert-sharded
checkpoints through the port's AsyncCheckpointer (per-file expert ids and
degree, restore across a degree change, fallback past a damaged
manifest), the journaled resize protocol with the replay of a resize a
death cut short, and the chaos acceptance (a rank killed mid-step, a
scale-in with its expert re-adopted, a resize back up, the golden losses
to the bit).

Across the packages: the port engine's ``state_digest`` equals the
reference engine's after every step of the same seeded batches, across a
resize down and up, and a manifest either engine commits restores in the
other.
"""
import os

import numpy as np
import pytest

pytest.importorskip("jax")

from paddle_tpu.distributed.fleet import (  # noqa: E402
    expert_parallel as ref_ep)
from paddle_tpu.resilience import snapshot as rsnap  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch.distributed.fleet.elastic import (  # noqa: E402
    ElasticManager, FileStore)
from paddle_tpu_torch.distributed.fleet.expert_parallel import (  # noqa: E402
    ExpertParallelEngine, ExpertPlacement, ExpertPlacementError,
    TokenDropOverflow,
)
from paddle_tpu_torch.framework.errors import (  # noqa: E402
    NotFoundError, PreconditionNotMetError)
from paddle_tpu_torch.resilience import (faults, recorder,  # noqa: E402
                                         recovery, watchdog)
from paddle_tpu_torch.resilience.faults import FaultInjected  # noqa: E402
from paddle_tpu_torch.resilience.recovery import (  # noqa: E402
    RecoveryJournal, RecoveryManager)
from paddle_tpu_torch.resilience.snapshot import (  # noqa: E402
    AsyncCheckpointer, read_manifest)
from paddle_tpu_torch.resilience.watchdog import StaleGeneration  # noqa: E402



@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "arts"))
    pt.set_flags({"FLAGS_retry_backoff_base": 0.0})
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
    from paddle_tpu_torch.distributed import env
    env._STATE["rendezvous"] = None
    pt.set_flags({"FLAGS_retry_backoff_base": 0.5})


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _data(step, n=32, d=4):
    rng = np.random.RandomState(1000 + int(step))
    return rng.randn(n, d), rng.randn(n, d)


def _engine(ranks=range(8), **kw):
    kw.setdefault("seed", 3)
    return ExpertParallelEngine(8, 4, ranks, **kw)


# -- placement ----------------------------------------------------------------

class TestPlacement:
    def test_round_robin_over_sorted_ranks(self):
        p = ExpertPlacement(8, (3, 1, 2, 0))
        assert p.ranks == (0, 1, 2, 3)
        assert [p.rank_of(e) for e in range(8)] == [0, 1, 2, 3, 0, 1, 2, 3]
        assert p.experts_on(1) == (1, 5)

    def test_pure_function_of_membership(self):
        assert ExpertPlacement(8, range(7)) == ExpertPlacement(
            8, reversed(range(7)))

    def test_typed_errors(self):
        with pytest.raises(ExpertPlacementError):
            ExpertPlacement(8, ())
        with pytest.raises(ExpertPlacementError):
            ExpertPlacement(0, (0,))
        with pytest.raises(ExpertPlacementError):
            ExpertPlacement(4, (0,)).rank_of(4)


# -- capacity routing / token drops -------------------------------------------

class TestCapacityRouting:
    def test_drop_determinism_across_fresh_engines(self):
        """Satellite: same seed + same batch ⇒ identical
        tokens_dropped_total AND identical loss across two fresh engines.
        A tight capacity factor forces real drops so the assertion has
        teeth."""
        x, t = _data(0, n=64)
        a = _engine(capacity_factor=0.4, seed=5)
        b = _engine(capacity_factor=0.4, seed=5)
        la = [a.step(x, t) for _ in range(4)]
        lb = [b.step(x, t) for _ in range(4)]
        assert a.tokens_dropped_total > 0
        assert a.tokens_dropped_total == b.tokens_dropped_total
        assert la == lb
        assert a.state_digest() == b.state_digest()

    def test_zero_drops_at_large_capacity(self):
        x, t = _data(0, n=64)
        eng = _engine(capacity_factor=16.0)
        eng.step(x, t)
        assert eng.tokens_dropped_total == 0
        assert eng.last_stats["drop_fraction"] == 0.0

    def test_drop_accounting_in_stats_and_metrics(self):
        from paddle_tpu_torch.profiler.metrics import get_registry
        x, t = _data(0, n=64)
        eng = _engine(capacity_factor=0.4)
        before = eng.tokens_dropped_total
        eng.step(x, t)
        dropped = eng.tokens_dropped_total - before
        assert dropped == eng.last_stats["dropped"] > 0
        snap = get_registry().snapshot()
        assert snap["counters"].get("moe.tokens_dropped_total", 0) >= dropped
        assert 0.0 < eng.last_stats["capacity_utilization"] <= 1.0
        assert eng.aux_loss > 0.0

    def test_overflow_is_typed_not_silent(self):
        x, t = _data(0, n=64)
        eng = _engine(capacity_factor=0.01, max_drop_fraction=0.25)
        with pytest.raises(TokenDropOverflow):
            eng.step(x, t)

    def test_training_decreases_loss(self):
        x, t = _data(0, n=64)
        eng = _engine()
        losses = [eng.step(x, t) for _ in range(8)]
        assert losses[-1] < losses[0]


# -- generation fencing --------------------------------------------------------

class TestGenerationFence:
    def test_stale_frame_fails_typed(self):
        eng = _engine()
        x, _ = _data(0)
        recovery.set_generation(3)
        frames, info = eng.dispatch(x)
        out = eng.compute(frames)
        recovery.set_generation(4)  # group re-rendezvoused mid-exchange
        with pytest.raises(StaleGeneration):
            eng.combine(out, info)

    def test_unfenced_gen0_passes(self):
        eng = _engine()
        x, t = _data(0)
        assert recovery.current_generation() == 0
        eng.step(x, t)  # no fence before the first rendezvous

    def test_dispatch_and_combine_are_injectable(self):
        eng = _engine()
        x, t = _data(0)
        faults.configure("moe.dispatch:#1")
        with pytest.raises(FaultInjected):
            eng.step(x, t)
        faults.configure("moe.combine:#1")
        with pytest.raises(FaultInjected):
            eng.step(x, t)


# -- expert-sharded checkpoints ------------------------------------------------

class TestExpertShardCheckpoint:
    def test_manifest_records_ids_and_degree_per_file(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False)
        eng = _engine(checkpointer=ck)
        x, t = _data(0)
        eng.step(x, t)
        mp = eng.save(step=1)
        man = read_manifest(mp)
        shards = {rel: fi for rel, fi in man["files"].items()
                  if fi["kind"] == "expert_shard"}
        assert len(shards) == 8
        all_ids = sorted(i for fi in shards.values()
                         for i in fi["expert_ids"])
        assert all_ids == list(range(8))
        assert all(fi["ep_degree"] == 8 for fi in shards.values())
        assert man["meta"]["ep_degree"] == 8

    def test_save_without_checkpointer_is_typed(self):
        with pytest.raises(PreconditionNotMetError):
            _engine().save()

    def test_restore_without_manifest_is_typed(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False)
        with pytest.raises(NotFoundError):
            _engine(checkpointer=ck).restore()

    def test_restore_across_ep_degree_change(self, tmp_path):
        """The 8→7→8 contract: a manifest committed at ep=8 restores into
        an ep=7 placement (and back), because shard files are keyed by
        expert id, not rank count."""
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False)
        golden = _engine()
        eng = _engine(checkpointer=ck)
        for s in range(4):
            x, t = _data(s)
            golden.step(x, t)
            eng.step(x, t)
        eng.save(step=4)
        # down: rank 7 dies, its expert is orphaned, adopted from manifest
        eng.drop_rank(7)
        adopted = eng.resize(range(7))
        assert adopted == [7]
        assert eng.ep_degree == 7
        step = eng.restore()
        assert step == 4
        owned = [e for eids in eng.owned_experts().values() for e in eids]
        assert sorted(owned) == list(range(8))  # zero experts lost
        # replay to parity at ep=7
        for s in range(4, 6):
            x, t = _data(s)
            assert eng.step(x, t) == golden.step(x, t)
        # back up: replacement joins, experts redistribute, still parity
        eng.save(step=6)
        assert eng.resize(range(8)) == []
        assert eng.restore() == 6
        assert eng.ep_degree == 8
        for s in range(6, 8):
            x, t = _data(s)
            assert eng.step(x, t) == golden.step(x, t)
        assert eng.state_digest() == golden.state_digest()

    def test_corrupt_newest_manifest_falls_back(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False)
        eng = _engine(checkpointer=ck)
        x, t = _data(0)
        eng.step(x, t)
        eng.save(step=1)
        eng.step(x, t)
        mp2 = eng.save(step=2)
        man = read_manifest(mp2)
        rel = next(iter(man["files"]))
        with open(os.path.join(os.path.dirname(mp2), rel), "ab") as f:
            f.write(b"garbage")
        assert eng.restore() == 1  # newest is damaged → previous commit


# -- resize protocol / journal -------------------------------------------------

class TestResizeJournal:
    def test_resize_journals_started_and_completed(self, tmp_path):
        j = RecoveryJournal("j", dir=str(tmp_path / "j"))
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False,
                               journal=j)
        eng = _engine(checkpointer=ck, journal=j)
        x, t = _data(0)
        eng.step(x, t)
        eng.save(step=1)
        eng.drop_rank(7)
        eng.resize(range(7))
        evs = [e for e in j.entries() if e["event"].startswith("moe_")]
        assert [e["event"] for e in evs] == ["moe_resize_started",
                                            "moe_resize_completed"]
        assert evs[0]["to_ranks"] == list(range(7))
        assert evs[0]["orphaned"] == [7]
        assert evs[1]["adopted"] == [7]
        assert evs[0]["resize"] == evs[1]["resize"]

    def test_failed_resize_journals_aborted(self, tmp_path):
        j = RecoveryJournal("j", dir=str(tmp_path / "j"))
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False,
                               journal=j)
        eng = _engine(checkpointer=ck, journal=j)
        eng.drop_rank(7)  # orphan with NO committed manifest to adopt from
        with pytest.raises(ExpertPlacementError):
            eng.resize(range(7))
        evs = [e["event"] for e in j.entries()
               if e["event"].startswith("moe_")]
        assert evs == ["moe_resize_started", "moe_resize_aborted"]

    def test_injected_resize_fault_is_typed_and_journaled(self, tmp_path):
        j = RecoveryJournal("j", dir=str(tmp_path / "j"))
        eng = _engine(journal=j)
        faults.configure("moe.resize:#1")
        with pytest.raises(FaultInjected):
            eng.resize(range(7))
        evs = [e["event"] for e in j.entries()
               if e["event"].startswith("moe_")]
        assert evs == ["moe_resize_started", "moe_resize_aborted"]

    def test_mid_resize_death_replays_on_restart(self, tmp_path):
        """A kill between moe_resize_started and its terminal record: the
        restarted process finds the dangling record and re-runs exactly
        that resize from the journal."""
        j = RecoveryJournal("j", dir=str(tmp_path / "j"))
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False,
                               journal=j)
        eng = _engine(checkpointer=ck, journal=j)
        x, t = _data(0)
        eng.step(x, t)
        eng.save(step=1)
        # simulate the dying incarnation: it journaled "started", then the
        # process was killed before any state moved or a terminal record
        j.record("moe_resize_started", resize="resize-dead",
                 from_ranks=list(range(8)), to_ranks=list(range(7)),
                 orphaned=[7], generation=2)
        # fresh incarnation: same journal + ckpt root, survivor membership
        eng2 = _engine(ranks=range(8), checkpointer=ck, journal=j)
        eng2.drop_rank(7)
        assert eng2.replay_pending_resizes() == ["resize-dead"]
        assert eng2.ep_degree == 7
        owned = [e for es in eng2.owned_experts().values() for e in es]
        assert sorted(owned) == list(range(8))
        # the replayed resize reached its terminal record
        done = {e.get("resize") for e in j.entries()
                if e["event"] == "moe_resize_completed"}
        assert "resize-dead" in done
        # idempotent: nothing left pending
        assert eng2.replay_pending_resizes() == []


# -- chaos acceptance ----------------------------------------------------------

class TestChaosAcceptance:
    def test_rank_death_resize_down_then_up_with_loss_parity(self, tmp_path):
        """The acceptance cycle: an injected fault kills ep rank 7
        mid-step → the group re-rendezvouses scaled-in at gen+1 → the
        placement is rebuilt over the survivors with rank 7's expert
        re-adopted from the expert-sharded manifest (zero experts lost) →
        training rewinds to the last committed step and resumes with
        bitwise loss parity vs the uninjected golden → a replacement
        joins, a second resize redistributes back to ep=8, still
        parity-clean. Fake clock throughout; the journal names both
        resizes and the restart."""
        steps, ckpt_every = 10, 3
        golden = _engine()
        golden_losses = []
        for s in range(steps):
            x, t = _data(s)
            golden_losses.append(golden.step(x, t))

        clock = FakeClock()
        job = "moe-chaos"
        store = FileStore(str(tmp_path / "store"), ttl=30.0)
        mgrs = {}

        def pump(dt):
            # rank 0 drives the rendezvous; during its poll sleeps every
            # OTHER live rank announces at the agreed generation (a dead
            # rank is out of `mgrs` and never arrives — the scaled-in path)
            clock.advance(dt)
            rec = store.get(f"{job}/gen") or {}
            gen = int(rec.get("gen", 0))
            if gen:
                for r, m in list(mgrs.items()):
                    if r != 0:
                        m.announce(gen)

        for r in range(8):
            mgrs[r] = ElasticManager(store, job, np_min=1, np_max=8,
                                     rank=r, endpoint=f"h{r}:1",
                                     heartbeat_interval=0.01, clock=clock,
                                     sleep=pump if r == 0 else clock.advance)
            mgrs[r].register()
        journal = RecoveryJournal(job_id=job, dir=str(tmp_path / "journal"),
                                  clock=clock)
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False,
                               journal=journal)
        eng = _engine(checkpointer=ck, journal=journal)

        def _restore(gen):
            eps = [e for e in os.environ.get(
                "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
            survivors = sorted(int(e[1:].split(":")[0]) for e in eps)
            eng.resize(survivors)
            return {"step": eng.restore()}

        gen0, eps0 = mgrs[0].rendezvous(timeout=0.5)
        assert len(eps0) == 8
        mgr = RecoveryManager(mgrs[0], restore=_restore, max_restarts=4,
                              rendezvous_timeout=0.3, backoff_base=0.0,
                              restart_reset_steps=0, clock=clock,
                              sleep=pump, journal=journal)
        eng.save(step=0)

        faults.configure("moe.dispatch:#4")  # the mid-step kill
        losses, step = [], 0
        resized_down = False
        while step < steps:
            try:
                x, t = _data(step)
                loss = eng.step(x, t)
            except FaultInjected as e:
                # rank 7 died in the exchange: it never arrives at the
                # next rendezvous, so the survivors proceed scaled-in
                assert not resized_down
                eng.drop_rank(7)
                del mgrs[7]
                resume = mgr.restart(cause=e)
                assert recovery.current_generation() == gen0 + 1
                assert eng.ep_degree == 7
                step = int(resume["step"])
                del losses[step:]
                resized_down = True
                continue
            del losses[step:]
            losses.append(loss)
            step += 1
            if step % ckpt_every == 0:
                eng.save(step=step)
            if step == 7 and resized_down and eng.ep_degree == 7:
                # replacement rank joins: resize back up through a second
                # controlled recovery cycle
                mgrs[7] = ElasticManager(store, job, np_min=1, np_max=8,
                                         rank=7, endpoint="h7:1",
                                         heartbeat_interval=0.01,
                                         clock=clock, sleep=clock.advance)
                mgrs[7].register()
                eng.save(step=step)
                resume = mgr.restart(cause=None)
                assert recovery.current_generation() == gen0 + 2
                assert eng.ep_degree == 8
                step = int(resume["step"])
                del losses[step:]

        assert resized_down
        # bitwise loss parity vs the uninjected golden, across 8→7→8
        assert losses == golden_losses
        assert eng.state_digest() == golden.state_digest()
        owned = [e for es in eng.owned_experts().values() for e in es]
        assert sorted(owned) == list(range(8))  # zero experts lost
        # the journal names both resizes and the restart
        evs = [e for e in journal.entries()]
        starts = [e for e in evs if e["event"] == "moe_resize_started"]
        dones = {e.get("resize") for e in evs
                 if e["event"] == "moe_resize_completed"}
        assert len(starts) == 2
        assert all(s["resize"] in dones for s in starts)
        assert starts[0]["to_ranks"] == list(range(7))
        assert starts[0]["orphaned"] == [7]
        assert starts[1]["to_ranks"] == list(range(8))
        assert any(e["event"] == "restart" for e in evs)
        ck.close()


# -- the reference engine, step by step ----------------------------------------

def test_state_digest_equals_the_references_step_by_step(tmp_path):
    """The same seeded batches through both engines: equal losses, token
    drops and state digests after every step, through a resize down (rank
    5 dropped, its experts adopted from each package's own manifest) and
    back up."""
    port_ck = AsyncCheckpointer(str(tmp_path / "port"), background=False)
    ref_ck = rsnap.AsyncCheckpointer(str(tmp_path / "ref"),
                                     background=False)
    kw = dict(capacity_factor=0.6, seed=9)
    port = _engine(checkpointer=port_ck, **kw)
    ref = ref_ep.ExpertParallelEngine(8, 4, range(8), checkpointer=ref_ck,
                                      compiled=False, **kw)
    assert port.state_digest() == ref.state_digest()
    for s in range(8):
        x, t = _data(s)
        assert port.step(x, t) == ref.step(x, t), s
        assert port.tokens_dropped_total == ref.tokens_dropped_total
        assert port.state_digest() == ref.state_digest(), s
        if s == 2:
            port.save(step=3, blocking=True)
            ref.save(step=3, blocking=True)
            for eng in (port, ref):
                eng.drop_rank(5)
                assert eng.resize([r for r in range(8) if r != 5]) == [5]
                assert eng.restore() == 3
            assert port.state_digest() == ref.state_digest()
            assert port.placement.ranks == ref.placement.ranks
        if s == 5:
            for eng in (port, ref):
                assert eng.resize(range(8)) == []
            assert port.owned_experts() == ref.owned_experts()
    port_ck.close()
    ref_ck.close()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_expert_manifest_restores_in_the_other_engine(tmp_path, writer):
    root = str(tmp_path / "ck")
    x, t = _data(0)
    kw = dict(seed=4)
    if writer == "port":
        src = _engine(checkpointer=AsyncCheckpointer(root, background=False),
                      **kw)
        dst = ref_ep.ExpertParallelEngine(
            8, 4, range(4), compiled=False,
            checkpointer=rsnap.AsyncCheckpointer(root, background=False),
            **kw)
    else:
        src = ref_ep.ExpertParallelEngine(
            8, 4, range(8), compiled=False,
            checkpointer=rsnap.AsyncCheckpointer(root, background=False),
            **kw)
        dst = ExpertParallelEngine(
            8, 4, range(4),
            checkpointer=AsyncCheckpointer(root, background=False), **kw)
    src.step(x, t)
    src.save(step=1)
    assert dst.restore() == 1
    assert dst.state_digest() == src.state_digest()
    assert dst.ep_degree == 4
