"""The port's silent-data-corruption defence (resilience/integrity.py) and
straggler detection (resilience/health.py), case by case with the
reference's tests/test_integrity.py and the same fake clocks: the bitwise
state checksum and its ``device.bitflip`` site, the store-mediated
consensus vote, the k x median straggler detector, the step-replay ring
and its classification, the in-process chaos acceptance (a flip on rank 2
detected at the first check, rank 2 alone quarantined, the survivors
recovering scaled-in with the golden losses to the bit and the replay
classifying hardware SDC) and the warm path's <= 1 % budget.

Across the packages: ``checksum_state`` over a carried 2-layer, width-64
GPT with its AdamW state equals the reference's digest in f32 and in bf16;
the reference's and the port's ConsensusCheckers vote together in one
FileStore directory; ``tools/replay_step.py`` lists and verifies the
port's replay dump.

One launch of three gloo ranks (``python -m
paddle_tpu_torch.distributed.launch --cpu_sim``, this file as the job)
runs the card group's scenario at 2 layers, width 64: rank 2 armed with
``device.bitflip:#2`` is named at the second check on every rank,
quarantines itself and exits 117 unrelaunched; ranks 0 and 1 journal
``sdc``, flush their background commits, re-rendezvous at np 2 and
restore the newest manifest. A 2-rank launch from a copy of that manifest
gives the same losses to the bit, and the reference's serial run on the
same batches the same within f32 rtol 1e-5.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
               max_position_embeddings=64, dropout=0.0)
WORLD, PER, SEQ, STEPS = 3, 2, 16, 8    # PER rows a rank
CHECK_EVERY = CKPT_EVERY = 2
FLIP = 2                                # rank 2's 2nd digest is flipped
RDZV_S = 4.0                            # the scale-in wait for rank 2
F32 = dict(rtol=1e-5, atol=1e-6)


# -- the job (one rank, started by the launcher) ------------------------------

def _stream():
    rng = np.random.RandomState(11)
    xs = rng.randint(0, GPT_CFG["vocab_size"],
                     (STEPS, WORLD * PER, SEQ)).astype("int64")
    ys = rng.randint(0, GPT_CFG["vocab_size"],
                     (STEPS, WORLD * PER, SEQ)).astype("int64")
    return xs, ys


def _copy_manifest(mpath, dst):
    """A manifest and the files it references, into the root ``dst``."""
    from paddle_tpu_torch.resilience import snapshot
    root = os.path.dirname(mpath)
    os.makedirs(dst, exist_ok=True)
    for rel in snapshot.read_manifest(mpath)["files"]:
        os.makedirs(os.path.join(dst, os.path.dirname(rel)), exist_ok=True)
        for suffix in ("", ".sha256"):
            shutil.copyfile(os.path.join(root, rel) + suffix,
                            os.path.join(dst, rel) + suffix)
    shutil.copyfile(mpath, os.path.join(dst, os.path.basename(mpath)))


def _job(out, mode):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import (
        load_hybrid_checkpoint, save_hybrid_checkpoint)
    from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                           FileStore)
    from paddle_tpu_torch.resilience import faults, snapshot
    from paddle_tpu_torch.resilience.health import Quarantined, run_preflight
    from paddle_tpu_torch.resilience.integrity import (ConsensusChecker,
                                                       IntegrityError,
                                                       StepReplayBuffer)
    from paddle_tpu_torch.resilience.recovery import (RecoveryManager,
                                                      current_generation)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    pt.set_flags({"FLAGS_recovery_backoff_base": 0.0,
                  "FLAGS_async_checkpoint": True})
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    if mode == "recovered" and rank == 2:
        faults.configure(f"device.bitflip:#{FLIP}")
    em = ElasticManager(FileStore(os.path.join(out, "store"), ttl=3600.0),
                        "integrity", np_min=2, np_max=world, rank=rank,
                        endpoint=os.environ["PADDLE_CURRENT_ENDPOINT"])
    em.register()
    gen0, _ = em.rendezvous(timeout=120)
    dist.init_parallel_env()
    model = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu",
                           generator=pt.make_generator(3))
    dp = pt.DataParallel(model)
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    root = os.path.join(out, "ckpt")
    xs, ys = _stream()
    res = {"rank": rank, "losses": {}, "checks": [], "errors": []}
    replay = StepReplayBuffer(size=4)
    checker = ConsensusChecker(em, [model, opt], interval=CHECK_EVERY,
                               timeout=60.0, replay=replay)

    def restore(gen):
        opt.clear_grad()   # a step cut short leaves its local gradients
        dist.barrier()     # every committer flushed before anyone reads
        meta = load_hybrid_checkpoint(root, dp, opt)
        res["restored"] = {
            "step": meta["step"], "generation": gen,
            "manifest": os.path.basename(meta["restored_from"]),
            "newest": os.path.basename(
                snapshot.list_manifests(root)[0][1])}
        if rank == 0:
            _copy_manifest(meta["restored_from"],
                           os.path.join(out, "golden_ckpt"))
        return meta

    def train(resume):
        start = resume["step"] if resume else 0
        for step in range(start, STEPS):
            r = dist.get_rank()
            sl = slice(r * PER, (r + 1) * PER)
            x, y = torch.from_numpy(xs[step, sl]), torch.from_numpy(
                ys[step, sl])
            loss = dp(x, labels=y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            g = loss.detach().reshape(1).clone()
            res["losses"][step] = dist.all_reduce(
                g, op=dist.ReduceOp.AVG).item()
            if (step + 1) % CKPT_EVERY == 0:
                save_hybrid_checkpoint(os.path.join(root, "gpt.pdparams"),
                                       dp, opt, meta={"step": step + 1})
            em.heartbeat()
            try:
                d = checker.after_step(step, inputs=[x, y])
            except IntegrityError as e:
                res["errors"].append({"step": e.step, "culprits": e.culprits,
                                      "kind": e.kind,
                                      "digests": {str(k): v for k, v in
                                                  e.digests.items()}})
                raise
            if d is not None:
                res["checks"].append({"step": step, "digest": d,
                                      "generation": current_generation()})
        return start

    def write():
        res["generation"] = current_generation()
        with open(os.path.join(out, f"{mode}.rank{rank}.json"), "w") as f:
            json.dump(res, f)

    if mode == "golden":
        train(load_hybrid_checkpoint(os.path.join(out, "ckpt"), dp, opt))
    else:
        rm = RecoveryManager(em, restore=restore, max_restarts=1,
                             rendezvous_timeout=RDZV_S,
                             preflight=lambda gen: run_preflight(elastic=em))
        try:
            rm.run(train)
        except Quarantined:
            em.exit()
            write()
            raise
        res["restarts"] = rm.restarts
    assert snapshot.flush_all(timeout=60.0) == []
    write()
    dist.barrier()
    dist.env.teardown()


if __name__ == "__main__":
    # a rank of a launch: torch and the port only
    if sys.argv[1:2] == ["--job"]:
        _job(sys.argv[2], sys.argv[3])
    sys.exit(0)


# -- the test process -----------------------------------------------------------

pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.distributed.fleet.elastic import (  # noqa: E402
    ElasticManager as RefElasticManager)
from paddle_tpu.distributed.fleet.elastic import (  # noqa: E402
    FileStore as RefFileStore)
from paddle_tpu.resilience import integrity as rintegrity  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
import paddle_tpu_torch.nn.functional as F  # noqa: E402
from paddle_tpu_torch import profiler  # noqa: E402
from paddle_tpu_torch.distributed.checkpoint import (  # noqa: E402
    load_hybrid_checkpoint, save_hybrid_checkpoint)
from paddle_tpu_torch.distributed.fleet.elastic import (  # noqa: E402
    ElasticManager, FileStore)
from paddle_tpu_torch.profiler import metrics as pmetrics  # noqa: E402
from paddle_tpu_torch.resilience import (faults, recorder,  # noqa: E402
                                         recovery, watchdog)
from paddle_tpu_torch.resilience.faults import FaultInjected  # noqa: E402
from paddle_tpu_torch.resilience.health import (  # noqa: E402
    QUARANTINE_EXIT_CODE, Quarantined, StragglerDetector, run_preflight)
from paddle_tpu_torch.resilience.integrity import (  # noqa: E402
    ConsensusChecker, IntegrityError, StepReplayBuffer, checksum_state,
    classify_replay, run_step_on_cpu)
from paddle_tpu_torch.resilience.recorder import FlightRecorder  # noqa: E402
from paddle_tpu_torch.resilience.recovery import (  # noqa: E402
    RecoveryJournal, RecoveryManager)


@pytest.fixture(autouse=True)
def _clean_state(tmp_path, monkeypatch):
    """Fresh faults, recorder, watchdog, generation, journal and profiler
    per test; artifacts into tmp_path; no retry backoff."""
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "artifacts"))
    pt.set_flags({"FLAGS_retry_backoff_base": 0.0})
    for reset in (faults.reset, recorder.reset, watchdog.reset,
                  recovery.reset_generation, recovery.reset_journal,
                  pmetrics.reset_registry):
        reset()
    profiler._recorder.enabled = False
    profiler.reset_profiler()
    yield
    for reset in (faults.reset, recorder.reset, watchdog.reset,
                  recovery.reset_generation, recovery.reset_journal,
                  pmetrics.reset_registry):
        reset()
    profiler._recorder.enabled = False
    profiler.reset_profiler()
    from paddle_tpu_torch.distributed import env
    env._STATE["rendezvous"] = None
    pt.set_flags({"FLAGS_retry_backoff_base": 0.5,
                  "FLAGS_preflight_checks": True})


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _make(seed=0):
    pt.seed(seed)
    model = pt.nn.Linear(4, 4, device="cpu")
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    return model, opt


def _data(step):
    rng = np.random.RandomState(1000 + step)
    return (rng.randn(8, 4).astype(np.float32),
            rng.randn(8, 4).astype(np.float32))


def _apply_step(model, opt, x, y):
    loss = F.mse_loss(model(torch.tensor(x)), torch.tensor(y))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return float(loss.detach())


def _sgd_step(model, opt, step):
    x, y = _data(step)
    return _apply_step(model, opt, x, y)


def _managers(tmp_path, n, job="j", np_min=1, clock=None, sleeps=None,
              ttl=1e6):
    st = FileStore(str(tmp_path / "store"), ttl=ttl)
    ems = []
    for r in range(n):
        em = ElasticManager(st, job, np_min=np_min, np_max=n, rank=r,
                            endpoint=f"h{r}:1", clock=clock,
                            sleep=(sleeps or {}).get(r))
        em.register()
        ems.append(em)
    return st, ems


# -- the bitwise state checksum ---------------------------------------------------

class TestChecksumState:
    def test_identical_replicas_agree_bitwise(self):
        a, b = _make(seed=4), _make(seed=4)
        assert checksum_state(list(a)) == checksum_state(list(b))
        _sgd_step(*a, 0)
        assert checksum_state(list(a)) != checksum_state(list(b))
        _sgd_step(*b, 0)
        assert checksum_state(list(a)) == checksum_state(list(b))

    def test_single_flipped_bit_changes_digest(self):
        model, opt = _make(seed=4)
        clean = checksum_state([model, opt])
        with torch.no_grad():
            model.weight.view(torch.int32).view(-1)[0] ^= 1
        assert checksum_state([model, opt]) != clean

    def test_device_bitflip_corrupts_exactly_the_armed_evaluation(self):
        model, opt = _make(seed=4)
        faults.configure("device.bitflip:#2")
        d1, d2, d3 = (checksum_state([model, opt]) for _ in range(3))
        assert d1 == d3 and d2 != d1 and d2[1:] == d1[1:]
        (note,) = [e for e in recorder.get_recorder().entries()
                   if e["op"] == "device.bitflip"]
        assert note["seq"] == 2 and note["status"] == "corrupted"

    def test_checksum_site_is_raising_injectable(self):
        faults.configure("integrity.checksum:#1")
        with pytest.raises(FaultInjected):
            checksum_state([_make(seed=1)[0]])

    # int32: the reference's int64 is int32 without JAX's x64 mode
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                       torch.int32, torch.bool])
    def test_leaf_bytes_are_the_references(self, dtype):
        """A tensor leaf hashes as the reference hashes the same array:
        key, numpy's dtype name, the shape tuple, the raw bytes."""
        t = (torch.arange(12).reshape(3, 4) % 3).to(dtype)
        sd = {"b": t, "a": {"s": 2.5, "n": None, "l": [1, "x"]},
              "z": torch.tensor(7.0).to(dtype)}
        ref = {"b": paddle.to_tensor(t.float().numpy()).astype(
            str(dtype).replace("torch.", "")),
            "a": {"s": 2.5, "n": None, "l": [1, "x"]},
            "z": paddle.to_tensor(np.float32(7.0)).astype(
                str(dtype).replace("torch.", ""))}
        assert checksum_state([sd]) == rintegrity.checksum_state([ref])


def _ref_gpt(dtype):
    from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
    from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT
    paddle.seed(0)
    ref = RefGPT(RefConfig(**GPT_CFG))
    if dtype == "bfloat16":
        ref.to(dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=ref.parameters(),
                                 multi_precision=dtype == "bfloat16")
    ids = np.random.RandomState(1).randint(0, 128, (2, 16)).astype("int64")
    loss = ref(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    loss.backward()
    opt.step()
    opt.clear_grad()
    return ref, opt, ids


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carried_gpt_and_adamw_state_hash_as_the_references(dtype):
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    ref, ropt, ids = _ref_gpt(dtype)
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    port = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu",
                          dtype=getattr(torch, dtype))
    popt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=port.parameters(),
                              multi_precision=dtype == "bfloat16")
    # the accumulators exist after a step; then the reference's state
    port(torch.tensor(ids), labels=torch.tensor(ids)).backward()
    popt.step()
    popt.clear_grad()
    pt.load_numpy_state_dict(port, arrays)
    popt.set_state_dict({k: np.asarray(v._val) if hasattr(v, "_val") else v
                         for k, v in ropt.state_dict().items()})
    want = rintegrity.checksum_state([ref, ropt])
    assert checksum_state([port, popt]) == want
    assert checksum_state(port) == rintegrity.checksum_state(ref)


# -- cross-replica consensus -------------------------------------------------------

class TestConsensusChecker:
    def _checker(self, em, objs, **kw):
        kw.setdefault("interval", 1)
        kw.setdefault("timeout", 0.0)
        return ConsensusChecker(em, objs, **kw)

    def test_unanimous_group_passes(self, tmp_path):
        _, ems = _managers(tmp_path, 3)
        reps = [_make(seed=6) for _ in ems]
        checkers = [self._checker(em, list(rep))
                    for em, rep in zip(ems, reps)]
        for c in checkers[1:]:
            c.check(0)
        assert checkers[0].check(0) == checksum_state(list(reps[0]))
        assert checkers[0].counters == {"checks": 1, "divergences": 0,
                                        "seconds": 0.0}

    def test_minority_rank_is_named_quarantined_and_dumps(self, tmp_path):
        _, ems = _managers(tmp_path, 3)
        good, bad = _make(seed=6), _make(seed=99)
        rec = FlightRecorder(size=8, rank=2, clock=FakeClock())
        replay = StepReplayBuffer(size=4, rank=2)
        replay.record(5, inputs=[np.ones(3, np.float32)])
        c2 = self._checker(ems[2], list(bad), recorder=rec, replay=replay)
        for r in (0, 1):
            ems[r].store.put(c2._prefix(5) + f"rank.{r}",
                             {"rank": r, "digest": checksum_state(list(good)),
                              "step": 5})
        with pytest.raises(IntegrityError) as exc:
            c2.check(5)
        e = exc.value
        assert e.kind == "sdc" and e.culprits == [2] and e.step == 5
        assert len(e.digests) == 3
        assert ems[2].is_quarantined() and not ems[0].is_quarantined()
        assert os.path.exists(os.path.join(
            os.environ["PADDLE_TPU_ARTIFACTS_DIR"], "step_replay_rank2.json"))
        (entry,) = [x for x in rec.entries()
                    if x["op"] == "integrity.consensus"]
        assert entry["status"] == "divergent" and entry["culprits"] == [2]

    def test_survivor_raises_but_does_not_quarantine_itself(self, tmp_path):
        _, ems = _managers(tmp_path, 3)
        good = _make(seed=6)
        c0 = self._checker(ems[0], list(good))
        ems[1].store.put(c0._prefix(0) + "rank.1",
                         {"rank": 1, "digest": checksum_state(list(good)),
                          "step": 0})
        ems[2].store.put(c0._prefix(0) + "rank.2",
                         {"rank": 2, "digest": "0" * 64, "step": 0})
        with pytest.raises(IntegrityError) as exc:
            c0.check(0)
        assert exc.value.culprits == [2]
        assert not ems[0].is_quarantined()

    def test_two_way_tie_is_deterministic_across_ranks(self, tmp_path):
        _, ems = _managers(tmp_path, 2)
        a, b = _make(seed=1), _make(seed=2)
        da, db = checksum_state(list(a)), checksum_state(list(b))
        expected_culprit = 0 if min(da, db) == da else 1
        self._checker(ems[1], list(b)).check(0)
        with pytest.raises(IntegrityError) as exc:
            self._checker(ems[0], list(a)).check(0)
        assert exc.value.culprits == [expected_culprit]

    def test_interval_gates_the_warm_path(self, tmp_path):
        _, (em,) = _managers(tmp_path, 1)
        c = ConsensusChecker(em, [_make(seed=0)[0]], interval=4, timeout=0.0,
                             replay=StepReplayBuffer(size=8, rank=0))
        for step in range(3):
            assert c.after_step(step, inputs=[np.ones(2)]) is None
        assert em.store.alive_values("j/integrity.") == []
        assert c.after_step(3, inputs=[np.ones(2)]) is not None
        assert c.counters["checks"] == 1
        assert c.replay.steps() == [0, 1, 2, 3]
        (s,) = profiler.counter_samples("integrity.check_ms")
        assert s[2] >= 0.0

    def test_gather_timeout_bounded_by_fake_clock(self, tmp_path):
        clock = FakeClock()
        _, ems = _managers(tmp_path, 2, clock=clock)
        c0 = ConsensusChecker(ems[0], [_make(seed=0)[0]], interval=1,
                              timeout=30.0, clock=clock, sleep=clock.advance)
        digest = c0.check(0)
        assert isinstance(digest, str) and len(digest) == 64
        assert clock.t >= 30.0

    @pytest.mark.parametrize("bad", [None, 1, 2])
    def test_reference_and_port_vote_in_one_store(self, tmp_path, bad):
        """Ranks 0 and 2 of the port and rank 1 of the reference publish
        under one FileStore directory; each package's vote names the same
        culprits."""
        root = str(tmp_path / "store")
        ports = {r: ElasticManager(FileStore(root, ttl=1e6), "j", np_min=1,
                                   np_max=3, rank=r, endpoint=f"h{r}:1")
                 for r in (0, 2)}
        ref_em = RefElasticManager(RefFileStore(root, ttl=1e6), "j",
                                   np_min=1, np_max=3, rank=1,
                                   endpoint="h1:1")
        for em in (*ports.values(), ref_em):
            em.register()
        w = np.random.RandomState(0).randn(4, 4).astype(np.float32)
        state = {r: {"w": torch.tensor(w if r != bad else w + 1)}
                 for r in (0, 2)}
        ref_state = {"w": paddle.to_tensor(w if bad != 1 else w + 1)}
        outcome = {}

        def vote(r, checker):
            try:
                outcome[r] = checker.check(0)
            except (IntegrityError, rintegrity.IntegrityError) as e:
                outcome[r] = e.culprits
        ConsensusChecker(ports[2], [state[2]], interval=1,
                         timeout=0.0).elastic.store.put(
            f"j/integrity.0.0/rank.2",
            {"rank": 2, "digest": checksum_state([state[2]]), "step": 0})
        vote(1, rintegrity.ConsensusChecker(ref_em, [ref_state], interval=1,
                                            timeout=0.0))
        vote(0, ConsensusChecker(ports[0], [state[0]], interval=1,
                                 timeout=0.0))
        if bad is None:
            assert outcome[0] == checksum_state([state[0]])
        else:
            assert outcome[0] == [bad]
            assert outcome[1] == [bad]


# -- straggler detection ------------------------------------------------------------

class TestStragglerDetector:
    def _group(self, tmp_path, n=3, **kw):
        _, ems = _managers(tmp_path, n)
        return ems, [StragglerDetector(em, window=4, threshold=3.0, **kw)
                     for em in ems]

    def test_slow_rank_flagged_with_ratio(self, tmp_path):
        profiler.start_profiler()
        ems, dets = self._group(tmp_path)
        rec = FlightRecorder(size=8, rank=0, clock=FakeClock())
        dets[0].recorder = rec
        for _ in range(3):
            dets[0].note_step(0.1)
            dets[1].note_step(0.1)
            dets[2].note_step(0.5)
        assert dets[0].check() == [2]
        assert dets[0].last_ratios[2] == pytest.approx(5.0)
        assert dets[0].last_ratios[0] == pytest.approx(1.0)
        (s,) = profiler.counter_samples("straggler.rank2")
        assert s[2] == pytest.approx(5.0)
        assert profiler.counter_samples("steptime.rank2_ms")
        (entry,) = [x for x in rec.entries()
                    if x["op"] == "health.straggler"]
        assert entry["peer"] == 2 and entry["status"] == "detected"

    def test_rolling_window_forgets_old_steps(self, tmp_path):
        _, (em,) = _managers(tmp_path, 1)
        d = StragglerDetector(em, window=2, threshold=3.0)
        d.note_step(1.0)
        d.note_step(0.1)
        assert d.note_step(0.1) == pytest.approx(0.1)

    def test_begin_end_bracket_uses_injected_clock(self, tmp_path):
        clock = FakeClock()
        _, (em,) = _managers(tmp_path, 1)
        d = StragglerDetector(em, window=4, clock=clock)
        assert d.end_step() is None
        d.begin_step()
        clock.advance(0.25)
        assert d.end_step() == pytest.approx(0.25)
        assert em.store.get("j/steptime.0")["mean"] == pytest.approx(0.25)

    def test_single_rank_has_no_peers_to_lag(self, tmp_path):
        _, (em,) = _managers(tmp_path, 1)
        d = StragglerDetector(em, window=4, threshold=3.0)
        d.note_step(9.9)
        assert d.check() == []

    def test_detection_only_by_default_quarantine_opt_in(self, tmp_path):
        ems, dets = self._group(tmp_path)
        for _ in range(3):
            for d, t in zip(dets, (0.1, 0.1, 0.5)):
                d.note_step(t)
        assert dets[2].check() == [2]
        assert not ems[2].is_quarantined()
        d2q = StragglerDetector(ems[2], window=4, threshold=3.0,
                                quarantine=True)
        d2q.note_step(0.5)
        with pytest.raises(Quarantined) as exc:
            d2q.check()
        assert "group median" in exc.value.reason
        assert ems[2].is_quarantined()

    def test_flags_set_the_defaults(self, tmp_path):
        _, (em,) = _managers(tmp_path, 1)
        d = StragglerDetector(em)
        assert (d.window, d.threshold, d.quarantine) == (50, 3.0, False)
        pt.set_flags({"FLAGS_straggler_window": 7,
                      "FLAGS_straggler_threshold": 2.0})
        try:
            d = StragglerDetector(em)
            assert (d.window, d.threshold) == (7, 2.0)
        finally:
            pt.set_flags({"FLAGS_straggler_window": 50,
                          "FLAGS_straggler_threshold": 3.0})


# -- step replay --------------------------------------------------------------------

class TestStepReplay:
    def test_ring_is_bounded(self):
        buf = StepReplayBuffer(size=3, rank=0)
        for s in range(5):
            buf.record(s, inputs=[np.full(2, s, np.float32)])
        assert len(buf) == 3 and buf.steps() == [2, 3, 4]

    def test_classification_matrix(self):
        assert classify_replay("d", expected_digest="d") == "hardware_sdc"
        assert classify_replay("d", expected_digest="e",
                               observed_digest="d") == "software_bug"
        assert classify_replay("d", expected_digest="e",
                               observed_digest="f") == "inconclusive"
        assert classify_replay("d") == "unverified"

    def test_replay_reruns_step_on_cpu(self):
        buf = StepReplayBuffer(size=4, rank=0)
        x = np.arange(6, dtype=np.float32)
        buf.record(3, inputs=[torch.tensor(x)])

        def fn(entry):
            assert torch.empty(1).device.type == "cpu"
            return hashlib.sha256(
                (entry["inputs"][0] * 2).tobytes()).hexdigest()
        want = hashlib.sha256((x * 2).tobytes()).hexdigest()
        assert buf.replay(3, fn, expected_digest=want,
                          observed_digest="f" * 64) == {
            "step": 3, "digest": want, "classification": "hardware_sdc"}

    def test_run_step_on_cpu_checksums_state_results(self):
        model, _ = _make(seed=3)
        assert run_step_on_cpu(lambda entry: model, {"step": 0}) == \
            checksum_state([model])

    def test_tampered_ring_cannot_testify(self):
        buf = StepReplayBuffer(size=4, rank=0)
        buf.record(1, inputs=[np.zeros(4, np.float32)])
        buf.get(1)["inputs"][0][0] = 7.0
        with pytest.raises(IntegrityError) as exc:
            buf.replay(1, lambda e: "x")
        assert exc.value.kind == "replay"

    def test_replay_site_is_fault_injectable(self):
        buf = StepReplayBuffer(size=4, rank=0)
        buf.record(1, inputs=[np.zeros(2)])
        faults.configure("integrity.replay:#1")
        with pytest.raises(FaultInjected):
            buf.replay(1, lambda e: "x")

    def test_missing_step_raises_keyerror(self):
        buf = StepReplayBuffer(size=4, rank=0)
        buf.record(1, inputs=[])
        with pytest.raises(KeyError, match="not in replay ring"):
            buf.replay(9, lambda e: "x")

    def test_bf16_inputs_widen_exactly(self):
        buf = StepReplayBuffer(size=2, rank=0)
        t = torch.randn(5).to(torch.bfloat16)
        e = buf.record(0, inputs=[t], rng_key=torch.get_rng_state())
        assert e["inputs"][0].dtype == np.float32
        np.testing.assert_array_equal(e["inputs"][0], t.float().numpy())
        assert e["rng_key"].dtype == np.uint8

    def test_dump_is_read_by_the_references_replay_step(self, tmp_path):
        buf = StepReplayBuffer(size=4, rank=0)
        buf.record(3, inputs=[torch.arange(6, dtype=torch.float32)],
                   rng_key=np.array([0, 1], np.uint32))
        jp = buf.dump(dir=str(tmp_path), reason="test")
        meta = json.loads(open(jp).read())
        assert meta["rank"] == 0 and meta["reason"] == "test"
        assert meta["entries"][0]["rng_key"] == "s3_rng"
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        r = subprocess.run([sys.executable,
                            os.path.join(REPO, "tools", "replay_step.py"),
                            jp], cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "step 3" in r.stdout and "ok" in r.stdout


# -- RecoveryManager journals the typed verdict -------------------------------------

def test_restart_journals_sdc_with_culprits_and_quarantines_self(tmp_path):
    clock = FakeClock()
    st = FileStore(str(tmp_path / "store"), ttl=1e6)
    em = ElasticManager(st, "j", np_min=1, np_max=1, rank=0, endpoint="h0:1",
                        clock=clock, sleep=clock.advance)
    em.register()
    journal = RecoveryJournal("j", dir=str(tmp_path), clock=clock)
    rm = RecoveryManager(em, restore=lambda gen: {"gen": gen},
                         max_restarts=3, rendezvous_timeout=5.0,
                         backoff_base=0.0, sleep=clock.advance,
                         journal=journal)
    assert rm.restart(cause=IntegrityError("x", culprits=[3], step=4)) == \
        {"gen": 1}
    (entry,) = journal.entries()
    assert entry["cause"] == "sdc" and entry["culprits"] == [3]
    # an accused self is marked, and its rendezvous is the quarantine exit
    with pytest.raises(Quarantined) as exc:
        rm.restart(cause=IntegrityError("y", culprits=[0], step=5))
    assert exc.value.code == QUARANTINE_EXIT_CODE
    assert em.is_quarantined()


# -- the chaos acceptance, in process ------------------------------------------------

class TestChaosIntegrityAcceptance:
    def test_bitflip_detected_quarantined_and_training_continues(
            self, tmp_path):
        t0 = time.monotonic()
        golden_model, golden_opt = _make(seed=5)
        golden = [_sgd_step(golden_model, golden_opt, s) for s in range(8)]

        clock = FakeClock()
        st = FileStore(str(tmp_path / "store"), ttl=1e6)
        ems = {}
        allow2 = [True]

        def sleep0(dt):
            clock.advance(dt)
            rec = st.get("jobI/gen") or {}
            if rec.get("gen"):  # peers show up during rank 0's waits
                ems[1].announce(rec["gen"])
                if allow2[0]:
                    ems[2].announce(rec["gen"])

        hook = {"armed": False, "step": None}

        def sleep2(dt):
            clock.advance(dt)
            if hook["armed"]:  # rank 0's report lands mid-gather
                hook["armed"] = False
                d0 = checksum_state([models[0], opts[0]])
                st.put(checkers[2]._prefix(hook["step"]) + "rank.0",
                       {"rank": 0, "digest": d0, "step": hook["step"]})

        for r, slp in ((0, sleep0), (1, clock.advance), (2, sleep2)):
            ems[r] = ElasticManager(st, "jobI", np_min=1, np_max=3, rank=r,
                                    endpoint=f"h{r}:1", clock=clock,
                                    sleep=slp)
            ems[r].register()
        gen0, eps0 = ems[0].rendezvous(timeout=5.0)
        assert gen0 == 1 and len(eps0) == 3

        models, opts = {}, {}
        for r in range(3):
            models[r], opts[r] = _make(seed=5)
        replay2 = StepReplayBuffer(size=4, rank=2)
        checkers = {
            r: ConsensusChecker(ems[r], [models[r], opts[r]], interval=4,
                                timeout=30.0, clock=clock,
                                sleep=(sleep2 if r == 2 else clock.advance),
                                replay=(replay2 if r == 2 else None))
            for r in range(3)}
        faults.configure("device.bitflip:#2")

        ckpt = str(tmp_path / "ckpt.pdparams")
        journal = RecoveryJournal("jobI", dir=str(tmp_path), clock=clock)
        alive = {0, 1, 2}
        losses = {0: {}, 1: {}}
        caught2 = []

        def train(resume):
            start = resume["step"] if resume else 0
            for step in range(start, 8):
                x, y = _data(step)
                losses[0][step] = _apply_step(models[0], opts[0], x, y)
                losses[1][step] = _apply_step(models[1], opts[1], x, y)
                if 2 in alive:
                    _apply_step(models[2], opts[2], x, y)
                save_hybrid_checkpoint(ckpt, models[0], opts[0],
                                       meta={"step": step + 1})
                if (step + 1) % 4 == 0:
                    checkers[1].after_step(step, inputs=[x, y])
                    if 2 in alive:
                        hook.update(armed=True, step=step)
                        try:
                            checkers[2].after_step(step, inputs=[x, y])
                        except IntegrityError as e:
                            caught2.append(e)
                            alive.discard(2)
                            allow2[0] = False
                            ems[2].exit()
                    checkers[0].after_step(step, inputs=[x, y])
                elif 2 in alive:
                    checkers[2].after_step(step, inputs=[x, y])
            return "done"

        def restore(gen):
            return load_hybrid_checkpoint(ckpt, models[0], opts[0])

        rm = RecoveryManager(ems[0], restore=restore, max_restarts=3,
                             rendezvous_timeout=5.0, backoff_base=1.0,
                             sleep=sleep0, journal=journal,
                             preflight=lambda gen: run_preflight(
                                 elastic=ems[0]))
        assert rm.run(train) == "done"

        (err2,) = caught2
        assert err2.step == 3 and err2.culprits == [2]
        assert rm.restarts == 1
        assert recovery.current_generation() == 2
        quarantined = ems[0].quarantined_nodes()
        assert [q["rank"] for q in quarantined] == [2]
        assert "step 3" in quarantined[0]["reason"]
        assert st.get("jobI/preflight.0")["ok"] is True
        with pytest.raises(Quarantined) as exc:
            ems[2].rendezvous(timeout=1.0)
        assert exc.value.code == QUARANTINE_EXIT_CODE

        ents = [e for e in journal.entries() if e["event"] == "restart"]
        assert [e["cause"] for e in ents] == ["sdc"]
        assert ents[0]["culprits"] == [2]
        assert ents[0]["generation"] == 2 and ents[0]["np"] == 2

        for r in (0, 1):
            np.testing.assert_allclose(
                [losses[r][s] for s in range(8)], golden, rtol=0, atol=0)
        assert checkers[0].counters == pytest.approx(
            {"checks": 2, "divergences": 1,
             "seconds": checkers[0].counters["seconds"]})

        majority, observed = err2.digests[0], err2.digests[2]
        assert majority == err2.digests[1] != observed

        def replay_fn(entry):
            model, opt = _make(seed=5)
            for s in range(entry["step"]):
                _sgd_step(model, opt, s)
            _apply_step(model, opt, entry["inputs"][0], entry["inputs"][1])
            return checksum_state([model, opt])

        verdict = replay2.replay(3, replay_fn, expected_digest=majority,
                                 observed_digest=observed)
        assert verdict["classification"] == "hardware_sdc"
        assert os.path.exists(os.path.join(
            os.environ["PADDLE_TPU_ARTIFACTS_DIR"], "step_replay_rank2.json"))
        assert time.monotonic() - t0 < 60.0

    def test_warm_path_overhead_within_one_percent(self, tmp_path):
        _, (em,) = _managers(tmp_path, 1)
        model, opt = _make(seed=1)
        checker = ConsensusChecker(em, [model, opt], timeout=1.0,
                                   replay=StepReplayBuffer(size=8, rank=0))
        assert checker.interval == 100  # FLAGS_integrity_check_interval
        profiler.start_profiler()
        t0 = time.perf_counter()
        for step in range(200):
            _sgd_step(model, opt, step)
            x, y = _data(step)
            checker.after_step(step, inputs=[x, y])
        total_ms = (time.perf_counter() - t0) * 1e3
        samples = profiler.counter_samples("integrity.check_ms")
        assert len(samples) == 2
        check_ms = sum(v for _, _, v in samples)
        assert checker.counters["checks"] == 2
        assert check_ms <= 0.01 * total_ms, (
            f"integrity checks cost {check_ms:.2f}ms of {total_ms:.0f}ms "
            f"({100 * check_ms / total_ms:.2f}% > 1% budget)")


# -- three gloo ranks: detection, quarantine, scale-in, restore --------------------

def _launch(tmp, mode, nproc):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "PADDLE_TPU_ARTIFACTS_DIR": str(tmp / f"artifacts_{mode}"),
           "PADDLE_JOB_ID": "integrity"}
    env.pop("PADDLE_TPU_WIRE_SECRET", None)
    # --max_restarts 1: the supervisor leaves a quarantined rank down
    # without charging it; at 0 the plain watcher ends the job at the
    # first nonzero exit
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--cpu_sim", "--max_restarts",
           "1", "--log_dir", str(tmp / f"logs_{mode}"), HERE, "--job",
           str(tmp), mode]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def _finish(p, tmp, mode, timeout=240):
    try:
        text = p.communicate(timeout=timeout)[0].decode(errors="replace")
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    d = tmp / f"logs_{mode}"
    for name in sorted(os.listdir(d)) if d.exists() else ():
        text += f"\n--- {name}\n" + (d / name).read_text()[-3000:]
    return p.returncode, text


def _ref_serial():
    """The reference's serial AdamW steps from the ranks' initial weights:
    the 3 ranks' rows before the restore's step, the 2 survivors' after."""
    from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
    from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT

    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    port = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu",
                          generator=pt.make_generator(3))
    ref = RefGPT(RefConfig(**GPT_CFG))
    ref.set_state_dict({k: v.detach().numpy()
                        for k, v in port.state_dict().items()})
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=ref.parameters())
    xs, ys = _stream()
    restored = CHECK_EVERY * FLIP   # the step of the newest commit
    losses = []
    for step in range(STEPS):
        rows = WORLD * PER if step < restored else (WORLD - 1) * PER
        loss = ref(paddle.to_tensor(xs[step, :rows]),
                   labels=paddle.to_tensor(ys[step, :rows]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("integrity")
    started = _launch(tmp, "recovered", WORLD)
    ref = _ref_serial()      # while the ranks run
    code, text = _finish(started, tmp, "recovered")
    assert code == 0, f"recovered launch exited {code}:\n{text[-8000:]}"
    shutil.copytree(tmp / "golden_ckpt", tmp / "golden" / "ckpt")
    code, text = _finish(_launch(tmp / "golden", "golden", WORLD - 1),
                         tmp / "golden", "golden")
    assert code == 0, f"golden launch exited {code}:\n{text[-8000:]}"

    def read(d, mode, r):
        with open(d / f"{mode}.rank{r}.json") as f:
            return json.load(f)
    return tmp, {r: read(tmp, "recovered", r) for r in range(WORLD)}, \
        {r: read(tmp / "golden", "golden", r) for r in range(WORLD - 1)}, ref


def test_flipped_rank_is_named_quarantined_and_exits_117(launched):
    tmp, rec, _, _ = launched
    fault_step = CHECK_EVERY * FLIP - 1
    for r in range(WORLD):
        # the first check was unanimous; the second names rank 2 everywhere
        assert [c["step"] for c in rec[r]["checks"]][:1] == \
            [CHECK_EVERY - 1], rec[r]["checks"]
        (err,) = rec[r]["errors"]
        assert err["step"] == fault_step and err["culprits"] == [2], err
        assert err["kind"] == "sdc"
        assert len(set(err["digests"].values())) == 2
    assert rec[2]["generation"] == 1
    journal = RecoveryJournal("integrity",
                              dir=str(tmp / "artifacts_recovered")).entries()
    quarantined = [e for e in journal if e["event"] == "quarantined"]
    assert [(e["rank"], e["code"]) for e in quarantined] == \
        [(2, QUARANTINE_EXIT_CODE)]
    assert not [e for e in journal if e["event"] == "worker_restart"]
    assert os.path.exists(tmp / "artifacts_recovered" /
                          "step_replay_rank2.json")


def test_survivors_journal_sdc_scale_in_and_restore_the_newest(launched):
    tmp, rec, _, _ = launched
    journal = RecoveryJournal("integrity",
                              dir=str(tmp / "artifacts_recovered")).entries()
    restarts = [e for e in journal if e["event"] == "restart"]
    assert len(restarts) == 2, journal
    for e in restarts:
        assert e["cause"] == "sdc" and e["culprits"] == [2]
        assert e["generation"] == 2 and e["np"] == 2
    assert not [e for e in journal if e["event"] == "ckpt_commit_failed"]
    for r in (0, 1):
        res = rec[r]
        assert res["generation"] == 2 and res["restarts"] == 1
        restored = res["restored"]
        # the commit of the fault's step was in flight: flushed, then read
        assert restored["step"] == CHECK_EVERY * FLIP
        assert restored["manifest"] == restored["newest"]
        # every check after the restore was unanimous, at generation 2
        after = [c for c in res["checks"] if c["generation"] == 2]
        assert [c["step"] for c in after] == [5, 7]
        assert after[0]["digest"] != after[1]["digest"]
    assert [c["digest"] for c in rec[0]["checks"]] == \
        [c["digest"] for c in rec[1]["checks"]]


def test_survivors_losses_equal_the_golden_and_the_reference(launched):
    _, rec, gold, ref = launched
    restored = CHECK_EVERY * FLIP
    after = [str(s) for s in range(restored, STEPS)]
    for r in (0, 1):
        assert [rec[r]["losses"][s] for s in after] == \
            [gold[0]["losses"][s] for s in after]
    assert [gold[1]["losses"][s] for s in after] == \
        [gold[0]["losses"][s] for s in after]
    got = [rec[0]["losses"][str(s)] for s in range(STEPS)]
    np.testing.assert_allclose(got, ref, **F32)
    assert np.isfinite(got).all()

