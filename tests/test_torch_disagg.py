"""Disaggregated prefill/decode serving of the port against the reference.

The reference's tests/test_disagg.py, case for case, on the port
(paddle_tpu_torch.serving.disagg and serving/decode/kv_migrate.py): the
two-phase KV handoff (export → ack → adopt → release, journaled and
generation-fenced), the failure matrix (prefill death mid-transfer falls
back to decode-side re-prefill, decode-side shortage refuses typed,
router failure), per-stage pricing on the TTFT and TPOT burn rates,
per-class autoscaling, and the 400-round fake-clock chaos soak. Then both
packages under the same seed and fault schedule: the soak's token streams,
typed errors, refusals, journal events and ``stats()`` are equal, and a
served generation stream is the colocated engine's. Everything runs on the
host (``set_device("cpu")``) on injected fake clocks with no real sleeps;
the backend is the deterministic toy stepper, so equality is exact.
"""
import itertools
import random
import uuid

import pytest

import paddle_tpu.serving.disagg as ref_disagg
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.serving import batcher as ref_batcher
from paddle_tpu.serving.decode import kv_cache as ref_kv_cache

import paddle_tpu_torch as pt
import paddle_tpu_torch.serving.disagg as port_disagg
from paddle_tpu_torch.core import device as port_device
from paddle_tpu_torch.distributed import wire
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import batcher as port_batcher
from paddle_tpu_torch.serving.batcher import DeadlineExceeded, ServerOverloaded
from paddle_tpu_torch.serving.decode import (
    CompiledDecodeBackend, DecodeConfig, DecodeEngine,
)
from paddle_tpu_torch.serving.decode import kv_cache as port_kv_cache
from paddle_tpu_torch.serving.decode.kv_cache import KVCacheExhausted
from paddle_tpu_torch.serving.decode.kv_migrate import (
    KVMigrator, MigrationAborted,
)
from paddle_tpu_torch.serving.disagg import DisaggConfig, DisaggController
from paddle_tpu_torch.serving.metrics import SLO
from paddle_tpu_torch.serving.overload import BurnGate


@pytest.fixture(autouse=True)
def _host(tmp_path, monkeypatch):
    """The port on the host, journals in the test's own directory, both
    fault registries disarmed before and after."""
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "art"))
    before = port_device._current
    pt.set_device("cpu")
    faults.reset()
    ref_faults.reset()
    yield
    faults.reset()
    ref_faults.reset()
    port_device._current = before


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


PROMPT = [1, 2, 3, 4, 5]
GEN = 6


def colocated_tokens(prompt=PROMPT, n=GEN):
    """The reference continuation: what a plain colocated engine yields
    for the same prompt (the deterministic backend is a pure function of
    the prompt, so this is the ground truth every disagg path must match)."""
    clock = FakeClock()
    eng = DecodeEngine(CompiledDecodeBackend(),
                       DecodeConfig(max_new_tokens=n), clock=clock)
    s = eng.join(list(prompt))
    for _ in range(1000):
        if s.done:
            break
        eng.step()
        clock.advance(0.01)
    assert s.done and s.error is None
    return list(s.tokens)


_jobs = itertools.count()
_RUN = uuid.uuid4().hex[:8]


def make_controller(clock=None, **kw):
    kw.setdefault("prefill_token_s", 0.001)
    kw.setdefault("max_new_tokens", GEN)
    # unique job id per controller AND per test run: the journal file is
    # per-job and append-only on disk, and these tests assert on exact
    # event sequences
    return DisaggController(config=DisaggConfig(**kw),
                            clock=clock or FakeClock(),
                            job_id=f"disagg-test-{_RUN}-{next(_jobs)}")


def drive(ctl, clock, handoffs, rounds=2000, dt=0.01):
    for _ in range(rounds):
        ctl.step(clock())
        clock.advance(dt)
        if all(h.done for h in handoffs):
            break
    return handoffs


class TestTwoPhaseHandoff:
    def test_happy_path_token_identical_to_colocated(self):
        clock = FakeClock()
        ctl = make_controller(clock)
        h = ctl.submit(PROMPT, max_new_tokens=GEN)
        drive(ctl, clock, [h])
        assert h.done and h.error is None
        assert list(h.tokens) == colocated_tokens()
        assert h.fallback is False
        assert ctl.stats()["migrations"] == 1
        assert ctl.leaked_blocks() == 0

    def test_journal_records_full_phase_sequence(self):
        clock = FakeClock()
        ctl = make_controller(clock)
        h = ctl.submit(PROMPT, max_new_tokens=GEN)
        drive(ctl, clock, [h])
        ev = [e["event"] for e in ctl.journal.entries()
              if e["event"].startswith("migration")]
        assert ev == ["migration_export", "migration_ack",
                      "migration_adopt", "migration_release"]
        mine = [e for e in ctl.journal.entries()
                if e["event"].startswith("migration")]
        assert all(e["stream"] == h.id for e in mine)

    def test_frames_ride_the_real_codec_stamped_and_fenced(self):
        """export() must produce frames that survive an actual encode →
        decode hop with contiguous seqs, an end marker, and the handoff's
        generation stamp on every one."""
        clock = FakeClock()
        ctl = make_controller(clock)
        h = ctl.submit(PROMPT, max_new_tokens=GEN)
        clock.advance(1.0)
        ctl.step(clock())            # completes the prefill + migration
        entries = [e for e in ctl.journal.entries()
                   if e["event"] == "migration_ack"]
        assert entries and entries[0]["generation"] == \
            ctl.scheduler.generation

    def test_deadline_before_adoption_terminates_typed(self):
        clock = FakeClock()
        # a prefill latency far past the request deadline
        ctl = make_controller(clock, prefill_token_s=10.0)
        h = ctl.submit(PROMPT, max_new_tokens=GEN, timeout=0.5)
        for _ in range(200):
            ctl.step(clock())
            clock.advance(0.1)
            if h.done:
                break
        assert h.done and isinstance(h.error, DeadlineExceeded)
        assert ctl.leaked_blocks() == 0


class TestFailureMatrix:
    @pytest.fixture(autouse=True)
    def _clean_faults(self):
        yield
        faults.reset()

    @pytest.mark.parametrize("site,phase", [
        ("kv.export", "export"), ("kv.transfer", "transfer"),
    ])
    def test_prefill_death_mid_transfer_falls_back(self, site, phase):
        """A replica death during export/transfer must fence the replica,
        journal the abort with its phase, fall back to decode-side
        re-prefill, and still deliver the identical continuation."""
        clock = FakeClock()
        ctl = make_controller(clock)
        faults.configure(f"{site}:#1", seed=3)
        h = ctl.submit(PROMPT, max_new_tokens=GEN)
        drive(ctl, clock, [h])
        assert h.done and h.error is None
        assert h.fallback is True
        assert list(h.tokens) == colocated_tokens()
        aborts = [e for e in ctl.journal.entries()
                  if e["event"] == "migration_aborted"]
        assert aborts and aborts[0]["phase"] == phase
        snap = ctl.stats()
        assert snap["migration_aborts"] == 1
        assert snap["fallback_prefills"] == 1
        assert ctl.leaked_blocks() == 0
        # the fenced replica was rebuilt by maintain(): fleet back to size
        assert snap["prefill_replicas"] == ctl.config.prefill_replicas

    def test_adopt_death_falls_back_without_fencing_prefill(self):
        """kv.adopt implicates the decode side — the prefill replica must
        NOT be fenced for it."""
        clock = FakeClock()
        ctl = make_controller(clock)
        deaths_before = ctl.metrics.get("replica_deaths")
        faults.configure("kv.adopt:#1", seed=3)
        h = ctl.submit(PROMPT, max_new_tokens=GEN)
        drive(ctl, clock, [h])
        assert h.done and h.error is None and h.fallback is True
        assert list(h.tokens) == colocated_tokens()
        assert ctl.metrics.get("replica_deaths") == deaths_before
        assert ctl.leaked_blocks() == 0

    def test_decode_shortage_refuses_typed_claiming_nothing(self):
        clock = FakeClock()
        # decode pool: 1 block of 4 tokens — the 12-token prompt can never
        # be adopted; the refusal must claim nothing
        ctl = make_controller(clock, decode_blocks=1, block_size=4,
                              prefill_blocks=16)
        h = ctl.submit(list(range(1, 13)), max_new_tokens=2)
        for _ in range(200):
            ctl.step(clock())
            clock.advance(0.01)
            if h.done:
                break
        assert h.done and isinstance(h.error, KVCacheExhausted)
        assert h.error.retry_after is not None
        for eng in ctl._engines:
            assert eng.pool.used() == 0     # not one page claimed
        assert ctl.leaked_blocks() == 0
        refused = [e for e in ctl.journal.entries()
                   if e["event"] == "migration_refused"]
        assert refused and refused[0]["reason"] == "KVCacheExhausted"

    def test_route_failure_is_typed_and_retryable(self):
        clock = FakeClock()
        ctl = make_controller(clock)
        faults.configure("disagg.route:#1", seed=1)
        with pytest.raises(ServerOverloaded) as ei:
            ctl.submit(PROMPT, max_new_tokens=GEN)
        assert ei.value.retry_after is not None
        assert ctl.stats()["route_failures"] == 1
        assert ctl.leaked_blocks() == 0
        # the router heals: the next submit lands
        h = ctl.submit(PROMPT, max_new_tokens=GEN)
        drive(ctl, clock, [h])
        assert h.done and h.error is None

    def test_prefill_pool_exhaustion_refuses_before_claiming(self):
        clock = FakeClock()
        ctl = make_controller(clock, prefill_blocks=1, block_size=4)
        with pytest.raises(KVCacheExhausted) as ei:
            ctl.submit(list(range(1, 13)), max_new_tokens=2)
        assert ei.value.retry_after is not None
        assert ctl.leaked_blocks() == 0

    def test_migrator_rejects_cross_generation_frames(self):
        """Frames from two incarnations spliced into one migration must
        abort typed at transfer, before adoption claims anything."""
        clock = FakeClock()
        ctl = make_controller(clock)
        h = ctl.submit(PROMPT, max_new_tokens=GEN)
        mig = KVMigrator(clock=clock)
        frames = mig.export(h, generation=3)
        # a racing rendezvous bumped the generation mid-stream
        wire.stamp_generation(frames[-1], 4)
        with pytest.raises(wire.FrameError, match="generation"):
            mig.transfer(h, frames)
        # through the orchestrated path the fence lands as a typed abort
        # in the transfer phase, before adoption claims anything
        mig.export = lambda handoff, generation=None: frames
        with pytest.raises(MigrationAborted) as ei:
            mig.migrate(h, ctl._engines[0], generation=3)
        assert ei.value.phase == "transfer"
        for eng in ctl._engines:
            assert eng.pool.used() == 0
        h.table.release()


class TestPerStagePricing:
    def _burned_slo(self, bad_frac, name="x", metric="decode.ttft_ms",
                    n=1000):
        """An SLO whose fast-window burn is ``bad_frac / (1 - goodput)``,
        seeded through the real registry histogram + sample path."""
        from paddle_tpu_torch.profiler.metrics import get_registry
        reg = get_registry()
        slo = SLO(name, metric, target_ms=100.0, goodput=0.99)
        slo.sample(0.0, reg)
        bad = int(round(bad_frac * n))
        for i in range(n):
            reg.observe(metric, 5000.0 if i < bad else 1.0)
        slo.sample(10.0, reg)
        return slo

    def test_gate_admits_under_low_burn(self):
        gate = BurnGate(self._burned_slo(0.0), high=2.0, window=60.0,
                        clock=lambda: 10.0)
        gate.admit(0)
        assert gate.snapshot()["admitted"] == 1

    def test_gate_refuses_hot_burn_with_scaled_hint(self):
        gate = BurnGate(self._burned_slo(0.5), high=2.0, window=60.0,
                        retry_after_base=0.1, clock=lambda: 10.0)
        with pytest.raises(ServerOverloaded) as ei:
            gate.admit(0)
        # burn 50x vs threshold 2.0 → hint capped at 8x base
        assert ei.value.retry_after == pytest.approx(0.8)
        assert gate.snapshot()["shed"] == 1

    def test_priority_headroom_sheds_low_classes_first(self):
        # burn ~1.8: under p0's threshold (2.0), over p1's (1.5)
        slo = self._burned_slo(0.018)
        gate = BurnGate(slo, high=2.0, window=60.0, clock=lambda: 10.0)
        gate.admit(0)
        with pytest.raises(ServerOverloaded):
            gate.admit(1)

    def test_stages_price_independently(self):
        """A hot TTFT burn refuses new prefill admission while decode-side
        adoption (priced on TPOT) still accepts — and vice versa."""
        ttft = self._burned_slo(0.5, name="ttft_hot")
        tpot = self._burned_slo(0.0, name="tpot_cool",
                                metric="decode.tpot_ms")
        prefill_gate = BurnGate(ttft, high=2.0, clock=lambda: 10.0)
        decode_gate = BurnGate(tpot, high=2.0, clock=lambda: 10.0)
        with pytest.raises(ServerOverloaded):
            prefill_gate.admit(0)
        decode_gate.admit(0)    # the other stage is unaffected

    def test_controller_refuses_submit_on_ttft_burn(self):
        clock = FakeClock()
        ctl = make_controller(clock)
        from paddle_tpu_torch.profiler.metrics import get_registry
        reg = get_registry()
        ctl.ttft_slo.sample(clock(), reg)
        for _ in range(500):
            reg.observe("decode.ttft_ms", 1e6)
        clock.advance(5.0)
        ctl.ttft_slo.sample(clock(), reg)
        with pytest.raises(ServerOverloaded) as ei:
            ctl.submit(PROMPT, max_new_tokens=GEN)
        assert ei.value.retry_after is not None
        assert ctl.stats()["refusals"] == 1


class TestPerClassAutoscaling:
    def _burn(self, ctl, clock, metric, n=500):
        from paddle_tpu_torch.profiler.metrics import get_registry
        reg = get_registry()
        for _ in range(n):
            reg.observe(metric, 1e6)

    def test_prefill_class_grows_on_ttft_burn(self):
        clock = FakeClock()
        ctl = make_controller(clock, prefill_replicas=1, decode_replicas=1,
                              max_prefill_replicas=3, max_decode_replicas=3)
        before = ctl.stats()
        ctl.step(clock())           # baseline SLO sample precedes the burn
        self._burn(ctl, clock, "decode.ttft_ms")
        for _ in range(6):          # up_stable ticks over the watermark
            clock.advance(1.5)      # past slo_tick's min_interval
            ctl.step(clock())
        snap = ctl.stats()
        assert snap["prefill_replicas"] > before["prefill_replicas"]
        # the decode class saw no TPOT pain: it did not grow
        assert snap["decode_engines"] == before["decode_engines"]

    def test_decode_class_grows_on_tpot_burn(self):
        clock = FakeClock()
        ctl = make_controller(clock, prefill_replicas=1, decode_replicas=1,
                              max_prefill_replicas=3, max_decode_replicas=3)
        before = ctl.stats()
        ctl.step(clock())           # baseline SLO sample precedes the burn
        self._burn(ctl, clock, "decode.tpot_ms")
        for _ in range(6):
            clock.advance(1.5)
            ctl.step(clock())
        snap = ctl.stats()
        assert snap["decode_engines"] > before["decode_engines"]
        assert snap["prefill_replicas"] == before["prefill_replicas"]

    def test_scale_events_journal_their_fleet(self):
        clock = FakeClock()
        ctl = make_controller(clock, prefill_replicas=1, decode_replicas=1,
                              max_prefill_replicas=3, max_decode_replicas=3)
        ctl.step(clock())           # baseline SLO sample precedes the burn
        self._burn(ctl, clock, "decode.ttft_ms")
        for _ in range(6):
            clock.advance(1.5)
            ctl.step(clock())
        ups = [e for e in ctl.journal.entries()
               if e["event"] == "serving_scale_up"]
        assert ups and all(e["fleet"] == "prefill" for e in ups)


class TestServerIntegration:
    def test_attach_disagg_pumps_and_reports(self):
        import numpy as np

        from paddle_tpu_torch.serving import InferenceServer, ServingConfig

        class _Null:
            def run(self, arrays):
                return [np.asarray(arrays[0])]

        clock = FakeClock()
        srv = InferenceServer(lambda i: _Null(),
                              ServingConfig(max_batch_size=2, replicas=1),
                              clock=clock)
        ctl = srv.attach_disagg(config=DisaggConfig(
            prefill_token_s=0.001, max_new_tokens=GEN))
        h = ctl.submit(PROMPT, max_new_tokens=GEN)
        for _ in range(2000):
            srv.pump()
            clock.advance(0.01)
            if h.done:
                break
        assert h.done and h.error is None
        assert list(h.tokens) == colocated_tokens()
        snap = srv.stats()
        assert snap["disagg"]["migrations"] == 1
        srv.stop()
        assert ctl.leaked_blocks() == 0


class TestChaosSoak:
    def test_400_round_soak_no_lost_streams_no_leaked_blocks(self):
        """The acceptance soak: 400 fake-clock rounds with faults armed on
        every migration edge (kv.export / kv.transfer / kv.adopt), the
        router (disagg.route), and the decode tick (decode.step), over
        deliberately tight KV pools. Invariants: every accepted stream
        terminates (tokens or a typed error), every refusal carries
        ``retry_after``, completed streams carry real tokens, and at the
        end not one KV block is leaked in either class's pools."""
        clock = FakeClock()
        ctl = make_controller(
            clock, prefill_replicas=2, decode_replicas=2,
            prefill_blocks=24, decode_blocks=24, block_size=4,
            max_running=4, max_inflight=6, retry_after=0.01,
            prefill_token_s=0.002)
        faults.configure(
            "kv.export:0.05,kv.transfer:0.04,kv.adopt:0.04,"
            "disagg.route:0.03,decode.step:0.02", seed=0xD15A66)
        rng = random.Random(7)
        accepted, refusals = [], []
        try:
            for _ in range(400):
                for _ in range(rng.randrange(0, 3)):
                    n = rng.choice([3, 6, 14])
                    try:
                        accepted.append(ctl.submit(
                            list(range(1, n + 1)),
                            max_new_tokens=rng.choice([2, 4]),
                            timeout=5.0,
                            priority=rng.choice([0, 1, 2])))
                    except (ServerOverloaded, KVCacheExhausted) as e:
                        refusals.append(e)
                ctl.step(clock())
                clock.advance(0.05)
        finally:
            faults.reset()
        # drain with faults disarmed: whatever was accepted must terminate
        for _ in range(4000):
            if ctl.pending() == 0 and ctl.running() == 0:
                break
            ctl.step(clock())
            clock.advance(0.05)
        assert ctl.pending() == 0 and ctl.running() == 0
        assert len(accepted) > 100          # the soak saw real traffic
        assert refusals                     # ...and real backpressure
        for h in accepted:
            assert h.done, f"stream {h.id} never terminated"
            if h.error is not None:
                assert isinstance(h.error, (ServerOverloaded,
                                            KVCacheExhausted,
                                            DeadlineExceeded)), h.error
            else:
                assert len(h.tokens) > 0
        for e in refusals:
            assert getattr(e, "retry_after", None) is not None
        assert ctl.leaked_blocks() == 0
        # the journal tells the story: aborts carry their phase
        aborts = [e for e in ctl.journal.entries()
                  if e["event"] == "migration_aborted"]
        assert all(e["phase"] in ("export", "transfer", "adopt")
                   for e in aborts)


# -- the port against the reference ------------------------------------------

PKGS = {
    "paddle_tpu": (ref_disagg, ref_faults, ref_batcher, ref_kv_cache),
    "paddle_tpu_torch": (port_disagg, faults, port_batcher, port_kv_cache),
}


def soak_run(name, rounds=400):
    """The chaos soak through one package: the same seed, fault schedule
    and submit sequence. Returns what a client and an operator see: every
    accepted stream's tokens or error type, every refusal's type and hint,
    the journal's event sequence (without timestamps) and ``stats()``."""
    disagg, flt, batcher, kv_cache = PKGS[name]
    clock = FakeClock()
    ctl = disagg.DisaggController(
        config=disagg.DisaggConfig(
            prefill_replicas=2, decode_replicas=2, prefill_blocks=24,
            decode_blocks=24, block_size=4, max_running=4, max_inflight=6,
            retry_after=0.01, prefill_token_s=0.002, max_new_tokens=GEN),
        clock=clock, job_id=f"soak-{name}-{_RUN}-{next(_jobs)}")
    flt.configure("kv.export:0.05,kv.transfer:0.04,kv.adopt:0.04,"
                  "disagg.route:0.03,decode.step:0.02", seed=0xD15A66)
    rng = random.Random(7)
    accepted, refusals = [], []
    refused = (batcher.ServerOverloaded, kv_cache.KVCacheExhausted)
    try:
        for _ in range(rounds):
            for _ in range(rng.randrange(0, 3)):
                n = rng.choice([3, 6, 14])
                try:
                    accepted.append(ctl.submit(
                        list(range(1, n + 1)),
                        max_new_tokens=rng.choice([2, 4]), timeout=5.0,
                        priority=rng.choice([0, 1, 2]),
                        request_id=f"s{len(accepted) + len(refusals)}"))
                except refused as e:
                    refusals.append((type(e).__name__, e.retry_after))
            ctl.step(clock())
            clock.advance(0.05)
    finally:
        flt.reset()
    for _ in range(4000):
        if ctl.pending() == 0 and ctl.running() == 0:
            break
        ctl.step(clock())
        clock.advance(0.05)
    skip = {"ts", "job", "pid", "host", "time"}
    journal = [{k: v for k, v in e.items() if k not in skip}
               for e in ctl.journal.entries()]
    return {"streams": [(list(h.tokens), h.fallback,
                         type(h.error).__name__ if h.error else None)
                        for h in accepted],
            "refusals": refusals, "journal": journal,
            "stats": ctl.stats(), "leaked": ctl.leaked_blocks()}


def test_soak_streams_and_stats_match_reference():
    ref, port = soak_run("paddle_tpu"), soak_run("paddle_tpu_torch")
    assert len(port["streams"]) > 100 and port["refusals"]
    assert any(fb for _, fb, _ in port["streams"])   # fallbacks happened
    assert port["leaked"] == ref["leaked"] == 0
    assert port["streams"] == ref["streams"]
    assert port["refusals"] == ref["refusals"]
    assert port["journal"] == ref["journal"]
    assert port["stats"] == ref["stats"]


@pytest.mark.parametrize("site", ["kv.export", "kv.transfer", "kv.adopt"])
def test_faulted_handoff_matches_reference(site):
    """One handoff faulted at each migration edge: the same fallback,
    tokens, journal events and counters in both packages."""
    out = []
    for name in PKGS:
        disagg, flt, _, _ = PKGS[name]
        clock = FakeClock()
        ctl = disagg.DisaggController(
            config=disagg.DisaggConfig(prefill_token_s=0.001,
                                       max_new_tokens=GEN),
            clock=clock, job_id=f"edge-{name}-{_RUN}-{next(_jobs)}")
        flt.configure(f"{site}:#1", seed=1)
        h = ctl.submit(PROMPT, max_new_tokens=GEN, request_id="edge")
        drive(ctl, clock, [h])
        flt.reset()
        out.append((list(h.tokens), h.fallback,
                    [e["event"] for e in ctl.journal.entries()],
                    ctl.stats()["migration_aborts"],
                    ctl.stats()["fallback_prefills"], ctl.leaked_blocks()))
    assert out[1] == out[0]
    assert out[1][0] == colocated_tokens() and out[1][1] is True


def test_c_ref_30_wait_before_adoption_follows_the_stream():
    """ROADMAP C-ref-30 (not mirrored): a Handoff waited on before its
    adoption. The port's wait follows the request onto its decode stream
    and returns True when it ends; the reference's waits on the
    prefill-side event, which adoption never sets, and runs to its
    timeout though the stream has ended. The controller is driven only
    once the waiter is inside wait(), past its check for a stream."""
    import threading

    class Entered(threading.Event):
        """The event wait() blocks on first, reporting when it is."""

        def __init__(self):
            super().__init__()
            self.entered = threading.Event()

        def wait(self, timeout=None):
            self.entered.set()
            return super().wait(timeout)

    got = {}
    for name in PKGS:
        disagg = PKGS[name][0]
        clock = FakeClock()
        ctl = disagg.DisaggController(
            config=disagg.DisaggConfig(prefill_token_s=0.001,
                                       max_new_tokens=GEN),
            clock=clock, job_id=f"wait-{name}-{_RUN}-{next(_jobs)}")
        h = ctl.submit(PROMPT, max_new_tokens=GEN)
        first = Entered()
        if name == "paddle_tpu":
            h._done_evt = first
        else:
            h._staged = first
        waited = {}
        t = threading.Thread(target=lambda: waited.update(
            ok=h.wait(1.0 if name == "paddle_tpu" else 30.0)))
        t.start()
        assert first.entered.wait(10) and h.stream is None
        drive(ctl, clock, [h])
        t.join(timeout=60)
        assert h.done and list(h.tokens) == colocated_tokens()
        got[name] = waited["ok"]
    assert got == {"paddle_tpu": False, "paddle_tpu_torch": True}
