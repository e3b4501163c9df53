"""The serving layer of the port against the reference, on the host.

Every scenario runs twice, through paddle_tpu.serving and through
paddle_tpu_torch.serving, with the same fake clock, predictor doubles,
submits, flags and fault specs (``faults.configure``), in pump mode. What
each run observes — every reply (or its error's type), the sheds and their
reasons, ``metrics.snapshot()`` (counters, latency percentiles, occupancy,
gauges), the admission controller's and the replicas' state, the compile
counts, the breakers' transitions, the hedging counters and the flight
recorder's statuses — must be equal. The scenarios are the matching cases
of the reference's tests/test_serving.py and tests/test_overload.py: the
batcher and its buckets, bounded compiles over random row counts, queue-
full and deadline sheds, the chaos cases (replica death, dispatch hangs,
unretryable failures, deadlines too tight to retry, every replica dead),
AIMD admission, circuit breakers (open, half-open probe with preflight and
canary, reopen), hedging, round-robin placement, elastic membership with a
fenced late result, re-warming after a restart and an overload soak. A
server over a real ``inference.Config`` closes it.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.inference as ref_infer
import paddle_tpu.serving as ref_serving
from paddle_tpu.profiler import metrics as ref_metrics
from paddle_tpu.resilience import faults as ref_faults
from paddle_tpu.resilience import recorder as ref_recorder

import paddle_tpu_torch as pt
import paddle_tpu_torch.inference as port_infer
import paddle_tpu_torch.serving as port_serving
from paddle_tpu_torch.profiler import metrics as port_metrics
from paddle_tpu_torch.resilience import faults as port_faults
from paddle_tpu_torch.resilience import recorder as port_recorder

torch.set_num_threads(1)

PKGS = (
    SimpleNamespace(name="paddle_tpu", set_flags=paddle.set_flags,
                    serving=ref_serving, faults=ref_faults,
                    metrics=ref_metrics, recorder=ref_recorder),
    SimpleNamespace(name="paddle_tpu_torch", set_flags=pt.set_flags,
                    serving=port_serving, faults=port_faults,
                    metrics=port_metrics, recorder=port_recorder),
)

DEFAULT_FLAGS = {
    "FLAGS_serving_step_timeout": 60.0,
    "FLAGS_serving_max_queue": 256,
    "FLAGS_serving_admission_target_ms": 100.0,
    "FLAGS_serving_breaker_failures": 5,
    "FLAGS_serving_breaker_window": 30.0,
    "FLAGS_serving_breaker_cooldown": 10.0,
    "FLAGS_serving_hedge_budget": 0.05,
    "FLAGS_serving_hedge_min_ms": 10.0,
    "FLAGS_serving_retry_after": 0.1,
    "FLAGS_preflight_checks": True,
}


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakePredictor:
    """Doubles input[0]; optionally advances a clock per call (service
    time), runs a hook, and counts calls and distinct signatures (the
    stand-in for compiles)."""

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


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "artifacts"))
    for p in PKGS:
        p.faults.reset()
        p.metrics.reset_registry()
        p.set_flags(DEFAULT_FLAGS)
    yield
    for p in PKGS:
        p.faults.reset()
        p.metrics.reset_registry()
        p.set_flags(DEFAULT_FLAGS)


def both(scenario):
    ref, port = (scenario(p) for p in PKGS)
    assert port == ref
    return port


def x(rows=1, fill=1.0, width=3):
    return [np.full((rows, width), fill, "float32")]


def make_server(P, replicas=2, max_batch_size=8, clock=None, service_s=0.0,
                **kw):
    clock = clock or FakeClock()
    cfg = P.serving.ServingConfig(max_batch_size=max_batch_size,
                                  replicas=replicas, **kw)
    srv = P.serving.InferenceServer(
        lambda i: FakePredictor(clock=clock, service_s=service_s), cfg,
        clock=clock)
    return srv, clock


def reply(req):
    """A request's outcome: its result arrays (as lists) or error type."""
    if req.error is not None:
        return ("error", type(req.error).__name__)
    return ("ok", [np.asarray(r).tolist() for r in req.result])


def replicas(srv):
    return [{k: v for k, v in r.describe().items() if k != "last_error"}
            for r in srv.scheduler.replicas]


def observe(srv, reqs=()):
    """Everything a run can be compared on."""
    stats = srv.stats()
    stats["replicas"] = replicas(srv)
    return {"replies": [reply(r) for r in reqs], "stats": stats,
            "recorder": [e["status"] for e in srv.recorder.entries()]}


def pump_all(srv, limit=1000):
    rounds = 0
    while srv.pump(1):
        rounds += 1
        assert rounds < limit
    return rounds


def run_one(srv, **kw):
    req = srv.submit(x(), **kw)
    srv.pump_until_done(req)
    return req


# -- scenarios ----------------------------------------------------------------

def buckets_and_padding(P):
    b = P.serving.batcher
    sig = b.signature_of([np.zeros((4, 3, 2), "float32"),
                          np.zeros((4,), "int64")])
    padded = b.pad_rows([np.ones((3, 2), "float32")], 3, 4)[0]
    with pytest.raises(ValueError):
        b.signature_of([np.float32(1.0)])
    return {"pow2": [b.pow2_buckets(n) for n in (1, 5, 8)],
            "bucket_for": [b.bucket_for(r, [1, 2, 4, 8])
                           for r in (1, 3, 8, 9)],
            "sig": sig, "padded": padded.tolist()}


def queue_assembly(P):
    clock = FakeClock()
    q = P.serving.BatchQueue(8, clock=clock)
    Request = P.serving.Request
    reqs = [Request(x(1), now=clock()), Request(x(2, width=5), now=clock()),
            Request(x(3), now=clock()), Request(x(5), now=clock()),
            Request(x(1), deadline=0.5, now=clock())]
    for r in reqs:
        q.put(r)
    clock.advance(1.0)
    out = []
    while True:
        batch = q.assemble([1, 2, 4, 8], max_rows=8)
        if batch is None:
            break
        out.append((batch.rows, batch.bucket,
                    [reqs.index(r) for r in batch.requests]))
    return {"batches": out, "expired": reply(reqs[4])}


def end_to_end(P):
    srv, clock = make_server(P)
    reqs = [srv.submit(x(2, 5.0))]
    srv.pump(1)
    reqs.append(srv.submit(x(3)))
    clock.advance(0.5)
    srv.pump(1)
    [out] = srv.infer(x(1, 7.0))
    return {**observe(srv, reqs), "infer": out.tolist()}


def warmup_signatures(P):
    clock = FakeClock()
    cfg = P.serving.ServingConfig(max_batch_size=4, replicas=1,
                                  warmup_signatures=[(((3,), "float32"),)])
    srv = P.serving.InferenceServer(lambda i: FakePredictor(), cfg,
                                    clock=clock)
    warm = srv.stats()["compiles"]
    srv.infer(x(3))
    return {"warm": warm, **observe(srv)}


def bounded_compiles(P):
    buckets = [1, 2, 4, 8]
    srv, _ = make_server(P, replicas=2, max_batch_size=8, buckets=buckets,
                         max_queue=512)
    rng = np.random.RandomState(42)
    reqs = []
    for _ in range(60):
        rows = int(rng.randint(1, 9))
        reqs.append(srv.submit([rng.randn(rows, 3).astype("float32")]))
        if rng.random() < 0.5:
            srv.pump(1)
    pump_all(srv)
    seen = [sorted({s[0][0][0] for s in r.executor.predictor.signatures})
            for r in srv.scheduler.replicas]
    return {**observe(srv, reqs), "seen_rows": seen}


def queue_full(P):
    srv, _ = make_server(P, max_queue=4)
    for _ in range(4):
        srv.submit(x())
    with pytest.raises(P.serving.ServerOverloaded, match="queue full") as ei:
        srv.submit(x())
    return {"retry_after": ei.value.retry_after, **observe(srv)}


def reply_fault(P):
    srv, _ = make_server(P)
    P.faults.configure("serving.reply:#1")
    r = srv.submit(x())
    srv.pump(1)
    return observe(srv, [r])


def chaos_death_and_hang(P):
    clock = FakeClock()
    srv, _ = make_server(P, replicas=3, max_batch_size=4, clock=clock,
                         max_queue=64, max_retries=2)
    P.faults.configure("serving.replica_run:#2,serving.dispatch:#4")
    reqs = [srv.submit(x(1, 10 * k + i), deadline=clock() + 30.0)
            for k in range(4) for i in range(6)]
    pump_all(srv)
    return observe(srv, reqs)


def unretryable_dump(P):
    clock = FakeClock()
    srv, _ = make_server(P, replicas=2, max_batch_size=4, clock=clock,
                         max_retries=1)
    P.faults.configure("serving.dispatch:#1+")
    victim = srv.submit(x(2), deadline=clock() + 30.0)
    srv.pump(2)
    P.faults.reset()
    survivor = srv.submit(x(1), deadline=clock() + 30.0)
    srv.pump(2)
    path = P.recorder.dump_path_for_rank(0)
    with open(path) as f:
        dump = json.load(f)
    return {**observe(srv, [victim, survivor]),
            "dump_reason": dump["reason"].split("#")[0],
            "dump_requests": len(dump["failed_batch"]["requests"]),
            "dump_statuses": [e["status"] for e in dump["entries"]]}


def deadline_too_tight(P):
    clock = FakeClock()
    deaths = {"left": 1}

    class SlowDying(FakePredictor):
        def run(self, arrays):
            clock.advance(2.0)
            if deaths["left"] > 0:
                deaths["left"] -= 1
                raise P.serving.ReplicaDead("died mid-batch after 2s")
            return super().run(arrays)

    srv = P.serving.InferenceServer(
        lambda i: SlowDying(),
        P.serving.ServingConfig(max_batch_size=2, replicas=2, max_retries=3),
        clock=clock)
    tight = srv.submit(x(1, width=2), deadline=clock() + 1.0)
    loose = srv.submit(x(1), deadline=clock() + 60.0)
    pump_all(srv)
    return observe(srv, [tight, loose])


def all_replicas_dead(P):
    clock = FakeClock()
    state = {"dead": False, "factory_fails": False}

    class Dying(FakePredictor):
        def run(self, arrays):
            if state["dead"]:
                raise P.serving.ReplicaDead("device gone")
            return super().run(arrays)

    def factory(i):
        if state["factory_fails"]:
            raise RuntimeError("no devices left")
        return Dying()

    srv = P.serving.InferenceServer(
        factory, P.serving.ServingConfig(max_batch_size=2, replicas=2,
                                         max_retries=3), clock=clock)
    state["dead"] = state["factory_fails"] = True
    r = srv.submit(x(1, width=2))
    srv.pump(4)
    return observe(srv, [r])


def admission_trajectory(P):
    clock = FakeClock()
    ac = P.serving.AdmissionController(target_ms=100.0, initial=4,
                                       max_limit=64, clock=clock)
    limits = []
    for i in range(100):
        ac.observe(0.05 if i < 60 else 0.5, now=clock())
        clock.advance(0.05)
        limits.append(ac.limit)
    ac2 = P.serving.AdmissionController(target_ms=100.0, initial=8,
                                        max_limit=8, clock=FakeClock())
    verdicts = []
    for prio in (2, 2, 2, 2, 2, 0, 0, 0, 0, 0):
        try:
            ac2.admit(priority=prio)
            verdicts.append("ok")
        except P.serving.ServerOverloaded as e:
            verdicts.append(("shed", e.retry_after))
    ac2.note_done()
    return {"limits": limits, "verdicts": verdicts,
            "snapshot": ac2.snapshot()}


def breaker_cycle(P):
    br = P.serving.CircuitBreaker(failures=3, window=10.0, cooldown=5.0)
    log = [br.record_failure(t) for t in (0.0, 1.0, 20.0, 21.0, 22.0)]
    log.append((br.state, br.allows(), br.opens))
    log += [br.probe_due(t) for t in (26.0, 27.5)]
    log.append(br.state)
    log.append(br.record_failure(27.6))
    log += [br.probe_due(t) for t in (30.0, 32.6)]
    br.close(32.7)
    log.append((br.state, br.allows(), br.opens, br.describe()))
    return log


def make_wedgeable_server(P, cooldown=50.0):
    clock = FakeClock()
    wedged = {"on": False}

    class Wedgeable(FakePredictor):
        def run(self, arrays):
            if wedged["on"]:
                raise TimeoutError("device wedged (injected)")
            return super().run(arrays)

    def factory(i):
        cls = Wedgeable if i == 1 else FakePredictor
        return cls(clock=clock, service_s=0.001)

    cfg = P.serving.ServingConfig(max_batch_size=8, replicas=2, max_retries=1,
                                  warmup_signatures=[(((3,), "float32"),)])
    srv = P.serving.InferenceServer(factory, cfg, clock=clock)
    P.set_flags({"FLAGS_serving_breaker_failures": 2,
                 "FLAGS_serving_breaker_window": 1000.0,
                 "FLAGS_serving_breaker_cooldown": cooldown})
    return srv, clock, wedged


def breakers_through_the_server(P):
    """Wedge replica 1 until its breaker opens; probe it with a failing
    preflight, then a hanging canary, then a recovered device."""
    srv, clock, wedged = make_wedgeable_server(P, cooldown=5.0)
    sick = srv.scheduler.find_replica(1)
    wedged["on"] = True
    reqs, states = [], []
    for _ in range(10):
        if not sick.breaker.allows():
            break
        reqs.append(run_one(srv))
    states.append(sick.breaker.state)
    wedged["on"] = False
    P.faults.configure("integrity.preflight:#1")
    for wedge in (False, True, False):
        wedged["on"] = wedge
        clock.advance(6.0)
        srv.pump(1)
        states.append((sick.breaker.state, sick.breaker.opens,
                       sick.executor.predictor.calls))
    for _ in range(6):
        reqs.append(run_one(srv))
    return {**observe(srv, reqs), "states": states}


def hedge_delay(P):
    def sched(n, **kw):
        clock = FakeClock()
        kw.setdefault("preflight", lambda p: None)
        return P.serving.Scheduler(
            lambda i: FakePredictor(clock=clock, service_s=0.001), n,
            clock=clock, metrics=P.serving.ServingMetrics(clock), **kw)
    out = []
    for n, ms, kw in ((2, None, {}), (2, 40.0, {}), (2, 1.0, {}),
                      (2, 20.0, {"hedge_budget": 0.0}), (1, 20.0, {})):
        s = sched(n, **kw)
        for _ in range(20 if ms else 0):
            s.note_exec_latency(ms / 1e3)
        out.append(s.hedge_delay())
    s = sched(3)
    picks = [s.pick().idx for _ in range(30)]
    s.replicas[0].inflight = 2
    s.replicas[1].inflight = 2
    picks += [s.pick().idx for _ in range(5)]
    return {"delays": out, "picks": picks}


def hedged_hang(P):
    srv, clock = make_server(P, replicas=2, max_retries=1, hedge_budget=1.0)
    for _ in range(20):
        srv.scheduler.note_exec_latency(0.02)
    P.faults.configure("serving.hedge:#1")
    req = run_one(srv)
    return {**observe(srv, [req]),
            "breaker_failures": [r.breaker.describe()["recent_failures"]
                                 for r in srv.scheduler.replicas]}


def hedge_budget(P):
    srv, clock = make_server(P, replicas=2, max_retries=1, hedge_budget=0.05)
    for _ in range(20):
        srv.scheduler.note_exec_latency(0.02)
    P.faults.configure("serving.hedge:0.5")
    reqs = [run_one(srv) for _ in range(60)]
    return observe(srv, reqs)


def elastic_membership(P):
    kats = []
    clock = FakeClock()
    sched = P.serving.Scheduler(
        lambda i: FakePredictor(clock=clock, service_s=0.001), 1,
        clock=clock, metrics=P.serving.ServingMetrics(clock),
        preflight=kats.append)
    sched.warmup((((3,), "float32"),), (1, 2, 4))
    idx = sched.add_replica()
    sched.replicas[0].inflight = 1
    sched.begin_drain(0)
    with pytest.raises(RuntimeError, match="in flight"):
        sched.remove_replica(0)
    removed = sched.remove_replica(0, force=True) is not None
    return {"idx": idx, "kats": len(kats), "removed": removed,
            "compiles": sched.find_replica(1).executor.compile_count,
            "generation": sched.generation,
            "members": [r.idx for r in sched.replicas]}


def fenced_late_result(P):
    clock = FakeClock()
    cfg = P.serving.ServingConfig(max_batch_size=4, replicas=2,
                                  max_retries=1)
    state = {"armed": True}

    def factory(i):
        def on_run(pred):
            if state["armed"]:
                state["armed"] = False
                victim = next(r.idx for r in srv.scheduler.replicas
                              if r.inflight > 0)
                srv.scheduler.remove_replica(victim, force=True)
        return FakePredictor(clock=clock, service_s=0.001, on_run=on_run)

    srv = P.serving.InferenceServer(factory, cfg, clock=clock)
    req = run_one(srv)
    return {**observe(srv, [req]), "generation": srv.scheduler.generation}


def restart_rewarms(P):
    srv, clock = make_server(P, replicas=2, max_batch_size=4,
                             warmup_signatures=[(((3,), "float32"),)])
    P.faults.configure("serving.replica_run:#1")
    reqs = [run_one(srv)]
    for rows in (1, 2, 3, 4):
        r = srv.submit(x(rows))
        srv.pump_until_done(r)
        reqs.append(r)
    return observe(srv, reqs)


def shed_reasons(P):
    out = {}
    srv, clock = make_server(P, replicas=1, max_queue=4)
    for _ in range(4):
        srv.submit(x())
    with pytest.raises(P.serving.ServerOverloaded, match="queue full"):
        srv.submit(x())
    with pytest.raises(P.serving.ServerOverloaded, match="unmeetable"):
        srv.submit(x(), deadline=clock() - 1.0)
    out["queue"] = srv.metrics.snapshot()
    srv, clock = make_server(P, replicas=1, admission_initial=1,
                             admission_max=1)
    first = srv.submit(x())
    with pytest.raises(P.serving.ServerOverloaded, match="admission"):
        srv.submit(x())
    pump_all(srv)
    second = run_one(srv)
    out["admission"] = observe(srv, [first, second])
    reg = P.metrics.get_registry()
    out["registry"] = [reg.counter_value("serving.shed_total",
                                         labels={"reason": r})
                       for r in ("queue_full", "admission", "deadline")]
    return out


def overload_soak(P):
    """The reference's overload soak without its autoscaler (not ported):
    ~10x admission pressure with a replica death and a 5% dispatch-hang
    rate injected mid-soak."""
    P.set_flags({"FLAGS_serving_breaker_failures": 2,
                 "FLAGS_serving_breaker_window": 1000.0,
                 "FLAGS_serving_breaker_cooldown": 0.5})
    clock = FakeClock()
    service_s = 0.005
    cfg = P.serving.ServingConfig(max_batch_size=8, replicas=2, max_queue=64,
                                  default_deadline=2.0, max_retries=2,
                                  admission_target_ms=40.0)
    srv = P.serving.InferenceServer(
        lambda i: FakePredictor(clock=clock, service_s=service_s), cfg,
        clock=clock)
    srv.warmup((((3,), "float32"),))
    P.faults.configure("serving.replica_run:#40,serving.dispatch:0.05")
    rate = 2 * 8 / service_s * 10.0
    credit, accepted, sheds = 0.0, [], []
    while clock() < 1.5:
        credit += rate * 0.005
        while credit >= 1.0:
            credit -= 1.0
            try:
                accepted.append(srv.submit(x()))
            except P.serving.ServerOverloaded as e:
                sheds.append(e.retry_after)
        srv.pump(4)
        clock.advance(0.005)
    pump_all(srv, limit=20000)
    for _ in range(10):
        srv.pump(1)
        clock.advance(0.5)
    obs = observe(srv, accepted)
    assert obs["stats"]["breaker_opens"] >= 1 and sheds
    return {**obs, "sheds": sheds}


def real_predictor_pool(P):
    """A server over an inference.Config: the same Linear(4, 2) weights in
    both packages (the port on the host)."""
    rng = np.random.RandomState(0)
    w, b = rng.randn(4, 2).astype("float32"), rng.randn(2).astype("float32")
    if P.name == "paddle_tpu":
        layer = paddle.nn.Linear(4, 2)
        layer.weight.set_value(w)
        layer.bias.set_value(b)
        cfg = ref_infer.Config()
    else:
        layer = pt.nn.Linear(4, 2, device="cpu")
        pt.load_numpy_state_dict(layer, {"weight": w, "bias": b})
        cfg = port_infer.Config()
        cfg.disable_gpu()
    cfg.set_layer(layer)
    srv = P.serving.InferenceServer(
        cfg, P.serving.ServingConfig(max_batch_size=2, replicas=2),
        clock=FakeClock())
    outs = [srv.infer([rng.randn(1, 4).astype("float32")])[0]
            for _ in range(3)]
    return {"outs": np.concatenate(outs), "compiles": srv.stats()["compiles"]}


SCENARIOS = [
    buckets_and_padding, queue_assembly, end_to_end, warmup_signatures,
    bounded_compiles, queue_full, reply_fault, chaos_death_and_hang,
    unretryable_dump, deadline_too_tight, all_replicas_dead,
    admission_trajectory, breaker_cycle, breakers_through_the_server,
    hedge_delay, hedged_hang, hedge_budget, elastic_membership,
    fenced_late_result, restart_rewarms, shed_reasons, overload_soak,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_serving_scenario_matches_reference(scenario):
    both(scenario)


def test_server_over_a_predictor_matches_reference():
    ref, port = (real_predictor_pool(p) for p in PKGS)
    np.testing.assert_allclose(port["outs"], ref["outs"], rtol=1e-5,
                               atol=1e-6)
    assert port["compiles"] == ref["compiles"]


def test_chaos_retries_absorb_both_faults():
    """The reference's chaos acceptance, on the port: every request
    completes with its own doubled row, a replica died and restarted, and
    the recorder kept both failed attempts."""
    got = chaos_death_and_hang(PKGS[1])
    assert all(kind == "ok" for kind, _ in got["replies"])
    stats = got["stats"]
    assert stats["replica_deaths"] == 1 and stats["retries"] >= 2
    assert stats["replica_restarts"] >= 1
    assert {"ReplicaDead", "DistributedTimeout"} <= set(got["recorder"])


def test_not_ported_attachments_raise(tmp_path):
    """The attachments that raised until the autoscaler, the rollout and
    disagg were ported now attach, and the server ticks and reports each."""
    from paddle_tpu_torch.core import device as port_device
    from paddle_tpu_torch.serving.disagg import DisaggController
    srv, _ = make_server(PKGS[1])
    before = port_device._current
    pt.set_device("cpu")
    try:
        asc = srv.attach_autoscaler()
        rc = srv.attach_rollout(str(tmp_path / "root"), None)
        ctl = srv.attach_disagg()
    finally:
        port_device._current = before
    assert isinstance(asc, port_serving.Autoscaler)
    assert isinstance(rc, port_serving.RolloutController)
    assert isinstance(ctl, DisaggController)
    srv.pump(1)
    stats = srv.stats()
    assert {"autoscaler", "rollout", "disagg"} <= set(stats)
    assert stats["rollout"]["state"] == "IDLE" and not srv.rollout_active()


def test_threaded_server_serves_concurrent_clients():
    """A real-clock server started in threaded mode answers four client
    threads, each reply its own row doubled."""
    import threading
    srv = port_serving.InferenceServer(
        lambda i: FakePredictor(),
        port_serving.ServingConfig(max_batch_size=4, replicas=2,
                                   warmup_signatures=[(((3,), "float32"),)]))
    srv.start()
    results, lock = {}, threading.Lock()

    def client(k):
        for i in range(5):
            out = srv.infer(x(1, 10 * k + i), timeout=30.0)
            with lock:
                results[(k, i)] = float(out[0][0, 0])

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    srv.stop()
    assert not any(t.is_alive() for t in threads)
    assert results == {(k, i): 2.0 * (10 * k + i)
                       for k in range(4) for i in range(5)}
    assert srv.stats()["compiles"] == 2 * 3   # warm, no live captures
