"""The continuous-batching decode engine of the port against the reference.

Every scenario below runs twice, once through paddle_tpu (its decode step a
``jax.jit`` program on the host) and once through paddle_tpu_torch (its
decode step eager on CPU tensors, ``device="cpu"``), on the same fake
clock, prompts, seeds and fault specs. What each run observes — the token
streams, the typed errors, the KV pool's ``free()``/``used()``/
``refcounts()``, the engine's ``stats()`` (fake-clock TTFT and TPOT
included), the compile counts and the process-wide compile counters — must
be equal. The scenarios are the reference's own (tests/test_decode.py):
join refusals, completion and deadlines, replica-death replay after an
injected ``decode.step``/``decode.prefill`` fault, the chaos soaks, prefix
sharing (full and partial hits, copy-on-write, pool pressure, drain) and
speculative decoding (perfect, corrupted and faulted drafts, a verify
death). The KV pool's own operations are compared the same way, and the
server's ``attach_decode`` + ``submit_generate`` in pump mode.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as ref_serving
import paddle_tpu.serving.decode as ref_decode
from paddle_tpu.jit import compiled_step as ref_compiled_step
from paddle_tpu.profiler import metrics as ref_metrics
from paddle_tpu.resilience import faults as ref_faults

import paddle_tpu_torch as pt
import paddle_tpu_torch.serving as port_serving
import paddle_tpu_torch.serving.decode as port_decode
from paddle_tpu_torch.jit import compiled_step as port_compiled_step
from paddle_tpu_torch.profiler import metrics as port_metrics
from paddle_tpu_torch.resilience import faults as port_faults

torch.set_num_threads(1)


def _pkg(name, paddle_mod, serving, decode, faults, metrics, compiled_step,
         **backend_kw):
    return SimpleNamespace(
        name=name, set_flags=paddle_mod.set_flags, serving=serving,
        decode=decode, faults=faults, metrics=metrics,
        compiled_step=compiled_step,
        Backend=functools.partial(decode.CompiledDecodeBackend,
                                  **backend_kw))


PKGS = (
    _pkg("paddle_tpu", paddle, ref_serving, ref_decode, ref_faults,
         ref_metrics, ref_compiled_step),
    _pkg("paddle_tpu_torch", pt, port_serving, port_decode, port_faults,
         port_metrics, port_compiled_step, device="cpu"),
)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "artifacts"))
    for p in PKGS:
        p.faults.reset()
        p.metrics.reset_registry()
        p.compiled_step.reset_compile_stats()
    yield
    for p in PKGS:
        p.faults.reset()
        p.metrics.reset_registry()
        p.set_flags({"FLAGS_decode_quantize": ""})


def drive(engine, clock=None, dt=0.001, max_rounds=10000):
    """Step the engine until every stream has left, bounded."""
    rounds = 0
    while engine.running() and rounds < max_rounds:
        engine.step()
        if clock is not None:
            clock.advance(dt)
        rounds += 1
    assert rounds < max_rounds, "engine failed to drain"
    return rounds


def outcome(stream):
    """What a stream delivered: its tokens and its error's type."""
    return (list(stream.tokens), stream.done,
            type(stream.error).__name__ if stream.error else None)


def pool_state(eng):
    return {"free": eng.pool.free(), "used": eng.pool.used(),
            "refcounts": dict(eng.pool.refcounts()),
            "leaked": eng.kv_leaked()}


def engine(P, clock, backend=None, **cfg):
    backend = backend or P.Backend(max_running=cfg.get("max_running", 8))
    return P.decode.DecodeEngine(backend, P.decode.DecodeConfig(**cfg),
                                 clock=clock), backend


def both(scenario):
    ref, port = (scenario(p) for p in PKGS)
    assert port == ref
    return port


# -- scenarios (each returns what a run observes) ----------------------------

def join_cap_refusal(P):
    eng, _ = engine(P, FakeClock(), max_running=1, max_new_tokens=4)
    eng.join([1, 2, 3])
    with pytest.raises(P.serving.ServerOverloaded) as ei:
        eng.join([4, 5, 6])
    return {"retry_after": ei.value.retry_after, "pool": pool_state(eng)}


def kv_pool_refusal(P):
    eng, _ = engine(P, FakeClock(), max_running=4, num_blocks=2,
                    block_size=4, max_new_tokens=4)
    with pytest.raises(P.serving.ServerOverloaded) as ei:
        eng.join(list(range(20)))
    return {"retry_after": ei.value.retry_after, "pool": pool_state(eng),
            "running": eng.running()}


def admission_sheds_and_recovers(P):
    clock = FakeClock()
    adm = P.serving.AdmissionController(initial=1, min_limit=1, max_limit=1,
                                        clock=clock)
    eng = P.decode.DecodeEngine(
        P.Backend(max_running=4),
        P.decode.DecodeConfig(max_running=4, max_new_tokens=2),
        clock=clock, admission=adm)
    s = eng.join([1, 2], priority=0)
    with pytest.raises(P.serving.ServerOverloaded) as ei:
        eng.join([3, 4], priority=0)
    drive(eng, clock)
    again = eng.join([5, 6], priority=0)
    drive(eng, clock)
    return {"first": outcome(s), "again": outcome(again),
            "retry_after": ei.value.retry_after,
            "admission": adm.snapshot()}


def streams_complete(P):
    clock = FakeClock()
    eng, backend = engine(P, clock, max_running=4, max_new_tokens=6)
    streams = [eng.join([10 * k + j for j in range(3)]) for k in range(3)]
    drive(eng, clock)
    return {"streams": [outcome(s) for s in streams],
            "compiles": backend.step.compile_count,
            "buckets": list(backend.buckets), "pool": pool_state(eng),
            "stats": eng.stats(),
            "compile_stats": P.compiled_step.compile_stats(),
            "registry": {k: P.metrics.get_registry().counter_value(
                f"compiled_step.{k}_total")
                for k in ("compiles", "cache_hits")}}


def deadline_eviction(P):
    clock = FakeClock()
    eng, _ = engine(P, clock, max_running=2, max_new_tokens=1000)
    s = eng.join([1, 2, 3], timeout=0.5)
    eng.step()
    clock.advance(1.0)
    eng.step()
    return {"stream": outcome(s), "pool": pool_state(eng)}


def on_token_failure(P):
    clock = FakeClock()
    eng, _ = engine(P, clock, max_running=2, max_new_tokens=100)
    seen = []

    def flaky(stream, token, seq):
        seen.append(token)
        if seq == 2:
            raise ConnectionError("client hung up")

    s = eng.join([1, 2], on_token=flaky)
    drive(eng, clock)
    return {"stream": outcome(s), "seen": seen, "pool": pool_state(eng)}


def replay(spec):
    def run(P):
        clock = FakeClock()
        eng, _ = engine(P, clock, max_running=4, max_new_tokens=12,
                        prefill_chunk=4)
        streams = [eng.join([7, 3, 5]), eng.join(list(range(9)))]
        if spec:
            P.faults.configure(spec)
        drive(eng, clock)
        P.faults.reset()
        return {"streams": [outcome(s) for s in streams],
                "pool": pool_state(eng), "stats": eng.stats()}
    run.__name__ = f"replay[{spec}]"
    return run


def chaos_soak(P):
    clock = FakeClock()
    adm = P.serving.AdmissionController(initial=16, max_limit=16, clock=clock)
    backend = P.Backend(max_running=6)
    eng = P.decode.DecodeEngine(
        backend,
        P.decode.DecodeConfig(max_running=6, num_blocks=24, block_size=4,
                              prefill_chunk=8, max_new_tokens=16),
        clock=clock, admission=adm)
    P.faults.configure(
        "decode.step:0.03,decode.prefill:0.03,decode.evict:0.2", seed=7)
    rng = np.random.RandomState(42)
    accepted, refusals = [], []
    for _ in range(400):
        if rng.random() < 0.5:
            prompt = list(rng.randint(0, 1000, size=int(rng.randint(1, 60))))
            try:
                accepted.append(eng.join(
                    prompt, timeout=float(rng.uniform(0.05, 0.4)),
                    priority=int(rng.randint(0, 3))))
            except P.serving.ServerOverloaded as e:
                refusals.append(e.retry_after)
        eng.step()
        clock.advance(0.002)
    P.faults.reset()
    drive(eng, clock, dt=0.002)
    assert len(accepted) > 20 and refusals
    return {"streams": [outcome(s) for s in accepted],
            "refusals": refusals, "compiles": backend.step.compile_count,
            "pool": pool_state(eng), "stats": eng.stats()}


def long_prompt_split(P):
    """A 200-token prompt joining mid-run is prefilled 8 tokens a round:
    the watched stream's token times (service charged to the clock)."""
    clock = FakeClock()

    def service(kind, n):
        clock.advance(0.005 if kind == "decode" else n * 0.005 / 32)

    eng = P.decode.DecodeEngine(
        P.Backend(max_running=4, service=service),
        P.decode.DecodeConfig(max_running=4, prefill_chunk=8,
                              max_new_tokens=48), clock=clock)
    stamps = []
    watched = eng.join(list(range(8)),
                       on_token=lambda s, t, q: stamps.append(clock()))
    eng.join(list(range(4)))
    rounds = 0
    while eng.running():
        if rounds == 8:
            eng.join(list(range(200)), max_new_tokens=4)
        eng.step()
        rounds += 1
    return {"watched": outcome(watched), "stamps": stamps, "rounds": rounds}


PROMPT = list(range(100, 124))   # 3 aligned blocks of 8


def sharing_engine(P, sharing=True, **over):
    cfg = dict(max_running=4, num_blocks=64, block_size=8, prefill_chunk=8,
               max_new_tokens=6)
    cfg.update(over)
    clock = FakeClock()
    eng = P.decode.DecodeEngine(
        P.Backend(max_running=cfg["max_running"]),
        P.decode.DecodeConfig(prefix_sharing=sharing, **cfg), clock=clock)
    return eng, clock


def prefix_full_hit(P):
    cold, cold_clock = sharing_engine(P, sharing=False)
    ref = cold.join(list(PROMPT))
    drive(cold, cold_clock)
    eng, clock = sharing_engine(P)
    first = eng.join(list(PROMPT))
    drive(eng, clock)
    warm = eng.join(list(PROMPT))
    at_join = (list(warm.tokens), list(warm._fill))
    drive(eng, clock)
    return {"cold": outcome(ref), "first": outcome(first),
            "warm": outcome(warm), "warm_at_join": at_join,
            "stats": eng.stats(), "pool": pool_state(eng)}


def prefix_partial_hit(P):
    eng, clock = sharing_engine(P)
    a = eng.join(list(PROMPT) + [1, 2])
    drive(eng, clock)
    b = eng.join(list(PROMPT) + [3, 4, 5])
    at_join = (b._fill_pos, list(b._fill))
    drive(eng, clock)
    return {"a": outcome(a), "b": outcome(b), "b_at_join": at_join,
            "stats": eng.stats(), "pool": pool_state(eng)}


def prefix_cow(P):
    prompt = list(range(500, 520))   # 2 aligned blocks + a 4-token tail
    eng, clock = sharing_engine(P)
    first = eng.join(list(prompt))
    drive(eng, clock)
    warm = eng.join(list(prompt))
    drive(eng, clock)
    return {"first": outcome(first), "warm": outcome(warm),
            "stats": eng.stats(), "pool": pool_state(eng)}


def prefix_pool_pressure(P):
    eng, clock = sharing_engine(P, num_blocks=8, max_running=2)
    a = eng.join(list(range(200, 216)))
    drive(eng, clock)
    b = eng.join(list(range(300, 356)))
    drive(eng, clock)
    c = eng.join(list(range(200, 216)))
    drive(eng, clock)
    return {"streams": [outcome(s) for s in (a, b, c)],
            "stats": eng.stats(), "pool": pool_state(eng)}


def prefix_lookup_fault(P):
    eng, clock = sharing_engine(P)
    first = eng.join(list(PROMPT))
    drive(eng, clock)
    P.faults.configure("prefix.lookup:1", seed=3)
    warm = eng.join(list(PROMPT))
    cold_fill = len(warm._fill)
    drive(eng, clock)
    P.faults.reset()
    return {"first": outcome(first), "warm": outcome(warm),
            "cold_fill": cold_fill, "stats": eng.stats()}


def prefix_drain(P):
    eng, clock = sharing_engine(P)
    for sfx in ([1], [2], [3]):
        eng.join(list(PROMPT) + sfx)
    drive(eng, clock)
    before = pool_state(eng)
    entries = eng.stats()["prefix_entries"]
    eng.drain()
    return {"before": before, "entries": entries, "after": pool_state(eng)}


def spec(spec_k=0, draft=None, fault=None):
    def run(P):
        d = None if draft is None else \
            getattr(P.decode, draft[0])(**draft[1])
        clock = FakeClock()
        eng = P.decode.DecodeEngine(
            P.Backend(max_running=4),
            P.decode.DecodeConfig(max_running=4, max_new_tokens=12,
                                  prefill_chunk=8, spec_k=spec_k, draft=d),
            clock=clock)
        streams = [eng.join([7, 3, 5]), eng.join(list(range(9)))]
        if fault:
            P.faults.configure(fault, seed=11)
        rounds = drive(eng, clock)
        P.faults.reset()
        return {"streams": [outcome(s) for s in streams], "rounds": rounds,
                "stats": eng.stats()}
    run.__name__ = f"spec[k={spec_k},{draft and draft[0]},{fault}]"
    return run


def spec_prefix_soak(P):
    clock = FakeClock()
    backend = P.Backend(max_running=6)
    eng = P.decode.DecodeEngine(
        backend,
        P.decode.DecodeConfig(max_running=6, num_blocks=24, block_size=4,
                              prefill_chunk=8, max_new_tokens=12,
                              prefix_sharing=True, spec_k=2,
                              draft=P.decode.MirrorDraft(corrupt_every=4)),
        clock=clock)
    P.faults.configure(
        "decode.join:0.03,decode.step:0.03,decode.prefill:0.03,"
        "decode.evict:0.2,prefix.lookup:0.05,prefix.share:0.05,"
        "prefix.evict:0.2,spec.draft:0.05,spec.verify:0.02", seed=9)
    rng = np.random.RandomState(7)
    bases = [list(rng.randint(0, 1000, size=10)) for _ in range(3)]
    accepted, refusals, leaks = [], [], []
    for round_no in range(400):
        if rng.random() < 0.5:
            prompt = list(bases[int(rng.randint(0, 3))]) + list(
                rng.randint(0, 1000, size=int(rng.randint(1, 6))))
            try:
                accepted.append(eng.join(
                    prompt, timeout=float(rng.uniform(0.05, 0.4)),
                    priority=int(rng.randint(0, 3))))
            except P.serving.ServerOverloaded as e:
                refusals.append(e.retry_after)
        eng.step()
        clock.advance(0.002)
        if round_no % 97 == 0:
            leaks.append(eng.kv_leaked())
    P.faults.reset()
    drive(eng, clock, dt=0.002)
    stats = eng.stats()
    eng.drain()
    return {"streams": [outcome(s) for s in accepted],
            "refusals": refusals, "leaks": leaks, "stats": stats,
            "after_drain": pool_state(eng),
            "compiles": (backend.step.compile_count,
                         backend.vstep.compile_count)}


def server_generate(P):
    """attach_decode + submit_generate on a pump-mode server."""
    clock = FakeClock()

    class Null:
        def run(self, arrays):
            return [np.asarray(arrays[0])]

    srv = P.serving.InferenceServer(
        lambda i: Null(), P.serving.ServingConfig(max_batch_size=2),
        clock=clock)
    srv.attach_decode(P.Backend(max_running=4),
                      P.decode.DecodeConfig(max_new_tokens=6))
    streams = [srv.submit_generate(p) for p in
               ([1, 2, 3, 4, 5], [3, 1, 4], [1, 2, 3, 4, 5])]
    for _ in range(40):
        srv.pump(1)
        clock.advance(0.001)
    stats = srv.stats()["decode"]
    srv.stop()
    return {"streams": [outcome(s) for s in streams], "decode": stats}


SCENARIOS = [
    join_cap_refusal, kv_pool_refusal, admission_sheds_and_recovers,
    streams_complete, deadline_eviction, on_token_failure, replay(None),
    replay("decode.step:#5"), replay("decode.prefill:#2"),
    replay("decode.step:#3,decode.prefill:#6"), chaos_soak,
    long_prompt_split, prefix_full_hit, prefix_partial_hit, prefix_cow,
    prefix_pool_pressure, prefix_lookup_fault, prefix_drain,
    spec(), spec(4, ("MirrorDraft", {})),
    spec(4, ("MirrorDraft", {"corrupt_every": 3})),
    spec(4, ("MirrorDraft", {}), "spec.draft:1"),
    spec(4, ("MirrorDraft", {}), "spec.verify:#2"),
    spec(3, ("NGramDraft", {"n": 2})),
    spec_prefix_soak, server_generate,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_decode_scenario_matches_reference(scenario):
    both(scenario)


def test_replay_resumes_the_identical_continuation():
    """The replays match the fault-free run token for token (in the port
    as in the reference)."""
    clean = replay(None)(PKGS[1])["streams"]
    for spec_ in ("decode.step:#5", "decode.prefill:#2",
                  "decode.step:#3,decode.prefill:#6"):
        assert replay(spec_)(PKGS[1])["streams"] == clean


def test_speculation_is_token_identical_to_greedy():
    plain = spec()(PKGS[1])
    perfect = spec(4, ("MirrorDraft", {}))(PKGS[1])
    corrupt = spec(4, ("MirrorDraft", {"corrupt_every": 3}))(PKGS[1])
    assert perfect["streams"] == plain["streams"] == corrupt["streams"]
    assert perfect["stats"]["spec_accept_ratio"] == 1.0
    assert 0.0 < corrupt["stats"]["spec_accept_ratio"] < 1.0
    assert perfect["rounds"] < plain["rounds"]


def test_known_stream_and_pool_drain():
    """The verify skill's oracle: [1, 2, 3, 4, 5] streams exactly these six
    tokens at max_new_tokens=6, identical prompts stream identical tokens,
    and the pool returns to full."""
    got = server_generate(PKGS[1])
    tokens = [s[0] for s in got["streams"]]
    assert tokens[0] == tokens[2] == [30, 66, 139, 286, 581, 1172]
    assert got["decode"]["kv_blocks_free"] == 256


def pool_ops(P):
    """The KV pool and block-table operations of the reference's tests,
    each result recorded (errors by type and message head)."""
    KVBlockPool, BlockTable = P.decode.KVBlockPool, P.decode.BlockTable
    log = []

    def rec(fn):
        try:
            log.append(fn())
        except ValueError as e:
            log.append(("ValueError", str(e).split(":")[0]))

    pool = KVBlockPool(num_blocks=8, block_size=16)
    rec(lambda: [pool.blocks_for(n) for n in (0, 1, 16, 17)])
    pool = KVBlockPool(num_blocks=4, block_size=2)
    a = pool.try_allocate(2)
    held = pool.try_allocate(1)
    pool.release(a)
    rec(lambda: (a, pool.try_allocate(2), held, pool.free()))
    pool = KVBlockPool(num_blocks=2, block_size=4)
    got = pool.try_allocate(2)
    rec(lambda: (pool.try_allocate(1), pool.can_allocate(1), pool.free()))
    pool.release(got)
    rec(lambda: pool.release(got))
    rec(lambda: pool.release([99]))
    pool = KVBlockPool(num_blocks=4, block_size=2)
    big, small = BlockTable(pool), BlockTable(pool)
    rec(lambda: (big.ensure(6), small.ensure(4), pool.free(), small.blocks))
    big.release()
    big.release()
    rec(pool.free)
    pool = KVBlockPool(num_blocks=4, block_size=2)
    got = pool.try_allocate(2)
    pool.ref(got)
    pool.release(got)
    rec(lambda: (pool.free(), pool.refcounts()))
    free_block = next(b for b in range(4) if b not in got)
    rec(lambda: pool.ref([got[0], free_block]))
    pool.release(got)
    rec(lambda: pool.unref(got))
    pool = KVBlockPool(num_blocks=8, block_size=4)
    table = BlockTable(pool)
    rec(lambda: (table.ensure(16), table.truncate(9), pool.free(),
                 table.truncate(9), table.truncate(12)))
    tail = table.blocks[1]
    pool.ref([tail])
    rec(lambda: (table.ensure_writable(5), table.blocks, pool.refcounts()))
    pool.unref([tail])
    table.release()
    rec(lambda: (pool.used(), pool.refcounts()))
    pool = KVBlockPool(num_blocks=2, block_size=4)
    table = BlockTable(pool)
    table.ensure(8)
    pool.ref(list(table.blocks))
    rec(lambda: (table.ensure_writable(0), table.blocks))
    return log


def test_kv_pool_operations_match_reference():
    both(pool_ops)


def test_set_quantize_flag_raises():
    pt.set_flags({"FLAGS_decode_quantize": "int8"})
    with pytest.raises(NotImplementedError, match="A12"):
        port_decode.DecodeEngine(port_decode.CompiledDecodeBackend(
            device="cpu"))
