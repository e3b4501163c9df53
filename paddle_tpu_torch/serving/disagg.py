"""Disaggregated prefill/decode serving: per-class replicas, KV handoff
(port of paddle_tpu/serving/disagg.py).

Colocated continuous batching (serving/decode/engine.py) runs prefill and
decode on the same replica, so the two phases contend: prefill is
compute-bound (a long prompt chunk occupies the device for milliseconds),
decode is memory-bound (each tick is short but every running stream waits
on it). Under a bimodal prompt mix the chunked-prefill compromise still
taxes TPOT — every prefill chunk is a decode tick the running streams
didn't get. DistServe-style disaggregation splits the phases across
**replica classes**:

- **prefill class** — :class:`PrefillWorker` replicas under the existing
  :class:`~.scheduler.Scheduler` (health, breakers, restart-with-preflight,
  elastic membership all inherited). Each absorbs whole prompts into its
  own KV pool at full chunk rate; concurrent prompts run on different
  workers instead of time-slicing one engine.
- **decode class** — a fleet of :class:`~.decode.engine.DecodeEngine`
  instances that only ever decode: their prefill path is exercised solely
  by the *fallback* (below), so TPOT never pays for a stranger's prompt.

The seam between them is the two-phase KV handoff
(:mod:`~.decode.kv_migrate`): export → ack → adopt → release, journaled,
generation-fenced, and chaos-drivable at ``kv.{export,transfer,adopt}`` +
``disagg.route``. The robustness contract:

- a prefill-replica death mid-transfer raises the typed
  :class:`~.decode.kv_migrate.MigrationAborted`, fences + rebuilds the
  replica, and **falls back to decode-side re-prefill** via the engine's
  replay path — zero accepted streams lost;
- decode-side KV shortage refuses adoption with
  :class:`~.decode.kv_cache.KVCacheExhausted` + ``retry_after`` before a
  single page is claimed (the prefill copy survives until release);
- admission prices the two stages separately: prefill admission on the
  **TTFT** burn rate, decode adoption on the **TPOT** burn rate (the
  :class:`~.metrics.SLO` objects behind :class:`~.overload.BurnGate`), so
  one stage's pain sheds work for that stage only;
- each class autoscales on its own burn signal
  (:class:`~.autoscaler.Autoscaler` in fleet mode).

Everything runs on the injectable clock; the 400-round chaos soak drives
it with zero real sleeps. Each prefill worker and decode engine owns a
``CompiledDecodeBackend`` of its own, which on the card replays one CUDA
graph per (bucket, signature).
"""
from __future__ import annotations

import itertools
import threading
import time

from ..resilience.faults import maybe_inject
from ..resilience.recovery import RecoveryJournal
from .autoscaler import Autoscaler, AutoscalerConfig
from .batcher import DeadlineExceeded, ServerOverloaded
from .decode.compiled_decode import CompiledDecodeBackend
from .decode.engine import DecodeConfig, DecodeEngine
from .decode.kv_cache import BlockTable, KVBlockPool, KVCacheExhausted
from .decode.kv_migrate import KVMigrator, MigrationAborted
from .metrics import SLO, ServingMetrics, percentile
from .overload import BurnGate
from .scheduler import Scheduler

__all__ = ["DisaggConfig", "Handoff", "PrefillWorker", "DisaggController"]

_ids = itertools.count()


def _flag(name, default):
    from ..framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


class DisaggConfig:
    """Controller knobs. ``None`` reads the FLAGS_disagg_* / FLAGS_decode_*
    defaults. ``prefill_token_s`` is the modeled prefill service time per
    prompt token — on the fake clock it is the worker's *latency* (its
    ``busy_until`` advances), never a stall of the shared decode tick."""

    def __init__(self, prefill_replicas=2, decode_replicas=2,
                 max_prefill_replicas=4, max_decode_replicas=4,
                 prefill_blocks=None, decode_blocks=None, block_size=None,
                 max_running=8, prefill_chunk=None, max_new_tokens=None,
                 eos_token=None, prefill_token_s=0.0, ttft_target_ms=500.0,
                 tpot_target_ms=100.0, burn_window=None, burn_high=None,
                 max_inflight=None, retry_after=0.05, vocab=50257):
        self.prefill_replicas = int(prefill_replicas)
        self.decode_replicas = int(decode_replicas)
        self.max_prefill_replicas = int(max_prefill_replicas)
        self.max_decode_replicas = int(max_decode_replicas)
        if self.prefill_replicas < 1 or self.decode_replicas < 1:
            raise ValueError("need >= 1 replica per class")
        self.prefill_blocks = prefill_blocks
        self.decode_blocks = decode_blocks
        self.block_size = block_size
        self.max_running = int(max_running)
        self.prefill_chunk = int(
            prefill_chunk if prefill_chunk is not None
            else _flag("FLAGS_decode_prefill_chunk", 64))
        self.max_new_tokens = max_new_tokens
        self.eos_token = eos_token
        self.prefill_token_s = float(prefill_token_s)
        self.ttft_target_ms = float(ttft_target_ms)
        self.tpot_target_ms = float(tpot_target_ms)
        self.burn_window = burn_window
        self.burn_high = burn_high
        self.max_inflight = int(
            max_inflight if max_inflight is not None
            else _flag("FLAGS_disagg_max_inflight", 8))
        self.retry_after = float(retry_after)
        self.vocab = int(vocab)


class Handoff:
    """One disaggregated request's lifecycle object — what :meth:`
    DisaggController.submit` returns. Before adoption it carries the
    prefill-side artifacts the migrator ships (``table``, ``state``,
    ``fill_pos``, the first ``tokens``); after adoption it fronts the
    decode-side :class:`~.decode.engine.DecodeStream`. ``done`` / ``error``
    / ``tokens`` / ``wait()`` present the same surface either way, so the
    bench and tests treat colocated and disaggregated streams uniformly.
    """

    def __init__(self, prompt, max_new_tokens, deadline, priority,
                 enqueued_at, on_token=None, request_id=None):
        self.id = request_id if request_id is not None \
            else f"disagg-{next(_ids)}"
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline
        self.priority = int(priority)
        self.enqueued_at = enqueued_at
        self.on_token = on_token
        self.trace = None
        # prefill-side artifacts (set by PrefillWorker.prefill)
        self.table = None        # prefill-side BlockTable
        self.state = None        # backend KV snapshot (wire-codec-safe)
        self.fill_pos = 0
        self.tokens_prefilled = []   # tokens the prefill side produced
        self.done_at = None      # when the prefill service completes
        self.replica_idx = None
        self.fallback = False    # True when replayed decode-side
        # decode-side stream (set on adoption / fallback join)
        self._stream = None
        self._error = None
        self._done = False
        self._remaining = len(self.prompt)   # backend prefill cursor
        self._done_evt = threading.Event()
        # set when the request leaves the prefill side: adopted, joined by
        # the fallback, or terminated (what wait() blocks on first)
        self._staged = threading.Event()

    @property
    def stream(self):
        return self._stream

    @stream.setter
    def stream(self, stream):
        self._stream = stream
        self._staged.set()

    # migrator protocol: the exported tokens ride the kv_meta frame
    @property
    def tokens(self):
        if self.stream is not None:
            return self.stream.tokens
        return list(self.tokens_prefilled)

    @property
    def done(self):
        if self.stream is not None:
            return self.stream.done
        return self._done

    @property
    def error(self):
        if self.stream is not None:
            return self.stream.error
        return self._error

    def remaining_fill(self):
        """Prompt tokens the prefill backend has not absorbed yet (the
        backend emits the first token when this reaches zero)."""
        return self._remaining

    def wait(self, timeout=None):
        """Block until the request terminates. True iff it did in time.

        A wait that starts before adoption follows the request onto its
        decode stream (ROADMAP C-ref-30: the reference's waits on the
        prefill-side event alone, which adoption never sets, and so runs
        to its timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        if not self._staged.wait(timeout):
            return False
        if self.stream is None:
            return self._done_evt.is_set()
        left = None if deadline is None else \
            max(0.0, deadline - time.monotonic())
        return self.stream.wait(left)

    def describe(self):
        return {"id": self.id, "prompt_len": len(self.prompt),
                "tokens": len(self.tokens), "done": self.done,
                "fallback": self.fallback, "replica": self.replica_idx,
                "error": type(self.error).__name__ if self.error else None}


class PrefillWorker:
    """One prefill-class replica: its own backend + KV pool, absorbing
    whole prompts at full chunk rate. Lives under the Scheduler as the
    replica's "predictor", so death/restart/breaker plumbing is inherited
    — a restarted worker is simply a fresh instance from the factory.

    The fake-clock cost model: a prompt's prefill *occupies this worker*
    for ``len(prompt) × prefill_token_s`` (``busy_until`` advances, serial
    per worker, concurrent across workers) — it never advances the shared
    clock, which is exactly the disaggregation win the bench measures.
    """

    def __init__(self, idx, config, clock=None):
        self.idx = idx
        self.config = config
        self._clock = clock or time.monotonic
        self.backend = CompiledDecodeBackend(vocab=config.vocab)
        self.pool = KVBlockPool(num_blocks=config.prefill_blocks,
                                block_size=config.block_size)
        self.busy_until = 0.0
        self.prefills = 0

    def prefill(self, handoff):
        """Absorb the whole prompt into a fresh KV row and stage the
        handoff's export artifacts. Claims prefill-side pages atomically or
        not at all — shortage refuses typed with ``retry_after`` and
        nothing held."""
        now = self._clock()
        table = BlockTable(self.pool)
        if not table.ensure(len(handoff.prompt) + 1):
            raise KVCacheExhausted(
                f"{handoff.id}: prefill-side KV pool exhausted "
                f"({self.pool.free()} free blocks, prompt needs "
                f"{self.pool.blocks_for(len(handoff.prompt) + 1)})",
                retry_after=self.config.retry_after)
        handoff.table = table
        handoff.replica_idx = self.idx
        t0 = self._clock()
        pos = 0
        first = None
        chunk = self.config.prefill_chunk
        while pos < len(handoff.prompt):
            tokens = handoff.prompt[pos:pos + chunk]
            handoff._remaining -= len(tokens)
            tok = self.backend.prefill_chunk(handoff, tokens, pos)
            pos += len(tokens)
            if tok is not None:
                first = tok
        handoff.fill_pos = pos
        handoff.state = self.backend.export_state(handoff)
        self.backend.release(handoff)   # the snapshot is the copy now
        handoff.tokens_prefilled = [int(first)] if first is not None else []
        if handoff.trace is not None:
            handoff.trace.record_span("engine.prefill_chunk", t0,
                                      self._clock(),
                                      tokens=len(handoff.prompt), start=0)
        start = max(now, self.busy_until)
        self.busy_until = start + \
            len(handoff.prompt) * self.config.prefill_token_s
        handoff.done_at = self.busy_until
        self.prefills += 1
        return handoff


class _PrefillFleet:
    """Fleet protocol (count/grow/shrink) over the prefill Scheduler, for
    the burn-rate Autoscaler. ``shrink`` only retires an idle worker —
    pending handoffs pin their replica."""

    def __init__(self, scheduler, controller):
        self.scheduler = scheduler
        self._controller = controller

    def count(self):
        return len([r for r in self.scheduler.replicas
                    if r.healthy and not r.draining])

    def grow(self):
        return self.scheduler.add_replica()

    def shrink(self):
        busy = self._controller._pinned_replicas()
        victims = [r for r in self.scheduler.replicas
                   if r.healthy and not r.draining and r.idx not in busy]
        if not victims:
            return None
        victim = max(victims, key=lambda r: r.idx)
        self.scheduler.begin_drain(victim.idx)
        self.scheduler.remove_replica(victim.idx)
        return victim.idx


class _DecodeFleet:
    """Fleet protocol over the decode-engine list. ``shrink`` only retires
    an engine with no running streams (decode streams can't migrate twice)."""

    def __init__(self, controller):
        self._controller = controller

    def count(self):
        return len(self._controller._engines)

    def grow(self):
        return self._controller._add_engine()

    def shrink(self):
        return self._controller._remove_idle_engine()


class DisaggController:
    """Routes requests through the prefill class, migrates their KV to the
    decode class, and keeps both fleets healthy and right-sized. Drive it
    by calling :meth:`step` (the server pump does; tests use a fake clock).
    """

    def __init__(self, config=None, clock=None, journal=None, metrics=None,
                 job_id="disagg", journal_dir=None):
        self.config = config or DisaggConfig()
        self._clock = clock or time.monotonic
        self.metrics = metrics or ServingMetrics(clock=self._clock)
        self.journal = journal or RecoveryJournal(
            job_id=job_id, dir=journal_dir, clock=self._clock)
        self.migrator = KVMigrator(journal=self.journal, clock=self._clock)
        # per-stage SLOs: prefill admission prices TTFT burn, decode-side
        # adoption prices TPOT burn — separately, per the tentpole contract
        self.ttft_slo = self.metrics.add_slo(SLO(
            "disagg_ttft", "decode.ttft_ms", self.config.ttft_target_ms))
        self.tpot_slo = self.metrics.add_slo(SLO(
            "disagg_tpot", "decode.tpot_ms", self.config.tpot_target_ms))
        self.prefill_gate = BurnGate(
            self.ttft_slo, high=self.config.burn_high,
            window=self.config.burn_window,
            retry_after_base=self.config.retry_after, clock=self._clock)
        self.decode_gate = BurnGate(
            self.tpot_slo, high=self.config.burn_high,
            window=self.config.burn_window,
            retry_after_base=self.config.retry_after, clock=self._clock)
        # prefill class: PrefillWorkers as Scheduler "predictors" — death,
        # breakers, restart and elastic membership come for free. Preflight
        # is a cheap liveness poke (no device KAT applies to a worker).
        self.scheduler = Scheduler(
            self._worker_factory, self.config.prefill_replicas,
            clock=self._clock, metrics=self.metrics,
            preflight=lambda worker: worker.pool.free())
        self._engines = []
        self._lock = threading.RLock()
        self._pending = []   # guarded-by: _lock (handoffs awaiting done_at)
        self._migrations = 0         # guarded-by: _lock
        self._aborts = 0             # guarded-by: _lock
        self._fallbacks = 0          # guarded-by: _lock
        self._route_failures = 0     # guarded-by: _lock
        self._refusals = 0           # guarded-by: _lock
        self._completed_ok = 0       # guarded-by: _lock
        for _ in range(self.config.decode_replicas):
            self._add_engine()
        self._prefill_fleet = _PrefillFleet(self.scheduler, self)
        self._decode_fleet = _DecodeFleet(self)
        scaler_cfg = dict(up_stable=2, down_stable=8, low_watermark=0.1)
        self.prefill_scaler = Autoscaler(
            fleet=self._prefill_fleet, slo=self.ttft_slo,
            burn_window=self.config.burn_window,
            config=AutoscalerConfig(
                min_replicas=self.config.prefill_replicas,
                max_replicas=self.config.max_prefill_replicas,
                high_watermark=1.0, **scaler_cfg),
            clock=self._clock, journal=self.journal, metrics=self.metrics,
            name="prefill")
        self.decode_scaler = Autoscaler(
            fleet=self._decode_fleet, slo=self.tpot_slo,
            burn_window=self.config.burn_window,
            config=AutoscalerConfig(
                min_replicas=self.config.decode_replicas,
                max_replicas=self.config.max_decode_replicas,
                high_watermark=1.0, **scaler_cfg),
            clock=self._clock, journal=self.journal, metrics=self.metrics,
            name="decode")
        from ..profiler.metrics import get_registry
        get_registry().register_gauge_fn(
            "disagg.handoffs_inflight_count", lambda: self.pending())

    # -- fleet plumbing ------------------------------------------------------
    def _worker_factory(self, idx):
        return PrefillWorker(idx, self.config, clock=self._clock)

    def _new_engine(self):
        cfg = DecodeConfig(max_running=self.config.max_running,
                           num_blocks=self.config.decode_blocks,
                           block_size=self.config.block_size,
                           prefill_chunk=self.config.prefill_chunk,
                           max_new_tokens=self.config.max_new_tokens,
                           eos_token=self.config.eos_token)
        return DecodeEngine(CompiledDecodeBackend(vocab=self.config.vocab),
                            config=cfg, clock=self._clock)

    def _add_engine(self):
        with self._lock:
            self._engines.append(self._new_engine())
            return len(self._engines) - 1

    def _remove_idle_engine(self):
        with self._lock:
            for i in range(len(self._engines) - 1, -1, -1):
                if self._engines[i].running() == 0:
                    self._engines.pop(i)
                    return i
            return None

    def _pinned_replicas(self):
        """Prefill replica indices with a handoff still pending on them —
        their exported-but-unreleased pages pin the worker."""
        with self._lock:
            return {h.replica_idx for h in self._pending
                    if h.replica_idx is not None}

    def _pick_engine(self):  # requires-lock: _lock
        """Least-loaded decode engine; a full fleet's typed refusal at
        adoption is the backpressure signal."""
        return min(self._engines, key=lambda e: e.running())

    # -- admission + routing -------------------------------------------------
    def submit(self, prompt, max_new_tokens=None, timeout=None, priority=1,
               on_token=None, request_id=None):
        """Admit one request into the prefill class. Refusals are typed
        (``ServerOverloaded`` / ``KVCacheExhausted``), carry ``retry_after``,
        and hold nothing. Returns the :class:`Handoff`."""
        from ..profiler.metrics import get_registry
        from ..profiler.tracing import get_tracer
        tracer = get_tracer()
        now = self._clock()
        h = Handoff(prompt,
                    max_new_tokens if max_new_tokens is not None
                    else self.config.max_new_tokens,
                    deadline=(now + timeout) if timeout else None,
                    priority=priority, enqueued_at=now, on_token=on_token,
                    request_id=request_id)
        h.trace = tracer.start(request_id=h.id, priority=int(priority),
                               kind="disagg")
        get_registry().inc_counter("disagg.submitted_total")
        try:
            with self._lock:
                # stage 1 pricing: TTFT burn rate gates prefill admission
                self.prefill_gate.admit(priority, now=now)
                if len(self._pending) >= self.config.max_inflight:
                    raise ServerOverloaded(
                        f"disagg handoff pipeline full "
                        f"({self.config.max_inflight} in flight)",
                        retry_after=self.config.retry_after)
                worker = self.route(h)
                worker.prefill(h)
                self._pending.append(h)
            return h
        except (ServerOverloaded, KVCacheExhausted) as e:
            self._refuse(h, e)
            raise
        except ConnectionError as e:
            # injected disagg.route failure: the router itself is sick —
            # surface as a typed, retryable refusal, nothing claimed
            with self._lock:
                self._route_failures += 1
            get_registry().inc_counter("disagg.route_failures_total")
            err = ServerOverloaded(f"disagg route failed: {e}",
                                   retry_after=self.config.retry_after)
            self._refuse(h, err)
            raise err from e

    def route(self, handoff):  # requires-lock: _lock
        """Place the handoff on the least-loaded placeable prefill replica
        (scheduler health/breaker rules apply). Carries the ``disagg.route``
        chaos site; no placeable replica raises typed ``ServerOverloaded``."""
        t0 = self._clock()
        maybe_inject("disagg.route", ConnectionError)
        rep = self.scheduler.pick()
        worker = rep.executor.predictor
        if handoff.trace is not None:
            handoff.trace.record_span("disagg.route", t0, self._clock(),
                                      replica=rep.idx,
                                      pending=len(self._pending))
        return worker

    def _refuse(self, h, error):
        """Terminate a never-admitted handoff typed. Holds nothing: the
        prefill table (if any was claimed before the failure) is released."""
        from ..profiler.metrics import get_registry
        from ..profiler.tracing import get_tracer
        if h.table is not None:
            h.table.release()
        with self._lock:
            self._refusals += 1
        get_registry().inc_counter("disagg.sheds_total")
        self.metrics.inc("shed", reason="admission")
        h._error = error
        h._done = True
        get_tracer().finish(h.trace, status="shed", error=error)
        h._done_evt.set()
        h._staged.set()

    def _terminate(self, h, error, status):  # requires-lock: _lock
        from ..profiler.metrics import get_registry
        from ..profiler.tracing import get_tracer
        if h.table is not None:
            h.table.release()
        h._error = error
        h._done = True
        get_registry().inc_counter(
            "disagg.handoffs_failed_total",
            labels={"reason": type(error).__name__})
        get_tracer().finish(h.trace, status=status, error=error)
        h._done_evt.set()
        h._staged.set()

    # -- the control tick ----------------------------------------------------
    def step(self, now=None):
        """One controller round: complete due handoffs (migrate → adopt),
        expire stale ones, tick every decode engine, heal the prefill
        fleet, sample SLOs, autoscale. Returns tokens emitted."""
        now = self._clock() if now is None else now
        with self._lock:
            for h in [p for p in self._pending
                      if p.deadline is not None and now > p.deadline]:
                self._pending.remove(h)
                self._terminate(h, DeadlineExceeded(
                    f"{h.id}: deadline exceeded before adoption"),
                    status="deadline")
            for h in [p for p in self._pending if p.done_at <= now]:
                self._pending.remove(h)
                self._complete(h, now)
        emitted = 0
        for eng in list(self._engines):
            emitted += eng.step()
        self.scheduler.maintain()
        self.metrics.slo_tick(now=now)
        self.prefill_scaler.tick(now=now)
        self.decode_scaler.tick(now=now)
        return emitted

    def _complete(self, h, now):  # requires-lock: _lock
        """The prefill service finished: price the decode stage, migrate,
        adopt. Failure edges per the tentpole contract — typed refusal on
        decode shortage, fenced fallback re-prefill on infrastructure
        death, zero streams lost either way."""
        from ..profiler.metrics import get_registry
        eng = self._pick_engine()
        try:
            # stage 2 pricing: TPOT burn rate gates decode-side adoption
            self.decode_gate.admit(h.priority, now=now)
            h.stream = self.migrator.migrate(
                h, eng, generation=self.scheduler.generation)
            self._migrations += 1
            get_registry().inc_counter("disagg.migrations_total")
            return
        except (ServerOverloaded, KVCacheExhausted) as e:
            # policy refusal: typed, retry_after attached, decode side
            # claimed nothing; the prefill copy is released with the stream
            self._refusals += 1
            get_registry().inc_counter("disagg.sheds_total")
            self._terminate(h, e, status="shed")
            return
        except MigrationAborted as e:
            self._aborts += 1
            get_registry().inc_counter("disagg.migration_aborts_total")
            if e.phase in ("export", "transfer") and \
                    h.replica_idx is not None:
                # the prefill replica is implicated: fence it out of
                # placement; restart_dead rebuilds it on a later tick
                self.scheduler.mark_dead(h.replica_idx, e)
            if h.table is not None:
                h.table.release()   # pages die with the replica
            h.fallback = True
        # fallback: decode-side re-prefill — the engine's replay path. The
        # deterministic backend re-derives the identical continuation from
        # the prompt, so the client sees the same tokens it would have.
        try:
            remaining = None
            if h.deadline is not None:
                remaining = max(h.deadline - now, 1e-9)
            h.stream = eng.join(
                h.prompt, max_new_tokens=h.max_new_tokens,
                timeout=remaining, priority=h.priority,
                on_token=h.on_token, request_id=h.id, trace=h.trace)
            self._fallbacks += 1
            get_registry().inc_counter("disagg.fallback_prefills_total")
        except (ServerOverloaded, KVCacheExhausted) as e:
            self._refusals += 1
            get_registry().inc_counter("disagg.sheds_total")
            self._terminate(h, e, status="shed")

    # -- lifecycle / observability -------------------------------------------
    def drain(self, error=None):
        """Terminate every pending handoff and live decode stream (server
        shutdown). Returns the number of requests terminated."""
        err = error if error is not None \
            else ServerOverloaded("disagg controller drained")
        n = 0
        with self._lock:
            for h in list(self._pending):
                self._pending.remove(h)
                self._terminate(h, err, status="shed")
                n += 1
        for eng in list(self._engines):
            n += eng.drain(error=err)
        return n

    def pending(self):
        with self._lock:
            return len(self._pending)

    def running(self):
        return sum(eng.running() for eng in list(self._engines))

    def stats(self):
        with self._lock:
            snap = {
                "pending_handoffs": len(self._pending),
                "migrations": self._migrations,
                "migration_aborts": self._aborts,
                "fallback_prefills": self._fallbacks,
                "route_failures": self._route_failures,
                "refusals": self._refusals,
                "decode_engines": len(self._engines),
            }
        snap["prefill_replicas"] = self._prefill_fleet.count()
        snap["running"] = self.running()
        ttft, tpot = [], []
        kv_used = kv_free = 0
        for eng in list(self._engines):
            es = eng.stats()
            kv_used += es["kv_blocks_used"]
            kv_free += es["kv_blocks_free"]
            t1, t2 = eng.latency_reservoirs()
            ttft.extend(t1)
            tpot.extend(t2)
        snap["decode_kv_blocks_used"] = kv_used
        snap["decode_kv_blocks_free"] = kv_free
        snap["ttft_p50_ms"] = percentile(ttft, 50)
        snap["ttft_p99_ms"] = percentile(ttft, 99)
        snap["tpot_p50_ms"] = percentile(tpot, 50)
        snap["tpot_p99_ms"] = percentile(tpot, 99)
        snap["prefill_gate"] = self.prefill_gate.snapshot()
        snap["decode_gate"] = self.decode_gate.snapshot()
        snap["prefill_scaler"] = self.prefill_scaler.describe()
        snap["decode_scaler"] = self.decode_scaler.describe()
        return snap

    def leaked_blocks(self):
        """Blocks still claimed anywhere with no live owner — the chaos
        soak's zero-leak assertion. With every stream terminated, every
        pool (prefill workers' and decode engines') must be all-free."""
        leaked = 0
        for rep in list(self.scheduler.replicas):
            worker = rep.executor.predictor
            leaked += worker.pool.used()
        with self._lock:
            engines = list(self._engines)
        for eng in engines:
            if eng.running() == 0:
                leaked += eng.pool.used()
        return leaked
