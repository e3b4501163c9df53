"""In-process inference server (port of paddle_tpu/serving/server.py).

:class:`InferenceServer` ties the layer together: a bounded
:class:`~.batcher.BatchQueue` feeds a batching loop that assembles
shape-bucketed batches and hands them to the :class:`~.scheduler.Scheduler`
for least-loaded multi-replica dispatch. Two execution modes share one code
path:

- **threaded** (``server.start()``): a daemon worker drains the queue
  continuously — the production shape;
- **pump** (``server.pump()``): one batching round runs synchronously on the
  caller's thread — the chaos suite drives the whole failure matrix this way
  with a fake clock and zero real sleeps.

Resilience integration:

- fault-injection sites on the three serving entry points — ``submit``
  (serving.enqueue, inside BatchQueue.put), ``dispatch`` (serving.dispatch /
  serving.replica_run, inside Scheduler), ``reply`` (serving.reply, in
  :meth:`InferenceServer._reply`);
- every batch executes inside a watchdog section deadlined by
  ``FLAGS_serving_step_timeout``;
- backpressure: ``ServerOverloaded`` at admission when the queue is full or
  a deadline is unmeetable — shed, never block;
- a per-server **request flight recorder** (the resilience ring, op =
  "serving.batch") records every batch with its request ids; on a batch
  failure or a server crash the ring is dumped to the artifacts dir naming
  the failed batch.

Each batch runs under a ``torch.profiler.record_function`` range named
``serving.batch.bucket<N>`` (the reference's ``RecordEvent``). Not ported
yet (ROADMAP A12): the socket frontend (``SocketFrontend`` over
``distributed/wire.py``), and the autoscaler, live rollout and
disaggregated prefill/decode, whose ``attach_*`` methods raise
``NotImplementedError``.
"""
from __future__ import annotations

import threading

import torch

from ..framework.errors import FatalError, PreconditionNotMetError
from ..profiler.tracing import get_tracer
from ..resilience.faults import maybe_inject
from ..resilience.recorder import FlightRecorder
from ..resilience.watchdog import DistributedTimeout
from .batcher import (
    BatchQueue, DeadlineExceeded, Request, ServerOverloaded, pow2_buckets,
)
from .metrics import SLO, ServingMetrics
from .overload import AdmissionController
from .scheduler import ReplicaDead, Scheduler

__all__ = ["ServingConfig", "InferenceServer", "ServerOverloaded",
           "DeadlineExceeded"]


def _flag(name, default):
    from ..framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


class ServingConfig:
    """Knobs for one server. Defaults come from FLAGS where a flag exists so
    deployments can retune a live binary with ``paddle.set_flags``."""

    def __init__(self, max_batch_size=8, buckets=None, max_queue=None,
                 replicas=1, default_deadline=None, batch_wait=0.01,
                 step_timeout=None, max_retries=1, max_cached_executables=32,
                 warmup_signatures=(), recorder_size=256,
                 admission_target_ms=None, admission_initial=None,
                 admission_max=None, hedge_budget=None):
        self.max_batch_size = int(max_batch_size)
        self.buckets = sorted(buckets) if buckets else \
            pow2_buckets(max_batch_size)
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1: {self.buckets}")
        self.max_queue = int(max_queue if max_queue is not None
                             else _flag("FLAGS_serving_max_queue", 256))
        self.replicas = int(replicas)
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1: {self.replicas}")
        # seconds a request may live end-to-end when the client sent no
        # explicit deadline; None = no deadline
        self.default_deadline = default_deadline
        # how long the threaded loop waits for more requests before
        # dispatching a partial batch (the classic batching knob)
        self.batch_wait = float(batch_wait)
        self.step_timeout = step_timeout   # None -> FLAGS_serving_step_timeout
        self.max_retries = int(max_retries)
        self.max_cached_executables = int(max_cached_executables)
        # [(signature, ...)] per-row signatures to pre-compile at start
        self.warmup_signatures = list(warmup_signatures)
        self.recorder_size = int(recorder_size)
        # AIMD admission knobs (None -> FLAGS_serving_admission_target_ms /
        # derived from max_queue). The limit counts requests *in the
        # system*; it starts at (and is capped by) 2x the queue bound so a
        # freshly started server sheds on queue-full, not admission, until
        # latency evidence says otherwise.
        self.admission_target_ms = admission_target_ms
        self.admission_initial = admission_initial
        self.admission_max = admission_max
        # hedge budget override (None -> FLAGS_serving_hedge_budget)
        self.hedge_budget = hedge_budget


class InferenceServer:
    """Dynamic-batching, multi-replica server over ``inference.Predictor``.

    ``predictor_or_config`` is an ``inference.Config`` (replicas come from a
    ``PredictorPool``) or a ``predictor_factory(idx)`` callable (tests,
    custom runtimes). ``clock=None`` uses real time and allows a worker
    thread; an injected clock forces pump mode (deterministic tests).
    """

    def __init__(self, predictor_or_config, config=None, clock=None):
        self.config = config or ServingConfig()
        self._clock = clock
        self.metrics = ServingMetrics(clock=clock)
        factory = self._make_factory(predictor_or_config)
        admission_cap = self.config.admission_max or \
            2 * self.config.max_queue
        self.admission = AdmissionController(
            target_ms=self.config.admission_target_ms,
            initial=self.config.admission_initial or admission_cap,
            max_limit=admission_cap, metrics=self.metrics, clock=clock)
        self.queue = BatchQueue(
            self.config.max_queue, clock=clock, metrics=self.metrics,
            retry_after_hint=lambda reason: self.admission.retry_after())
        self.metrics.register_gauge("queue_depth", self.queue.depth)
        self.scheduler = Scheduler(
            factory, self.config.replicas, clock=clock,
            step_timeout=self.config.step_timeout, metrics=self.metrics,
            max_cached=self.config.max_cached_executables,
            hedge_budget=self.config.hedge_budget)
        self.metrics.register_gauge(
            "admission_limit", lambda: self.admission.snapshot()["limit"])
        self.metrics.register_gauge(
            "replicas", lambda: len(self.scheduler.healthy_replicas()))
        self.recorder = FlightRecorder(size=self.config.recorder_size,
                                       rank=0, clock=clock)
        self._worker = None
        self._stop = threading.Event()
        self._crashed = None
        self._decode = None
        # default SLO: end-to-end request latency vs the AIMD target, a 1%
        # error budget; burn rates tick from the pump loop
        self.metrics.add_slo(SLO(
            "request_latency", "serving.request_latency_ms",
            target_ms=self.admission.snapshot()["target_ms"]))
        for sig in self.config.warmup_signatures:
            self.warmup(sig)

    def _make_factory(self, src):
        from .. import inference
        if callable(src) and not isinstance(src, inference.Config):
            return src
        if isinstance(src, inference.Config):
            pool = inference.PredictorPool(src, size=self.config.replicas)
            base = pool.retrieve(0)

            def factory(idx, _pool=pool, _base=base):
                # initial build comes from the pool (shared jit cache);
                # restarts clone the surviving executable cache
                if idx < self.config.replicas and factory.first[idx]:
                    factory.first[idx] = False
                    return _pool.retrieve(idx)
                return _base.clone()
            factory.first = [True] * self.config.replicas
            return factory
        raise TypeError(
            "InferenceServer wants an inference.Config or a "
            f"predictor_factory(idx) callable, got {type(src).__name__}")

    # -- time ------------------------------------------------------------------
    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.monotonic()

    # -- client API ------------------------------------------------------------
    def submit(self, inputs, deadline=None, timeout=None, request_id=None,
               priority=0, trace_ctx=None):
        """Admit one request (non-blocking). ``timeout`` is relative seconds
        (converted to an absolute deadline on the server clock); ``deadline``
        is already absolute; ``priority`` 0 is highest — lower classes are
        shed first under overload. Raises :class:`ServerOverloaded` (with a
        ``retry_after`` hint) when shedding. ``trace_ctx`` is an optional
        ``(trace_id, parent_span)`` pair from ``wire.frame_trace`` — the
        reference's frontend passes it so a client-minted trace id follows
        the request through the server's spans.
        """
        now = self._now()
        if deadline is None:
            rel = timeout if timeout is not None \
                else self.config.default_deadline
            deadline = now + rel if rel is not None else None
        tracer = get_tracer()
        tid, parent = trace_ctx if trace_ctx else (None, 0)
        trace = tracer.start(request_id=request_id, trace_id=tid,
                             parent=parent, priority=int(priority))
        admit_sid = trace.begin_span("server.admit")
        # AIMD gate first: it bounds requests in the whole system, the
        # queue bound below only the waiting room
        try:
            self.admission.admit(priority=priority, now=now)
        except ServerOverloaded as e:
            snap = self.admission.snapshot()
            trace.end_span(admit_sid, verdict="shed_admission",
                           limit=snap["limit"], inflight=snap["inflight"])
            trace.flag("shed")
            tracer.finish(trace, status="shed", error=e)
            raise
        snap = self.admission.snapshot()
        trace.end_span(admit_sid, verdict="admitted", limit=snap["limit"],
                       inflight=snap["inflight"])
        req = Request(inputs, deadline=deadline, now=now,
                      request_id=request_id, priority=priority)
        trace.request_id = req.id
        req.trace = trace
        # the admission slot is held until the request terminates, however
        # it terminates (set_result and set_error both fire on_done once)
        def _done(r, _trace=trace):
            self.admission.note_done()
            self._finish_trace(r, _trace)
        req.on_done = _done
        trace.begin_span("batcher.queue", depth=self.queue.depth())
        try:
            self.queue.put(req)
        except BaseException as e:
            # enqueue shed (queue full / unmeetable deadline): the request
            # never entered the system, give the admission slot back
            self.admission.note_done()
            trace.end_span("batcher.queue")
            trace.flag("shed")
            tracer.finish(trace, status="shed", error=e)
            raise
        return req

    def _finish_trace(self, req, trace):
        """Terminate a request's trace with a status matching how the
        request terminated; the tracer applies tail-based retention."""
        if trace is None:
            return
        err = req.error
        if err is None:
            status = "ok"
        elif isinstance(err, DeadlineExceeded):
            status = "deadline"
        elif isinstance(err, ServerOverloaded):
            status = "shed"
        else:
            status = "error"
        get_tracer().finish(trace, status=status, error=err)

    def infer(self, inputs, timeout=None, priority=0):
        """Synchronous convenience: submit + (pump | wait) + unwrap."""
        req = self.submit(inputs, timeout=timeout, priority=priority)
        if self._worker is None:
            self.pump_until_done(req)
        else:
            req.wait(timeout)
        if req.error is not None:
            raise req.error
        return req.result

    # -- batching loop ---------------------------------------------------------
    def pump(self, max_batches=1):
        """Run up to ``max_batches`` assemble→dispatch→reply rounds on the
        calling thread. Returns the number of batches processed. Between
        rounds the scheduler housekeeps (dead-replica restarts, breaker
        half-open probes) and the decode engine, if attached, steps."""
        done = 0
        self.metrics.slo_tick(now=self._now())
        for _ in range(max_batches):
            self.scheduler.maintain()
            if self._decode is not None:
                self._decode.step()
            t_asm = self._now()
            batch = self.queue.assemble(self.config.buckets,
                                        max_rows=self.config.max_batch_size)
            if batch is None:
                break
            t_asm_end = self._now()
            for req in batch.requests:
                if req.trace is not None:
                    # queued until assembly picked it up; then the
                    # grouping/padding work itself
                    req.trace.end_span("batcher.queue", t1=t_asm)
                    req.trace.record_span(
                        "batcher.batch_assemble", t_asm, t_asm_end,
                        batch=batch.id, rows=batch.rows,
                        bucket=batch.bucket)
            self._run_batch(batch)
            done += 1
        return done

    def pump_until_done(self, request, max_batches=1000):
        for _ in range(max_batches):
            if request.done():
                return
            if self.pump(1) == 0 and not request.done():
                raise FatalError(
                    f"request {request.id} not completed but queue is empty "
                    "(lost request — this is a server bug)")
        raise FatalError(f"request {request.id} still pending after "
                         f"{max_batches} batches")

    def _run_batch(self, batch):
        """Dispatch one batch with bounded retries; every request terminates.

        Retry policy: a replica death or a dispatch timeout is retried on a
        *different* replica (``batch.tried_replicas``) while attempts and
        deadlines allow; otherwise the batch's requests fail with the
        diagnostic error. The flight recorder ring gets one entry per
        attempt and is dumped on final failure, naming the batch.
        """
        attempts = self.config.max_retries + 1
        last_exc = None
        for attempt in range(attempts):
            # the clock read precedes the ring-entry open: nothing between
            # recorder.start and the try below may raise, or the entry
            # would be stranded "started" (flight_recorder_diff false hang)
            exec_start = self._now()
            entry = self.recorder.start(
                "serving.batch", group=f"bucket{batch.bucket}",
                shapes=[list(a.shape) for a in batch.arrays],
                dtypes=[str(a.dtype) for a in batch.arrays],
                peer={"batch": batch.id, "attempt": attempt,
                      "requests": [r.id for r in batch.requests]})
            try:
                with torch.profiler.record_function(
                        f"serving.batch.bucket{batch.bucket}"):
                    outputs, rep = self.scheduler.dispatch(batch)
            except (ReplicaDead, DistributedTimeout) as e:
                self.recorder.finish(entry, status=type(e).__name__)
                # a timeout/death is a congestion signal too: the AIMD loop
                # sees the full elapsed wall time, not a fabricated latency
                elapsed = self._now() - exec_start
                self._trace_dispatch(batch, exec_start,
                                     outcome=type(e).__name__)
                self._observe_exec(elapsed)
                self.admission.observe(elapsed, now=self._now())
                last_exc = e
                self.scheduler.restart_dead()
                if attempt + 1 < attempts and self._retry_allowed(batch):
                    self.metrics.inc("retries")
                    continue
                break
            except ServerOverloaded as e:
                self.recorder.finish(entry, status="ServerOverloaded")
                self._trace_dispatch(batch, exec_start, outcome="shed")
                last_exc = e
                break
            except Exception as e:
                self.recorder.finish(entry, status=type(e).__name__)
                self._trace_dispatch(batch, exec_start,
                                     outcome=type(e).__name__)
                last_exc = e
                break
            self.recorder.finish(entry, status="ok")
            self._trace_dispatch(batch, exec_start, outcome="ok")
            self._observe_exec(self._now() - exec_start)
            try:
                self._reply(batch, outputs, version=rep.version)
            except Exception as e:
                # a failed reply must still terminate every request — an
                # accepted request never goes silent
                self._fail_batch(batch, e)
            return
        self._fail_batch(batch, last_exc)

    def _trace_dispatch(self, batch, t0, outcome):
        """Turn the scheduler's ``dispatch_info`` stash into retroactive
        ``scheduler.dispatch`` / ``replica.exec`` spans on every traced
        request in the batch (outside the dispatch hot path)."""
        info = batch.dispatch_info
        t1 = self._now()
        breaker = None
        if info is not None:
            rep = self.scheduler.find_replica(info["replica"])
            if rep is not None:
                breaker = rep.breaker.describe().get("state")
        for req in batch.requests:
            tr = req.trace
            if tr is None:
                continue
            if info is None:
                tr.record_span("scheduler.dispatch", t0, t1, outcome=outcome)
                continue
            dsid = tr.record_span(
                "scheduler.dispatch", t0, t1, outcome=outcome,
                replica=info["replica"], hedged=info["hedged"],
                attempts=len(batch.tried_replicas), breaker=breaker)
            if info["t1"] is not None:
                tr.record_span("replica.exec", info["t0"], info["t1"],
                               parent=dsid, replica=info["replica"],
                               version=info["version"])
            tr.annotate(replica=info["replica"], version=info["version"])
            if info["hedged"]:
                tr.flag("hedged")

    def _observe_exec(self, elapsed_s):
        """Feed one batch's execution latency to the scheduler's per-server
        hedge-delay histogram and the global registry's always-on mirror.
        (The AIMD loop is fed separately: request *sojourn* in `_reply`,
        because pure execution time is blind to queueing — under overload
        batches still execute fast while requests age in the queue.)"""
        self.scheduler.note_exec_latency(elapsed_s)
        from ..profiler.metrics import get_registry
        get_registry().observe("serving.batch_exec_ms", elapsed_s * 1e3)

    def attach_autoscaler(self, config=None, journal=None,
                          job_id="serving-autoscale"):
        """Elastic replica scaling: not ported yet (ROADMAP A12)."""
        raise NotImplementedError(
            "attach_autoscaler: serving/autoscaler.py is not ported yet "
            "(ROADMAP A12)")

    def attach_rollout(self, root, loader, goldens=(), config=None,
                       journal=None, job_id="serving-rollout"):
        """Live model rollout: not ported yet (ROADMAP A12)."""
        raise NotImplementedError(
            "attach_rollout: serving/rollout.py is not ported yet "
            "(ROADMAP A12)")

    def attach_decode(self, backend, config=None):
        """Enable continuous-batching autoregressive decode (serving/decode/,
        docs/serving.md "Continuous-batching decode"). The engine shares
        this server's clock and admission controller, and is stepped once
        per batching round (pump and threaded loop alike) — decode streams
        make progress even when the batch queue is empty. Returns the
        DecodeEngine."""
        from .decode import DecodeEngine
        self._decode = DecodeEngine(backend, config=config,
                                    clock=self._clock,
                                    admission=self.admission)
        # decode SLOs: time-to-first-token and time-per-output-token (both
        # targets sit on DEFAULT_BUCKETS_MS bounds — bucket-exact goodput)
        self.metrics.add_slo(SLO("decode_ttft", "decode.ttft_ms",
                                 target_ms=500.0))
        self.metrics.add_slo(SLO("decode_tpot", "decode.tpot_ms",
                                 target_ms=100.0))
        return self._decode

    def attach_disagg(self, config=None, journal=None, journal_dir=None,
                      job_id="disagg"):
        """Disaggregated prefill/decode serving: not ported yet (ROADMAP
        A12)."""
        raise NotImplementedError(
            "attach_disagg: serving/disagg.py is not ported yet "
            "(ROADMAP A12)")

    def submit_generate(self, prompt, max_new_tokens=None, timeout=None,
                        priority=0, on_token=None, request_id=None,
                        trace_ctx=None):
        """Admit one generation request (non-blocking). Token-level results
        arrive via ``on_token(stream, token, seq)`` on the engine thread;
        call ``stream.wait()`` for termination. Raises
        :class:`ServerOverloaded` (with ``retry_after``) when shedding."""
        if self._decode is None:
            raise PreconditionNotMetError(
                "no decode engine: call attach_decode() before "
                "submit_generate()")
        if timeout is None:
            timeout = self.config.default_deadline
        return self._decode.join(prompt, max_new_tokens=max_new_tokens,
                                 timeout=timeout, priority=priority,
                                 on_token=on_token, request_id=request_id,
                                 trace_ctx=trace_ctx)

    def _retry_allowed(self, batch):
        now = self._now()
        for req in batch.requests:
            if req.deadline is not None and req.deadline <= now:
                return False
        return bool(self.scheduler.healthy_replicas())

    def _reply(self, batch, outputs, version=None):
        """Complete every request in the batch from the padded outputs,
        stamping each with the model version of the replica that served it
        (rollout attribution; rides the wire frame as ``model_version``)."""
        maybe_inject("serving.reply", ConnectionError)
        now = self._now()
        for req in batch.requests:
            req.version = version
        batch.scatter_outputs(outputs)
        self.metrics.note_version(version, len(batch.requests))
        self.metrics.inc("batches")
        self.metrics.inc("rows", batch.rows)
        self.metrics.inc("padded_rows", batch.bucket - batch.rows)
        self.metrics.inc("completed", len(batch.requests))
        sojourn = 0.0
        for req in batch.requests:
            lat = max(0.0, now - req.enqueued_at)
            self.metrics.observe_latency(
                lat, priority=req.priority,
                trace_id=req.trace.trace_id if req.trace is not None
                else None)
            sojourn = max(sojourn, lat)
        # the AIMD congestion signal: worst end-to-end sojourn in the batch
        # (queue wait + execution) vs the latency target
        self.admission.observe(sojourn, now=now)

    def _fail_batch(self, batch, exc):
        exc = exc if exc is not None else RuntimeError(
            f"batch#{batch.id} failed with no diagnostic")
        batch.fail(exc)
        self.metrics.inc("failed", len(batch.requests))
        dump = self._dump(reason=f"serving-batch-failure:batch#{batch.id}",
                          batch=batch)
        if dump:
            self.metrics.inc("recorder_dumps")

    def _dump(self, reason, batch=None):
        try:
            extra = {"failed_batch": batch.describe()} if batch else None
            return self.recorder.dump(reason=reason, extra=extra)
        except OSError:
            return None

    # -- warmup ----------------------------------------------------------------
    def warmup(self, signature):
        """Pre-compile all configured buckets for one per-row signature on
        every replica. signature: [(per_row_shape, dtype), ...]."""
        sig = tuple((tuple(s), str(d)) for s, d in signature)
        return self.scheduler.warmup(sig, self.config.buckets)

    # -- threaded mode ---------------------------------------------------------
    def start(self):
        """Spawn the batching worker (real-clock servers only — deterministic
        fake-clock instances are pump-driven by design)."""
        if self._clock is not None:
            raise PreconditionNotMetError(
                "fake-clock server is pump-driven; call pump() instead "
                "of start()")
        if self._worker is not None and self._worker.is_alive():
            return self
        self._stop.clear()
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-batcher")
        self._worker.start()
        return self

    def _loop(self):
        try:
            while not self._stop.is_set():
                if not self.queue.wait_nonempty(self.config.batch_wait):
                    self.scheduler.maintain()
                    if self._decode is not None:
                        self._decode.step()
                    continue
                # brief accumulation window lets concurrent submitters fill
                # the bucket (classic batching-delay/throughput tradeoff)
                self._stop.wait(self.config.batch_wait)
                self.pump(max_batches=4)
        except BaseException as e:   # crash path: dump + fail everything
            self._crashed = e
            self._dump(reason=f"serving-crash:{type(e).__name__}")
            self.queue.drain(RuntimeError(
                f"serving worker crashed: {e!r} (flight recorder dumped)"))
            raise

    def stop(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=10)
            self._worker = None
        n = self.queue.drain(ServerOverloaded("server stopped"))
        if n:
            self.metrics.inc("shed", n)
        if self._decode is not None:
            self._decode.drain(ServerOverloaded("server stopped"))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- introspection ---------------------------------------------------------
    def stats(self):
        snap = self.metrics.snapshot()
        snap["replicas"] = self.scheduler.describe()
        snap["admission"] = self.admission.snapshot()
        snap["hedging"] = self.scheduler.hedge_stats()
        if self._decode is not None:
            snap["decode"] = self._decode.stats()
        snap["compiles"] = sum(r.compile_count
                               for r in self.scheduler.replicas)
        snap["crashed"] = repr(self._crashed) if self._crashed else None
        return snap

