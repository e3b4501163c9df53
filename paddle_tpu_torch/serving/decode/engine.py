"""Continuous-batching decode scheduler: per-step join/leave, prefill split
(port of paddle_tpu/serving/decode/engine.py).

Static batching amortizes compiles but wastes the accelerator on decode
traffic: requests in one batch finish at different lengths, so the batch
runs at the speed of its longest member while finished slots burn cycles.
Continuous batching (ORCA, OSDI'22) reschedules at **token granularity** —
every engine step assembles the currently-running streams, decodes one token
for each, and lets streams join or leave between steps. Three rules keep it
production-shaped:

- **prefill is chunked and rationed.** A long prompt is consumed at most
  ``prefill_chunk`` tokens per engine step, one stream per step, while the
  decode tick still runs for everyone else — an arriving 10k-token prompt
  cannot stall in-flight token streams (the soak asserts in-flight TPOT p99
  stays within tolerance of a no-long-prompt baseline);
- **admission is refusal, not collapse.** Joins pass the
  :class:`~paddle_tpu_torch.serving.overload.AdmissionController` (priority
  shedding + retry-after hints) and then reserve KV blocks from the paged
  pool (:mod:`.kv_cache`); either failing refuses the join with a typed
  error. Mid-stream block exhaustion evicts the *newest* claimant with
  :class:`~.kv_cache.KVCacheExhausted` — accepted streams always terminate
  with tokens or a typed error, never a silent stall;
- **replica death is a replay, not a loss.** On an injected/real step
  failure the engine resets the backend and re-prefills every live stream
  (prompt + tokens already emitted), so a deterministic backend resumes the
  exact continuation. Chaos sites ``decode.{join,prefill,step,evict}`` make
  the whole lifecycle drivable from :mod:`paddle_tpu_torch.resilience.faults`.

Two opt-in accelerators ride the same loop (both off by default, both
preserving every contract above): **prefix sharing**
(``FLAGS_decode_prefix_sharing``, :mod:`.prefix`) adopts radix-matched
cached prompt pages at join so warm prompts skip prefill — chaos sites
``prefix.{lookup,share,evict}`` — and **speculative decoding**
(``FLAGS_decode_spec_k`` + a :class:`~.specdecode.DraftModel`) turns the
decode tick into a draft-K/verify-1 round, token-identical to greedy —
chaos sites ``spec.{draft,verify}``.

The clock is injectable; the chaos soak and ``serving_bench --decode`` run
entirely on a fake clock with zero real sleeps.
"""
from __future__ import annotations

import itertools
import threading
import time

from ...resilience.faults import maybe_inject
from ..batcher import DeadlineExceeded, ServerOverloaded
from ..metrics import percentile
from ..scheduler import ReplicaDead
from .kv_cache import BlockTable, KVBlockPool, KVCacheExhausted
from .prefix import PrefixCache
from .specdecode import DRAFT_PAD, SpecDecoder

__all__ = ["DecodeConfig", "DecodeStream", "DecodeEngine"]

_ids = itertools.count()


def _flag(name, default):
    from ...framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


class DecodeConfig:
    """Engine knobs. ``None`` means "read the FLAGS_decode_* default"."""

    def __init__(self, max_running=8, num_blocks=None, block_size=None,
                 prefill_chunk=None, max_new_tokens=None, eos_token=None,
                 prefix_sharing=None, spec_k=None, draft=None):
        self.max_running = int(max_running)
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefill_chunk = int(prefill_chunk if prefill_chunk is not None
                                 else _flag("FLAGS_decode_prefill_chunk", 64))
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None
            else _flag("FLAGS_decode_max_new_tokens", 64))
        self.eos_token = eos_token
        # prefix sharing (serving/decode/prefix.py): warm joins adopt the
        # cached prefix pages instead of re-prefilling
        self.prefix_sharing = bool(
            _flag("FLAGS_decode_prefix_sharing", False)
            if prefix_sharing is None else prefix_sharing)
        # speculative decoding (serving/decode/specdecode.py): draft
        # proposes up to spec_k tokens per tick, one verify pass accepts
        self.spec_k = int(_flag("FLAGS_decode_spec_k", 0)
                          if spec_k is None else spec_k)
        self.draft = draft
        if self.max_running < 1 or self.prefill_chunk < 1 \
                or self.max_new_tokens < 1:
            raise ValueError("max_running, prefill_chunk and max_new_tokens "
                             "must all be >= 1")
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0 (0 disables speculation)")


class DecodeStream:
    """One in-flight generation: prompt in, tokens out, typed error on
    failure. Termination is observable two ways — ``on_token`` fires per
    token on the engine thread, and ``wait()`` blocks a caller thread until
    the stream finishes (tokens) or fails (``error`` set)."""

    __slots__ = ("id", "prompt", "max_new_tokens", "deadline", "priority",
                 "enqueued_at", "first_token_at", "last_token_at", "tokens",
                 "seq", "on_token", "table", "error", "done", "trace",
                 "_fill", "_fill_pos", "_done_evt", "_admitted")

    def __init__(self, prompt, max_new_tokens, deadline, priority,
                 enqueued_at, on_token=None, request_id=None):
        self.id = request_id if request_id is not None \
            else f"gen-{next(_ids)}"
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline
        self.priority = int(priority)
        self.enqueued_at = enqueued_at
        self.first_token_at = None
        self.last_token_at = None
        self.tokens = []
        self.seq = 0
        self.on_token = on_token
        self.table = None
        self.error = None
        self.done = False
        # request-level Trace (profiler.tracing), attached by join();
        # None when tracing is off or the ring is full
        self.trace = None
        self._fill = list(self.prompt)   # tokens still to absorb into KV
        self._fill_pos = 0               # absolute position of next fill
        self._done_evt = threading.Event()
        self._admitted = False

    def remaining_fill(self):
        """Prompt (or replay) tokens not yet absorbed into the KV cache."""
        return len(self._fill)

    def wait(self, timeout=None):
        """Block until the stream terminates. True iff it did in time."""
        return self._done_evt.wait(timeout)

    def describe(self):
        return {"id": self.id, "prompt_len": len(self.prompt),
                "tokens": len(self.tokens), "done": self.done,
                "error": type(self.error).__name__ if self.error else None}


class DecodeEngine:
    """The continuous-batching loop. Drive it by calling :meth:`step` —
    the server's pump does this once per idle/batch tick; tests call it
    directly under a fake clock.
    """

    def __init__(self, backend, config=None, clock=None, admission=None):
        if _flag("FLAGS_decode_quantize", ""):
            raise NotImplementedError(
                "FLAGS_decode_quantize: weight-only quantization of decode "
                "replicas (slim.ptq) is not ported yet (ROADMAP A12)")
        self.config = config or DecodeConfig()
        self.backend = backend
        self.pool = KVBlockPool(num_blocks=self.config.num_blocks,
                                block_size=self.config.block_size)
        self._clock = clock or time.monotonic
        self._admission = admission
        self._streams = {}     # guarded-by: _lock (id -> live stream)
        self._prefill_rr = []  # guarded-by: _lock (prefill-ration queue)
        self._ttft_ms = []     # guarded-by: _lock
        self._tpot_ms = []     # guarded-by: _lock
        self._emitted = 0      # guarded-by: _lock
        self._lock = threading.RLock()
        # Prefix sharing needs backend state snapshots at block boundaries
        # (export) and warm installs (adopt) — without both hooks a "warm"
        # stream could not skip prefill, so sharing silently disables.
        sharing = self.config.prefix_sharing \
            and hasattr(backend, "export_state") \
            and hasattr(backend, "adopt_state")
        self._prefix = PrefixCache(self.pool) if sharing else None
        # Speculation needs a draft and a backend verify pass; the
        # reference backend only carries one for its own toy stepper.
        wants_spec = self.config.spec_k > 0 and self.config.draft is not None
        can_spec = callable(getattr(backend, "verify", None)) \
            and getattr(backend, "vstep", True) is not None
        self._spec = SpecDecoder(self.config.draft, self.config.spec_k) \
            if wants_spec and can_spec else None
        from ...profiler.metrics import get_registry
        # the gauge fn runs on the exporter thread — go through the
        # locked accessor, never the raw dict
        get_registry().register_gauge_fn(
            "decode.running_count", lambda: self.running())
        get_registry().register_gauge_fn(
            "decode.spec_accept_ratio",
            lambda: self._spec.accept_ratio() if self._spec is not None
            else 0.0)

    # -- admission -----------------------------------------------------------
    def _retry_after(self, priority):
        if self._admission is not None:
            return self._admission.retry_after(priority)
        return 0.05

    def join(self, prompt, max_new_tokens=None, timeout=None, priority=1,
             on_token=None, request_id=None, trace_ctx=None, trace=None):
        """Admit one generation request into the running batch.

        Refusals are typed and carry a retry-after hint: the admission
        controller sheds first (load), then the running-set cap, then the
        KV pool (memory). A refused join holds no blocks and no admission
        slot — there is nothing to clean up. ``trace_ctx`` is an optional
        ``(trace_id, parent_span)`` pair from ``wire.frame_trace``;
        ``trace`` is an already-started Trace the caller owns (the disagg
        controller hands its request trace across the prefill→decode
        boundary so the whole lifecycle lands in one trace).
        """
        from ...profiler.metrics import get_registry
        from ...profiler.tracing import get_tracer
        tracer = get_tracer()
        now = self._clock()
        if trace is None:
            tid, parent = trace_ctx if trace_ctx else (None, 0)
            trace = tracer.start(request_id=request_id, trace_id=tid,
                                 parent=parent, priority=int(priority),
                                 kind="decode")
        jsid = trace.begin_span("engine.join")
        try:
            with self._lock:
                maybe_inject("decode.join", ServerOverloaded)
                if self._admission is not None:
                    self._admission.admit(priority, now=now)
                try:
                    if len(self._streams) >= self.config.max_running:
                        raise ServerOverloaded(
                            f"decode running set full "
                            f"({self.config.max_running} streams)",
                            retry_after=self._retry_after(priority))
                    stream = DecodeStream(
                        prompt, max_new_tokens if max_new_tokens is not None
                        else self.config.max_new_tokens,
                        deadline=(now + timeout) if timeout else None,
                        priority=priority, enqueued_at=now,
                        on_token=on_token, request_id=request_id)
                    table = BlockTable(self.pool)
                    # radix match before any fresh allocation: a warm hit
                    # adopts the cached prefix pages (shared, refcounted)
                    # and only the suffix still needs pool capacity
                    hit = self._prefix.lookup(stream.prompt) \
                        if self._prefix is not None else None
                    if hit is not None:
                        table.adopt_shared(hit.blocks, hit.tokens,
                                           ref_held=True)
                    if not self._kv_ensure(table, len(stream.prompt) + 1):
                        # a refused join holds nothing: drop the adopted
                        # shared references before raising
                        table.release()
                        raise ServerOverloaded(
                            f"KV pool exhausted ({self.pool.free()} free "
                            f"blocks, prompt needs "
                            f"{self.pool.blocks_for(len(stream.prompt) + 1)})",
                            retry_after=self._retry_after(priority))
                except ServerOverloaded:
                    if self._admission is not None:
                        self._admission.note_done()
                    get_registry().inc_counter("decode.sheds_total")
                    raise
                stream.table = table
                stream._admitted = True
                stream.trace = trace
                trace.request_id = stream.id
                if hit is not None:
                    # skip the matched prefill: install the cached backend
                    # state and fill only the unmatched suffix (a full
                    # match fills nothing and emits its cached first token
                    # below — prefill is skipped entirely)
                    stream._fill = list(stream.prompt[hit.tokens:])
                    stream._fill_pos = int(hit.tokens)
                    self.backend.adopt_state(stream, hit.state)
                    get_registry().inc_counter("decode.warm_joins_total")
                trace.end_span(jsid, verdict="admitted",
                               running=len(self._streams) + 1,
                               kv_free=self.pool.free(),
                               warm=int(hit is not None))
                self._streams[stream.id] = stream
                if stream._fill:
                    self._prefill_rr.append(stream.id)
                get_registry().inc_counter("decode.joins_total")
                if hit is not None and not stream._fill:
                    tok = int(hit.token)
                    self._emit(stream, tok, now)
                    self._maybe_finish(stream, tok)
                return stream
        except ServerOverloaded as e:
            trace.end_span(jsid, verdict="shed")
            trace.flag("shed")
            tracer.finish(trace, status="shed", error=e)
            raise

    def adopt(self, prompt, *, fill_pos, state, tokens=(),
              max_new_tokens=None, deadline=None, priority=1, on_token=None,
              request_id=None, enqueued_at=None, trace=None):
        """Admit a stream whose prefill already ran on a prefill-class
        replica (serving/disagg.py): the prompt is fully absorbed into
        migrated KV state, so the stream enters the decode tick directly
        with nothing left to fill.

        Admission mirrors :meth:`join` — AIMD controller, running-set cap,
        then the KV pool — except the pool shortage here is the *decode
        side's* refusal of a migration and raises the typed
        :class:`~.kv_cache.KVCacheExhausted` (with ``retry_after``)
        **before any page is claimed**, per the two-phase handoff contract.
        ``state`` is the backend's :meth:`export_state` snapshot;
        ``tokens`` are tokens the prefill side already produced (usually
        the first token), re-emitted here so TTFT and the client callback
        see them exactly once. ``enqueued_at`` is the original submit time
        so TTFT spans the whole disaggregated path, not just adoption.
        """
        from ...profiler.metrics import get_registry
        from ...profiler.tracing import get_tracer
        tracer = get_tracer()
        now = self._clock()
        if trace is None:
            trace = tracer.start(request_id=request_id,
                                 priority=int(priority), kind="decode")
        asid = trace.begin_span("engine.join")
        try:
            with self._lock:
                maybe_inject("decode.join", ServerOverloaded)
                if self._admission is not None:
                    self._admission.admit(priority, now=now)
                try:
                    if len(self._streams) >= self.config.max_running:
                        raise ServerOverloaded(
                            f"decode running set full "
                            f"({self.config.max_running} streams)",
                            retry_after=self._retry_after(priority))
                    stream = DecodeStream(
                        prompt, max_new_tokens if max_new_tokens is not None
                        else self.config.max_new_tokens,
                        deadline=deadline, priority=priority,
                        enqueued_at=enqueued_at if enqueued_at is not None
                        else now,
                        on_token=on_token, request_id=request_id)
                    table = BlockTable(self.pool)
                    if not self._kv_ensure(table, int(fill_pos) + 1):
                        raise KVCacheExhausted(
                            f"decode-side KV pool exhausted "
                            f"({self.pool.free()} free blocks, adoption "
                            f"needs "
                            f"{self.pool.blocks_for(int(fill_pos) + 1)})",
                            retry_after=self._retry_after(priority))
                except (ServerOverloaded, KVCacheExhausted):
                    if self._admission is not None:
                        self._admission.note_done()
                    get_registry().inc_counter("decode.sheds_total")
                    raise
                stream.table = table
                stream._admitted = True
                stream.trace = trace
                trace.request_id = stream.id
                stream._fill = []
                stream._fill_pos = int(fill_pos)
                self.backend.adopt_state(stream, state)
                if self._prefix is not None:
                    # migrating a shared prefix exports once; re-sharing it
                    # here seeds the decode-side radix index so later
                    # identical prompts join warm on this replica too
                    self._prefix.share(
                        list(stream.prompt)[:stream._fill_pos], table,
                        state, token=int(tokens[0]) if tokens else None)
                trace.end_span(asid, verdict="adopted",
                               running=len(self._streams) + 1,
                               kv_free=self.pool.free())
                self._streams[stream.id] = stream
                get_registry().inc_counter("decode.adoptions_total")
                for t in tokens:
                    if stream.done:
                        break
                    self._emit(stream, int(t), now)
                    self._maybe_finish(stream, int(t))
                return stream
        except (ServerOverloaded, KVCacheExhausted) as e:
            trace.end_span(asid, verdict="shed")
            trace.flag("shed")
            tracer.finish(trace, status="shed", error=e)
            raise

    # -- the engine tick -----------------------------------------------------
    def step(self):   # hot-path: the engine tick — every running stream waits on it
        """One scheduling round: expire deadlines, ration one prefill
        chunk, decode one token for every running stream. A replica death
        mid-round resets the backend and replays live streams. Returns the
        number of tokens emitted this round."""
        with self._lock:
            before = self._emitted
            now = self._clock()
            try:
                maybe_inject("decode.step", ReplicaDead)
                self._expire(now)
                self._prefill_tick(now)
                self._decode_tick(now)
            except ReplicaDead:
                self._restart(now)
            return self._emitted - before

    def _expire(self, now):  # requires-lock: _lock
        for stream in list(self._streams.values()):
            if stream.deadline is not None and now > stream.deadline:
                self._evict(stream, DeadlineExceeded(
                    f"{stream.id}: deadline exceeded after "
                    f"{len(stream.tokens)} tokens"))

    # -- prefill (rationed: one chunk, one stream, per step) -----------------
    def _prefill_tick(self, now):  # requires-lock: _lock
        while self._prefill_rr:
            sid = self._prefill_rr[0]
            stream = self._streams.get(sid)
            if stream is None or stream.done or not stream._fill:
                self._prefill_rr.pop(0)
                continue
            self._prefill(stream, now)
            if stream.done or not stream._fill:
                if self._prefill_rr and self._prefill_rr[0] == sid:
                    self._prefill_rr.pop(0)
            else:
                # ration spent; rotate so concurrent prefills interleave
                self._prefill_rr.append(self._prefill_rr.pop(0))
            return

    def _kv_ensure(self, table, tokens):  # requires-lock: _lock
        """``table.ensure`` with prefix-cache pressure relief: a pool
        shortage first evicts cold cache entries (refcount-then-LRU) and
        retries once — cache retention must never starve a live stream."""
        if table.ensure(tokens):  # lifecycle-ok: table is stream-owned; _release (or the refusal path) frees it
            return True
        if self._prefix is None:
            return False
        need = self.pool.blocks_for(tokens) - len(table.blocks)
        if self._prefix.evict(need) <= 0:
            return False
        return table.ensure(tokens)  # lifecycle-ok: same stream-owned table as above

    def _prefill(self, stream, now):  # requires-lock: _lock
        """Absorb at most one ``prefill_chunk`` of this stream's pending
        tokens into the KV cache; emits the first new token when the fill
        completes (fresh join → TTFT; replay → resumed continuation)."""
        from ...profiler.metrics import get_registry
        maybe_inject("decode.prefill", ReplicaDead)
        n = min(len(stream._fill), self.config.prefill_chunk)
        if self._prefix is not None:
            # clamp the chunk to end on a page boundary when it can reach
            # one, so every share point below carries a backend snapshot
            # taken exactly at a page edge (the radix index's granularity)
            bs = self.pool.block_size
            aligned = ((stream._fill_pos + n) // bs) * bs
            if stream._fill_pos < aligned < stream._fill_pos + n:
                n = aligned - stream._fill_pos
        t_kv = self._clock()
        grown = self._kv_ensure(stream.table, stream._fill_pos + n)
        if stream.trace is not None:
            stream.trace.record_span("engine.kv_wait", t_kv, self._clock(),
                                     need=stream._fill_pos + n, ok=grown)
        if not grown:
            self._evict(stream, KVCacheExhausted(
                f"{stream.id}: KV pool exhausted mid-prefill",
                retry_after=self._retry_after(stream.priority)))
            return
        chunk, stream._fill = stream._fill[:n], stream._fill[n:]
        start = stream._fill_pos
        stream._fill_pos += n
        t0 = self._clock()
        token = self.backend.prefill_chunk(stream, chunk, start)
        if stream.trace is not None:
            stream.trace.record_span("engine.prefill_chunk", t0,
                                     self._clock(), tokens=n, start=start)
        get_registry().inc_counter("decode.prefill_chunks_total")
        if self._prefix is not None:
            done = not stream._fill
            if done or stream._fill_pos % self.pool.block_size == 0:
                # index the consumed prefix (content-addressed, so replay
                # fills — prompt + emitted — index just as well); at fill
                # completion the entry turns terminal: it carries the
                # first generated token and lets the next identical
                # prompt skip prefill entirely
                consumed = (list(stream.prompt)
                            + list(stream.tokens))[:stream._fill_pos]
                self._prefix.share(
                    consumed, stream.table,
                    self.backend.export_state(stream),
                    token=token if done else None)
        if token is not None:
            # re-read the clock: the backend's work (and a fake-clock
            # harness's service charge) happened since `now` was taken
            self._emit(stream, token, self._clock())
            self._maybe_finish(stream, token)

    # -- decode (every running stream, every step) ---------------------------
    def _decode_tick(self, now):  # requires-lock: _lock
        runnable = [s for s in self._streams.values()
                    if not s.done and not s._fill and s.tokens]
        if not runnable:
            return
        # speculative round? one draft pass for the whole tick (None =
        # injected fault or no guesses — fall back to the plain tick)
        drafts = self._spec.propose(runnable) \
            if self._spec is not None else None
        dmap = {s.id: d for s, d in zip(runnable, drafts)} \
            if drafts is not None else {}
        ready = []
        for stream in runnable:
            # the consumed prefix grows by one token this round — plus up
            # to the stream's real (non-pad) draft tokens when speculating
            horizon = 1 + sum(1 for t in dmap.get(stream.id, ())
                              if t != DRAFT_PAD)
            t_kv = self._clock()
            grown = self._kv_ensure(stream.table,
                                    stream._fill_pos + horizon)
            # COW fork: generation writes into the page covering the next
            # position — a warm stream's first token must not scribble on
            # a shared prefix page
            writable = grown and (self._prefix is None
                                  or self._cow(stream))
            if not (grown and writable) and stream.trace is not None:
                # only the failed growth attempt earns a span — a
                # satisfied one-token extension is the per-round common
                # case and would double every trace's span count
                stream.trace.record_span("engine.kv_wait", t_kv,
                                         self._clock(),
                                         need=stream._fill_pos + horizon,
                                         ok=False)
            if grown and writable:
                ready.append(stream)
            else:
                self._evict(stream, KVCacheExhausted(
                    f"{stream.id}: KV pool exhausted at "
                    f"{len(stream.tokens)} tokens",
                    retry_after=self._retry_after(stream.priority)))
        if not ready:
            return
        if dmap:
            self._spec_round(ready, dmap)
            return
        t0 = self._clock()
        out = self.backend.decode(ready)
        now = self._clock()   # include the round's service time
        for stream, token in zip(ready, out):
            if stream.done:
                continue   # evicted by a mid-round callback failure
            stream._fill_pos += 1
            if stream.trace is not None:
                stream.trace.record_span("engine.decode_tick", t0, now,
                                         batch=len(ready), seq=stream.seq)
            self._emit(stream, int(token), now)
            self._maybe_finish(stream, int(token))

    def _cow(self, stream):  # requires-lock: _lock
        """Fork any shared page the next write would land on; on a pool
        shortage, shed cold cache entries and retry once (same pressure
        valve as :meth:`_kv_ensure`)."""
        if stream.table.ensure_writable(stream._fill_pos):
            return True
        self._prefix.evict(2)
        return stream.table.ensure_writable(stream._fill_pos)

    def _spec_round(self, ready, dmap):  # requires-lock: _lock
        """Draft-K/verify-1: one batched teacher-forced verify pass for
        the tick's whole ready set (chaos site ``spec.verify`` — a death
        here is a replica death, and :meth:`step`'s handler replays; the
        replay is token-identical through speculation because only
        *emitted* tokens replay, and those are greedy-equivalent by the
        acceptance rule). Each stream emits its accepted draft prefix plus
        the target's correction (or bonus) token, then
        ``BlockTable.truncate`` returns the pages over-reserved for
        rejected drafts."""
        maybe_inject("spec.verify", ReplicaDead)
        t0 = self._clock()
        results = self.backend.verify(ready, [dmap[s.id] for s in ready])
        now = self._clock()
        for stream, emitted in zip(ready, results):
            if stream.done:
                continue   # evicted by a mid-round callback failure
            real = sum(1 for t in dmap[stream.id] if t != DRAFT_PAD)
            self._spec.note(real, len(emitted) - 1)
            stream._fill_pos += len(emitted)
            if stream.trace is not None:
                stream.trace.record_span("engine.decode_tick", t0, now,
                                         batch=len(ready), seq=stream.seq,
                                         spec_accepted=len(emitted) - 1)
            for token in emitted:
                if stream.done:
                    break
                self._emit(stream, int(token), now)
                self._maybe_finish(stream, int(token))
            if not stream.done:
                stream.table.truncate(stream._fill_pos + 1)

    # -- emission & termination ----------------------------------------------
    def _emit(self, stream, token, now):  # requires-lock: _lock
        from ...profiler.metrics import get_registry
        stream.tokens.append(int(token))
        seq = stream.seq
        stream.seq += 1
        if stream.first_token_at is None:
            stream.first_token_at = now
            ttft_ms = max(0.0, (now - stream.enqueued_at) * 1000.0)
            self._ttft_ms.append(ttft_ms)
            if stream.trace is not None:
                stream.trace.annotate(ttft_ms=ttft_ms)
            get_registry().observe(
                "decode.ttft_ms", ttft_ms,
                exemplar=stream.trace.trace_id
                if stream.trace is not None else None)
            if self._admission is not None:
                self._admission.observe(ttft_ms / 1000.0, now=now)
        else:
            tpot_ms = max(0.0, (now - stream.last_token_at) * 1000.0)
            self._tpot_ms.append(tpot_ms)
            get_registry().observe(
                "decode.tpot_ms", tpot_ms,
                exemplar=stream.trace.trace_id
                if stream.trace is not None else None)
        stream.last_token_at = now
        self._emitted += 1
        get_registry().inc_counter("decode.tokens_total")
        for res in (self._ttft_ms, self._tpot_ms):
            if len(res) > 8192:
                del res[:4096]
        if stream.on_token is not None:
            try:
                stream.on_token(stream, int(token), seq)
            except Exception as exc:
                # the consumer is gone (torn socket, cancelled client):
                # reclaim the slot instead of decoding into the void
                self._evict(stream, exc if isinstance(exc, ConnectionError)
                            else ConnectionError(f"on_token failed: {exc}"))

    def _maybe_finish(self, stream, token):  # requires-lock: _lock
        if stream.done:
            return
        if len(stream.tokens) >= stream.max_new_tokens or (
                self.config.eos_token is not None
                and token == self.config.eos_token):
            self._finish(stream)

    def _finish(self, stream):  # requires-lock: _lock
        from ...profiler.metrics import get_registry
        from ...profiler.tracing import get_tracer
        self._release(stream)
        stream.done = True
        get_registry().inc_counter("decode.streams_completed_total")
        get_tracer().finish(stream.trace, status="ok")
        stream._done_evt.set()

    def _evict(self, stream, error):  # requires-lock: _lock
        """Terminate a stream with a typed error. Eviction must always
        complete — a fault injected here is recorded and swallowed."""
        from ...profiler.metrics import get_registry
        from ...profiler.tracing import get_tracer
        try:
            maybe_inject("decode.evict", ConnectionError)
        except ConnectionError:
            pass   # eviction is the cleanup path; it cannot itself fail
        if stream.done:
            return
        self._release(stream)
        stream.error = error
        stream.done = True
        get_registry().inc_counter("decode.streams_failed_total",
                                   labels={"reason": type(error).__name__})
        get_registry().inc_counter("decode.evictions_total")
        if isinstance(error, DeadlineExceeded):
            status = "deadline"
        elif isinstance(error, (ServerOverloaded, KVCacheExhausted)):
            status = "shed"
        else:
            status = "error"
        get_tracer().finish(stream.trace, status=status, error=error)
        stream._done_evt.set()

    def _release(self, stream):  # requires-lock: _lock
        self._streams.pop(stream.id, None)
        try:
            self.backend.release(stream)
        except Exception:
            pass   # backend state for a dead stream is best-effort
        if stream.table is not None:
            stream.table.release()
        if stream._admitted and self._admission is not None:
            stream._admitted = False
            self._admission.note_done()

    # -- replica death -------------------------------------------------------
    def _restart(self, now):  # requires-lock: _lock
        """The backend lost its device state. Reset it and queue every live
        stream for replay: re-prefill prompt + already-emitted tokens, after
        which a deterministic backend resumes the identical continuation."""
        from ...profiler.metrics import get_registry
        get_registry().inc_counter("decode.restarts_total")
        try:
            self.backend.reset()
        except Exception:
            pass   # a half-dead backend still gets fresh prefills
        self._prefill_rr = []
        for stream in self._streams.values():
            if stream.done:
                continue
            stream._fill = list(stream.prompt) + list(stream.tokens)
            stream._fill_pos = 0
            self._prefill_rr.append(stream.id)

    def drain(self, error=None):
        """Terminate every live stream with ``error`` (server shutdown).
        Returns the number of streams evicted."""
        with self._lock:
            live = list(self._streams.values())
            for stream in live:
                self._evict(stream, error if error is not None
                            else ServerOverloaded("decode engine drained"))
            if self._prefix is not None:
                # shutdown audit contract: after drain, every cache
                # reference is dropped and the pool's refcount map is empty
                self._prefix.clear()
            return len(live)

    # -- observability -------------------------------------------------------
    def running(self):
        with self._lock:
            return len(self._streams)

    def kv_leaked(self):
        """Pool blocks accounted to no live stream's table and not held by
        the prefix cache — the soak/campaign leak audit. Cache retention
        after streams finish is intentional warm state, not a leak;
        :meth:`drain` clears it so a shutdown audit can additionally
        assert ``pool.used() == 0``."""
        with self._lock:
            owned = set()
            for s in self._streams.values():
                if s.table is not None:
                    owned.update(s.table.blocks)
            if self._prefix is not None:
                owned.update(self._prefix.blocks())
            return self.pool.used() - len(owned)

    def latency_reservoirs(self):
        """Copies of the (ttft_ms, tpot_ms) reservoirs — the disagg
        controller pools them across its decode fleet for class-level
        percentiles."""
        with self._lock:
            return list(self._ttft_ms), list(self._tpot_ms)

    def stats(self):
        with self._lock:
            snap = {
                "running": len(self._streams),
                "pending_prefill": sum(1 for s in self._streams.values()
                                       if s._fill),
                "tokens_emitted": self._emitted,
                "kv_blocks_used": self.pool.used(),
                "kv_blocks_free": self.pool.free(),
                "ttft_p50_ms": percentile(self._ttft_ms, 50),
                "ttft_p99_ms": percentile(self._ttft_ms, 99),
                "tpot_p50_ms": percentile(self._tpot_ms, 50),
                "tpot_p99_ms": percentile(self._tpot_ms, 99),
            }
            step = getattr(self.backend, "step", None)
            if step is not None and hasattr(step, "compile_count"):
                snap["compiles"] = step.compile_count
                snap["compile_cache_hits"] = step.cache_hits
            if self._prefix is not None:
                p = self._prefix.stats()
                snap["prefix_hits"] = p["hits"]
                snap["prefix_misses"] = p["misses"]
                snap["prefix_entries"] = p["entries"]
            if self._spec is not None:
                snap["spec_accept_ratio"] = self._spec.accept_ratio()
            return snap
