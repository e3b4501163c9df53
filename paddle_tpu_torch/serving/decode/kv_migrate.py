"""Fault-tolerant KV migration: the prefill→decode handoff, over the wire
(port of paddle_tpu/serving/decode/kv_migrate.py).

Disaggregated serving (serving/disagg.py) runs prefill on compute-class
replicas and decode on memory-class replicas, which means a stream's KV
cache must cross a replica boundary exactly once in its life. That transfer
is where a disaggregated deployment loses streams if it is sloppy, so this
module makes it a **two-phase handoff** with the same typed-or-complete
contract the decode engine gives replica death:

1. **export** — the prefill side snapshots the stream's backend KV state and
   serializes its :class:`~.kv_cache.BlockTable` pages as wire frames, each
   sequence-stamped (``stamp_stream``) and generation-fenced
   (``stamp_generation``) so the decode side can detect truncation,
   reordering, and a migration that raced a rendezvous;
2. **transfer** — every frame takes a real trip through the wire codec
   (``wire.decode(wire.encode(f))``) and through a generation-pinned
   :class:`~paddle_tpu_torch.distributed.wire.StreamReader`; a torn or fenced
   stream raises the codec's typed ``FrameError`` here, **before** the
   decode side has claimed anything;
3. **adopt** — the decode engine admits the stream via
   :meth:`~.engine.DecodeEngine.adopt`, which claims decode-side KV blocks
   *atomically or not at all*: shortage refuses with
   :class:`~.kv_cache.KVCacheExhausted` + ``retry_after`` and the caller
   still holds a perfectly good prefill-side copy;
4. **release** — only after adoption succeeds does the prefill side free its
   pages. Until then the prefill copy is the recovery source.

Every phase is journaled to the :class:`~paddle_tpu_torch.resilience.recovery.
RecoveryJournal` (``migration_export`` → ``migration_ack`` →
``migration_adopt`` → ``migration_release``; ``migration_aborted`` /
``migration_refused`` on the failure edges), so a post-mortem can say
exactly how far each handoff got. Infrastructure failures (prefill replica
death, torn wire, codec errors) surface as the typed
:class:`MigrationAborted` — the disagg controller's cue to fall back to
decode-side re-prefill via the replay path, losing nothing. Policy refusals
(``ServerOverloaded`` / ``KVCacheExhausted`` from the decode engine)
propagate as themselves: they are load, not damage.

Chaos sites ``kv.{export,transfer,adopt}`` make every edge drivable from
:mod:`paddle_tpu_torch.resilience.faults`; the 400-round chaos soak
leans on them. The backend snapshot the frames carry is host data
(``CompiledDecodeBackend`` keeps its KV rows on the host between steps).
"""
from __future__ import annotations

import time

from ...distributed import wire
from ...distributed.wire import (FrameError, StreamReader, stamp_generation,
                                 stamp_stream)
from ...resilience.faults import maybe_inject
from ...resilience.watchdog import DistributedError
from ..batcher import ServerOverloaded
from ..scheduler import ReplicaDead
from .kv_cache import KVCacheExhausted

__all__ = ["MigrationAborted", "KVMigrator"]


class MigrationAborted(DistributedError):
    """A prefill→decode KV handoff died of an infrastructure failure
    (replica death, torn wire, codec corruption) during ``phase``
    (``export`` / ``transfer`` / ``adopt``). The stream is NOT lost — the
    controller falls back to decode-side re-prefill (the engine's replay path)
    and releases the prefill-side pages with the dead replica. Policy
    refusals (overload, KV shortage) are *not* this error; they keep their
    own types and ``retry_after`` hints."""

    def __init__(self, stream_id, phase, reason):
        super().__init__(
            f"migration of {stream_id} aborted during {phase}: {reason}")
        self.stream_id = stream_id
        self.phase = phase
        self.reason = reason


class KVMigrator:
    """Executes two-phase KV handoffs for the disagg controller.

    Stateless across handoffs apart from the journal/clock it writes to;
    one migrator serves every (prefill, decode) pair. ``handoff`` objects
    (:class:`~paddle_tpu_torch.serving.disagg.Handoff`) carry the prefill-side
    artifacts: the stream id, prompt, the prefill :class:`BlockTable`,
    the backend KV snapshot, and the request trace the spans land on.
    """

    def __init__(self, journal=None, clock=None):
        self._journal = journal
        self._clock = clock or time.monotonic

    # -- journal / span plumbing ---------------------------------------------
    def _journal_event(self, event, handoff, **fields):
        if self._journal is not None:
            self._journal.record(event, stream=handoff.id, **fields)

    def _span(self, handoff, name, t0, **attrs):
        tr = getattr(handoff, "trace", None)
        if tr is not None:
            tr.record_span(name, t0, self._clock(), **attrs)

    # -- phase 1: export ------------------------------------------------------
    def export(self, handoff, generation=None):
        """Serialize the handoff's KV pages + backend snapshot as a stamped,
        fenced frame stream. Raises :class:`ReplicaDead` when the prefill
        side has no state left to ship (it died under us)."""
        t0 = self._clock()
        maybe_inject("kv.export", ReplicaDead)
        if handoff.state is None:
            raise ReplicaDead(
                f"{handoff.id}: prefill replica holds no KV state to export")
        frames = []
        pages = list(handoff.table.pages()) if handoff.table is not None \
            else []
        for k, (block, held) in enumerate(pages):
            # a shared (prefix-cache) page still crosses the wire exactly
            # once per migration — the flag tells the decode side this page
            # has other referents on the source, so the source-side release
            # below only detaches from it. The decode engine re-shares the
            # adopted prefix into its own radix index (engine.adopt), or
            # COW-materializes on first divergent write; either way no
            # per-referent re-export ever happens.
            rc = handoff.table.pool.refcount(block) \
                if hasattr(handoff.table.pool, "refcount") else 1
            frames.append({"op": "kv_page", "stream": handoff.id, "page": k,
                           "block": int(block), "tokens": int(held),
                           "shared": bool(rc > 1)})
        frames.append({"op": "kv_meta", "stream": handoff.id,
                       "fill_pos": int(handoff.fill_pos),
                       "prompt_len": len(handoff.prompt),
                       "state": handoff.state,
                       "tokens": [int(t) for t in handoff.tokens]})
        last = len(frames) - 1
        for seq, f in enumerate(frames):
            stamp_stream(f, seq, end=(seq == last))
            stamp_generation(f, generation)
        self._journal_event("migration_export", handoff,
                            pages=len(pages), frames=len(frames),
                            fill_pos=int(handoff.fill_pos))
        self._span(handoff, "migrate.export", t0, pages=len(pages),
                   frames=len(frames))
        return frames

    # -- phase 2: transfer ----------------------------------------------------
    def transfer(self, handoff, frames):
        """Push every frame through the real wire codec and a
        generation-pinned :class:`StreamReader`. Returns the reassembled
        ``kv_meta`` dict; any gap, duplicate, truncation, or
        newer-generation frame raises the codec's typed ``FrameError``."""
        t0 = self._clock()
        reader = StreamReader()
        meta = None
        pages = 0
        for f in frames:
            maybe_inject("kv.transfer", ConnectionError)
            g = wire.decode(wire.encode(f))
            reader.feed(g)
            if g.get("op") == "kv_meta":
                meta = g
            elif g.get("op") == "kv_page":
                pages += 1
        if not reader.ended or meta is None:
            raise FrameError(
                f"torn migration: {handoff.id} transfer ended after "
                f"{reader.next_seq} frames without the kv_meta end marker")
        self._journal_event("migration_ack", handoff, pages=pages,
                            generation=reader.generation)
        self._span(handoff, "migrate.transfer", t0, pages=pages,
                   generation=reader.generation)
        return meta

    # -- phase 3: adopt -------------------------------------------------------
    def adopt(self, handoff, meta, engine):
        """Admit the migrated stream into the decode engine. Claims decode
        blocks atomically or not at all — a shortage refuses typed
        (``KVCacheExhausted`` + ``retry_after``) with nothing held."""
        t0 = self._clock()
        maybe_inject("kv.adopt", ReplicaDead)
        if not hasattr(engine.backend, "adopt_state"):
            raise ReplicaDead(
                f"{handoff.id}: decode backend cannot adopt migrated state")
        stream = engine.adopt(
            handoff.prompt, fill_pos=int(meta["fill_pos"]),
            state=meta["state"], tokens=meta.get("tokens", ()),
            max_new_tokens=handoff.max_new_tokens,
            deadline=handoff.deadline, priority=handoff.priority,
            on_token=handoff.on_token, request_id=handoff.id,
            enqueued_at=handoff.enqueued_at, trace=handoff.trace)
        self._journal_event("migration_adopt", handoff,
                     fill_pos=int(meta["fill_pos"]))
        self._span(handoff, "migrate.adopt", t0,
                   fill_pos=int(meta["fill_pos"]))
        return stream

    # -- the orchestrated handoff --------------------------------------------
    def migrate(self, handoff, engine, generation=None):
        """Run the full export → ack → adopt → release sequence.

        On success the prefill-side pages are released and the adopted
        :class:`~.engine.DecodeStream` is returned. Infrastructure failures
        raise :class:`MigrationAborted` (journaled, prefill pages left for
        the caller to release with the replica); decode-side policy
        refusals propagate as their own types, with the prefill copy
        intact so the caller can retry or fall back.
        """
        phase = "export"
        try:
            frames = self.export(handoff, generation=generation)
            phase = "transfer"
            meta = self.transfer(handoff, frames)
            phase = "adopt"
            stream = self.adopt(handoff, meta, engine)
        except (ServerOverloaded, KVCacheExhausted) as e:
            # policy refusal, not damage: typed, retry_after attached,
            # nothing claimed on the decode side
            self._journal_event("migration_refused", handoff,
                                phase=phase, reason=type(e).__name__)
            raise
        except (ReplicaDead, FrameError, ConnectionError, OSError) as e:
            self._journal_event("migration_aborted", handoff,
                                phase=phase, reason=type(e).__name__)
            raise MigrationAborted(handoff.id, phase, str(e)) from e
        # phase 4: only now does the prefill side drop its copy
        if handoff.table is not None:
            handoff.table.release()
        self._journal_event("migration_release", handoff)
        return stream
