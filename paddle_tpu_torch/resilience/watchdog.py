"""Distributed watchdog: deadlines on blocking sections + hang diagnostics.

Port of paddle_tpu/resilience/watchdog.py.

A multi-host job's worst failure mode is the silent hang: one rank dies (or
diverges) mid-collective and every survivor blocks forever in a recv. The
watchdog bounds that. Every eager collective, p2p send/recv/barrier, and the
elastic watch loop runs inside :func:`watch_section`, which registers a
deadline (``FLAGS_collective_timeout``) with a monitor. When a section blows
its deadline the monitor — once per section —

1. dumps the flight recorder (:mod:`.recorder`) to the artifacts dir,
2. dumps every thread's stack to ``thread_stacks_rank<N>.txt``,
3. marks this rank unhealthy via the registered health marker (the elastic
   store, when an :class:`ElasticManager` is registered), and
4. best-effort broadcasts a p2p abort so peers blocked on us fail in seconds,

and the section itself fails with a diagnostic :class:`DistributedTimeout`
(instead of a bare ``queue.Empty`` 300 s later). The monitor thread wakes
every ``FLAGS_watchdog_interval`` seconds; tests inject a fake clock and call
:meth:`Watchdog.poll` directly, so chaos coverage needs no real sleeps.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager

from . import recorder as _recorder

__all__ = ["DistributedError", "DistributedTimeout", "PeerAbort",
           "StaleGeneration", "Watchdog", "watch_section", "get_watchdog",
           "reset", "set_health_marker", "format_all_stacks"]


class DistributedError(RuntimeError):
    """Base for distributed failure diagnostics."""


class DistributedTimeout(DistributedError):
    """A watched section exceeded its deadline (or its transport timed out).

    Carries enough to debug without grepping logs: section name, rank,
    deadline, elapsed time, and where the flight recorder was dumped.
    """

    def __init__(self, section, rank, timeout, elapsed, dump_path=None,
                 detail=""):
        msg = (f"section '{section}' on rank {rank} exceeded its "
               f"{timeout:.1f}s deadline (elapsed {elapsed:.1f}s)")
        if dump_path:
            msg += f"; flight recorder dumped to {dump_path}"
        if detail:
            msg += f" [{detail}]"
        super().__init__(msg)
        self.section = section
        self.rank = rank
        self.timeout = timeout
        self.elapsed = elapsed
        self.dump_path = dump_path


class PeerAbort(DistributedError):
    """A peer announced its death: fail fast instead of idling out the
    full collective timeout."""

    def __init__(self, src, section="", reason=""):
        msg = f"rank {src} aborted in '{section or 'unknown'}'"
        if reason:
            msg += f": {reason}"
        super().__init__(msg)
        self.src = src
        self.section = section
        self.reason = reason


class StaleGeneration(DistributedError):
    """Traffic (or a blocked section's late result) from a previous
    incarnation of the collective group reached the current one.

    The recovery layer (:mod:`.recovery`) fences every re-rendezvous with a
    monotonic generation number; a rank still replaying generation ``g``
    after the survivors moved to ``g+1`` must fail fast with this error
    instead of corrupting or hanging the new group.
    """

    def __init__(self, stale_gen, current_gen, section="", src=None):
        msg = (f"stale generation {stale_gen}: the collective group is now "
               f"at generation {current_gen}")
        if section:
            msg += f" (section '{section}')"
        if src is not None:
            msg += f" [peer rank {src}]"
        super().__init__(msg)
        self.stale_gen = int(stale_gen)
        self.current_gen = int(current_gen)
        self.section = section
        self.src = src


def _current_generation():
    # lazy: recovery imports this module for the error taxonomy
    from .recovery import current_generation
    return current_generation()


def format_all_stacks():
    """Every thread's current stack, watchdog-dump style."""
    import sys
    import traceback
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        out.append(f"--- Thread {names.get(tid, '?')} (ident {tid}) ---")
        out.extend(line.rstrip("\n")
                   for line in traceback.format_stack(frame))
    return "\n".join(out)


def _flag(name, default):
    from ..framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


class _Section:
    __slots__ = ("name", "start", "timeout", "thread", "expired",
                 "dump_path")

    def __init__(self, name, start, timeout):
        self.name = name
        self.start = start
        self.timeout = timeout
        self.thread = threading.current_thread().name
        self.expired = False
        self.dump_path = None


class Watchdog:
    """Deadline monitor for blocking distributed sections.

    clock/recorder/artifacts are injectable for chaos tests. The production
    singleton (:func:`get_watchdog`) uses ``time.monotonic`` and spawns a
    daemon monitor thread; instances with an injected clock never spawn a
    thread — tests call :meth:`poll` to advance detection deterministically.
    """

    def __init__(self, clock=None, recorder=None, artifacts=None,
                 interval=None):
        self._clock = clock
        self._recorder = recorder
        self.artifacts = artifacts
        self._interval = interval
        self._sections = {}          # guarded-by: _lock
        self._lock = threading.Lock()
        self._health_marker = None   # guarded-by: _lock
        self._monitor = None         # guarded-by: _lock
        self._stop = threading.Event()  # guarded-by: _lock (the reference:
        #                               _ensure_monitor re-arms it)

    # -- plumbing ----------------------------------------------------------
    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.monotonic()

    def recorder(self):
        return self._recorder or _recorder.get_recorder()

    def set_health_marker(self, fn):
        """fn(section_name) called once per expired section — e.g. write an
        `unhealthy.<rank>` key into the elastic store."""
        with self._lock:
            self._health_marker = fn

    # -- section lifecycle -------------------------------------------------
    def register(self, name, timeout=None):
        if timeout is None:
            timeout = float(_flag("FLAGS_collective_timeout", 300.0))
        sec = _Section(name, self._now(), float(timeout))
        with self._lock:
            self._sections[id(sec)] = sec
        if self._clock is None:
            self._ensure_monitor()
        return sec

    def unregister(self, sec):
        with self._lock:
            self._sections.pop(id(sec), None)

    def active_sections(self):
        with self._lock:
            return list(self._sections.values())

    # -- expiry ------------------------------------------------------------
    def poll(self):
        """Check deadlines once; fire diagnostics for newly expired sections.
        Returns the sections that expired on this poll."""
        now = self._now()
        expired = []
        for sec in self.active_sections():
            if sec.expired or sec.timeout <= 0:
                continue
            if now - sec.start > sec.timeout:
                self._expire(sec, now)
                expired.append(sec)
        return expired

    def _expire(self, sec, now):
        sec.expired = True
        rec = self.recorder()
        try:
            sec.dump_path = rec.dump(reason=f"watchdog:{sec.name}")
        except OSError:
            pass
        self._dump_stacks(rec.rank)
        with self._lock:
            marker = self._health_marker
        if marker is not None:
            try:
                marker(sec.name)
            except Exception:
                pass  # diagnostics must not mask the hang itself
        # wake peers blocked on us: they get "rank N aborted in <section>"
        # within seconds instead of idling out their own deadline
        try:
            from ..distributed import p2p
            p2p.broadcast_abort(sec.name,
                                reason=f"watchdog deadline "
                                       f"({sec.timeout:.1f}s) exceeded")
        except Exception:
            pass

    def _dump_stacks(self, rank):
        base = self.artifacts or _recorder.artifacts_dir()
        try:
            os.makedirs(base, exist_ok=True)
            path = os.path.join(base, f"thread_stacks_rank{rank}.txt")
            with open(path, "w") as f:
                f.write(format_all_stacks() + "\n")
            return path
        except OSError:
            return None

    # -- monitor thread ----------------------------------------------------
    def _ensure_monitor(self):
        with self._lock:
            if self._monitor is not None and self._monitor.is_alive():
                return
            self._stop = threading.Event()
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="distributed-watchdog")
            self._monitor.start()

    def _monitor_loop(self):
        while True:
            interval = self._interval if self._interval is not None else \
                float(_flag("FLAGS_watchdog_interval", 5.0))
            with self._lock:
                stop = self._stop
            if stop.wait(max(interval, 0.05)):
                return
            self.poll()

    def stop(self):
        with self._lock:
            self._stop.set()


_WATCHDOG = [None]
_WD_LOCK = threading.Lock()


def get_watchdog():
    with _WD_LOCK:
        if _WATCHDOG[0] is None:
            _WATCHDOG[0] = Watchdog()
        return _WATCHDOG[0]


def reset():
    with _WD_LOCK:
        if _WATCHDOG[0] is not None:
            _WATCHDOG[0].stop()
        _WATCHDOG[0] = None


def set_health_marker(fn):
    """Install fn(section) on the global watchdog (ElasticManager.register
    points this at the elastic store's unhealthy key)."""
    get_watchdog().set_health_marker(fn)


@contextmanager
def watch_section(name, timeout=None, watchdog=None):
    """Deadline a blocking distributed section.

    - transport timeouts (``TimeoutError``, incl. socket/queue timeouts)
      surface as :class:`DistributedTimeout` naming the section;
    - if the monitor expired the section while the body was blocked, the
      section fails with :class:`DistributedTimeout` even if the body
      eventually returned — a post-deadline "success" already desynchronized
      the job (matches the NCCL-watchdog abort semantics);
    - :class:`PeerAbort`, :class:`DistributedTimeout` and
      :class:`StaleGeneration` raised inside pass through untouched
      (already diagnostic);
    - if the recovery layer re-rendezvoused to a NEW generation while the
      body was blocked, the section fails with :class:`StaleGeneration`
      even if the body eventually returned — a late "success" belongs to
      the dead incarnation and must not be committed into the new one.
    """
    wd = watchdog or get_watchdog()
    sec = wd.register(name, timeout=timeout)
    rank = wd.recorder().rank
    gen0 = _current_generation()
    try:
        yield sec
    except (DistributedTimeout, PeerAbort, StaleGeneration):
        raise
    except TimeoutError as e:
        elapsed = wd._now() - sec.start
        if not sec.expired:
            # transport beat the monitor to it: emit the same diagnostics
            wd._expire(sec, wd._now())
        raise DistributedTimeout(
            name, rank, sec.timeout, elapsed, dump_path=sec.dump_path,
            detail=str(e) or type(e).__name__) from e
    finally:
        wd.unregister(sec)
    if sec.expired:
        raise DistributedTimeout(name, rank, sec.timeout,
                                 wd._now() - sec.start,
                                 dump_path=sec.dump_path)
    gen1 = _current_generation()
    if gen1 != gen0:
        raise StaleGeneration(gen0, gen1, section=name)
