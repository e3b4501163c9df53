"""Collective flight recorder: a per-process ring buffer of distributed ops.

Port of paddle_tpu/resilience/recorder.py, with the same entry and dump
format. The rank is ``distributed.env.get_rank()``. The signal hook
(``install_signal_dump``) is installed by ``init_parallel_env``.

Prior art: PyTorch's NCCL flight recorder and MegaScale's per-rank collective
tracing. Every eager collective and p2p op logs an entry — op name, group
axis, sequence number, shapes/dtypes, enter/exit timestamps, status — into a
bounded ring (``FLAGS_flight_recorder_size``). The ring is cheap enough to
leave always-on; its value is realized the day a multi-host job hangs:

- the watchdog (:mod:`.watchdog`) dumps the ring as JSON to the artifacts dir
  when a watched section blows its deadline,
- the failure path of an eager collective dumps it before aborting peers,

and ``tools/flight_recorder_diff.py`` then compares the per-rank dumps and
names the first (op, seq) pair where the ranks desynchronized — the culprit
collective — instead of leaving the operator with N identical "timed out"
stacks.

The clock is injectable so chaos tests drive deterministic timestamps with
no real sleeps.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
from contextlib import contextmanager

from ..distributed.env import get_rank

__all__ = ["FlightRecorder", "get_recorder", "reset", "artifacts_dir",
           "describe", "dump_path_for_rank"]


def artifacts_dir():
    """Where hang diagnostics land: flight-recorder dumps, thread stacks.

    Override with PADDLE_TPU_ARTIFACTS_DIR (the launcher reads the same
    variable to fold a failed rank's recorder tail into its error report).
    """
    return os.environ.get(
        "PADDLE_TPU_ARTIFACTS_DIR",
        os.path.join(tempfile.gettempdir(), "paddle_tpu_artifacts"))


def dump_path_for_rank(rank, base=None):
    return os.path.join(base or artifacts_dir(),
                        f"flight_recorder_rank{rank}.json")


def describe(value):
    """(shapes, dtypes) summary of a tensor / array / list thereof."""
    if value is None:
        return None, None
    vals = value if isinstance(value, (list, tuple)) else [value]
    shapes, dtypes = [], []
    for v in vals:
        shapes.append(list(getattr(v, "shape", ()) or ()))
        dtypes.append(str(getattr(v, "dtype", type(v).__name__)))
    return shapes, dtypes


class FlightRecorder:
    """Bounded, thread-safe ring of distributed-op trace entries."""

    def __init__(self, size=None, rank=None, clock=None, artifacts=None):
        if size is None:
            from ..framework.flags import get_flag
            size = int(get_flag("FLAGS_flight_recorder_size", 1024) or 1024)
        self.size = max(1, int(size))
        self.rank = get_rank() if rank is None else int(rank)
        self.artifacts = artifacts
        self._clock = clock  # None -> time.time at call sites
        self._entries = collections.deque(maxlen=self.size)
        self._seq = {}
        self._lock = threading.Lock()
        self._dumps = 0

    def _now(self):
        if self._clock is not None:
            return self._clock()
        import time
        return time.time()

    # -- recording ---------------------------------------------------------
    def start(self, op, group=None, seq=None, shapes=None, dtypes=None,
              peer=None):
        """Open an entry; returns it (a plain dict) for :meth:`finish`."""
        with self._lock:
            if seq is None:
                key = (op, group)
                seq = self._seq[key] = self._seq.get(key, 0) + 1
            entry = {"op": op, "group": group, "seq": int(seq),
                     "shapes": shapes, "dtypes": dtypes, "peer": peer,
                     "rank": self.rank, "t_start": self._now(),
                     "t_end": None, "status": "started"}
            self._entries.append(entry)
        return entry

    def finish(self, entry, status="ok"):
        entry["t_end"] = self._now()
        entry["status"] = status

    @contextmanager
    def record(self, op, **kw):
        """Context form: status becomes "ok" or the exception's type name.
        A thread that never exits the body leaves the entry "started" —
        exactly the signature flight_recorder_diff keys on for a hang."""
        entry = self.start(op, **kw)
        try:
            yield entry
        except BaseException as e:
            self.finish(entry, status=type(e).__name__)
            raise
        else:
            self.finish(entry, status="ok")

    # -- inspection --------------------------------------------------------
    def entries(self):
        with self._lock:
            return [dict(e) for e in self._entries]

    def tail(self, n=5):
        with self._lock:
            ents = list(self._entries)
        return [dict(e) for e in ents[-n:]]

    def __len__(self):
        return len(self._entries)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._seq.clear()

    # -- dumping -----------------------------------------------------------
    def dump(self, reason="", dir=None, extra=None):
        """Write the ring as JSON (atomically: tmp + os.replace) and return
        the path. Safe to call repeatedly — later dumps overwrite earlier
        ones, which is what you want when a timeout dump is followed by the
        final crash dump."""
        base = dir or self.artifacts or artifacts_dir()
        os.makedirs(base, exist_ok=True)
        path = dump_path_for_rank(self.rank, base)
        payload = {"version": 1, "rank": self.rank, "reason": reason,
                   "dumped_at": self._now(), "entries": self.entries()}
        try:
            # which incarnation this rank was in when it dumped — lets the
            # cross-rank diff separate "hung in gen g" from "stale rank
            # still replaying gen g-1"
            from .recovery import current_generation
            payload["generation"] = current_generation()
        except Exception:
            pass
        if extra:
            payload.update(extra)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
        with self._lock:
            self._dumps += 1
        return path

    @property
    def dump_count(self):
        return self._dumps


_RECORDER = [None]
_LOCK = threading.Lock()


def get_recorder():
    """Process-global recorder (lazy; sized from FLAGS at first use)."""
    with _LOCK:
        if _RECORDER[0] is None:
            _RECORDER[0] = FlightRecorder()
        return _RECORDER[0]


def reset():
    """Drop the global recorder (tests; also picks up resized FLAGS)."""
    with _LOCK:
        _RECORDER[0] = None



def install_signal_dump():
    """Register a flight-recorder dump as a preemption emergency action, so
    SIGTERM leaves a dump next to the emergency checkpoint. Idempotent."""
    from . import preempt
    h = preempt.get_handler() or preempt.install()
    if getattr(h, "_flight_dump_installed", False):
        return h
    h.add_action(lambda: get_recorder().dump(reason="sigterm"),
                 name="flight-recorder-dump")
    h._flight_dump_installed = True
    return h
