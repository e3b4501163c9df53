"""Eager cross-process point-to-point channel (port of
paddle_tpu/distributed/p2p.py).

A TCP mesh between the job's processes, framed by the non-executable wire
codec (``distributed/wire.py``; optional HMAC via PADDLE_TPU_WIRE_SECRET),
beside the process group. It carries:

  * ``send_obj``/``recv_obj`` and ``send_array``/``recv_array``: any
    plain data, arrays and tensors (a tensor on the card is copied to the
    host; bf16 travels as its 16-bit words);
  * the ``group_*`` collectives over a SUBSET of ranks, gathered to the
    subset's first rank over the wire and computed there in numpy. They
    return ndarrays of the input's dtype (float16 included); for a bf16
    or fp8 tensor, which numpy lacks, a host tensor of its dtype, as the
    reference returns an ml_dtypes array of it. Such an input is reduced
    in f32 and rounded once, where the reference's ml_dtypes sum rounds
    after each addition, so beyond two members a sum may differ from the
    reference's by an ulp;
  * ``broadcast_abort``: a rank that fails tells every peer, whose
    blocked ``recv`` then fails in seconds with ``PeerAbort``.

The rank and world come from ``distributed/env.py`` (the reference asks
JAX for its process index).

Endpoint resolution, in priority order:
  1. PADDLE_TPU_P2P_ENDPOINTS="host:port,host:port,..." (one per process)
  2. PADDLE_TRAINER_ENDPOINTS hosts, port shifted by
     PADDLE_TPU_P2P_PORT_OFFSET (default +317)
  3. single-host default: 127.0.0.1:(PADDLE_TPU_P2P_BASE_PORT, default
     29610+)rank

Ordering: one TCP connection per (src -> dst) direction; frames carry
(src, tag) and land in per-(src, tag) queues, so matched send/recv pairs
in program order meet. Frames are stamped with the collective generation
(``resilience/recovery.py``): a frame from an older generation is dropped
and its sender told, so a stale rank fails with ``StaleGeneration``
instead of hanging.
"""
from __future__ import annotations

import os
import queue
import socket
import threading
import time

import numpy as np
import torch

from ..resilience.faults import maybe_inject
from ..resilience.recorder import get_recorder
from ..resilience.watchdog import PeerAbort, StaleGeneration, watch_section
from . import wire

__all__ = ["send_obj", "recv_obj", "send_array", "recv_array",
           "group_all_reduce", "group_all_gather", "group_broadcast",
           "group_reduce_scatter",
           "group_alltoall", "group_barrier", "endpoints", "shutdown",
           "broadcast_abort", "PeerAbort", "StaleGeneration"]

_CONNECT_TIMEOUT = float(os.environ.get("PADDLE_TPU_P2P_CONNECT_TIMEOUT",
                                        "60"))
# reader threads wake this often even with no traffic, so a closing
# channel or an abort is noticed without a frame arriving
_READER_TIMEOUT = float(os.environ.get("PADDLE_TPU_P2P_READER_TIMEOUT", "30"))

_ABORT_TAG = "__abort__"
# generation-fence control frame: a receiver that drops a stale peer's
# frame answers with its own (higher) generation, so the stale rank fails
# fast with StaleGeneration instead of idling out its recv timeout
_STALE_TAG = "__stale__"
_ABORT_SENTINEL = object()


def _recv_timeout():
    """Deadline for one blocking recv: env override, else
    FLAGS_collective_timeout."""
    v = os.environ.get("PADDLE_TPU_P2P_RECV_TIMEOUT")
    if v is not None:
        return float(v)
    from ..framework.flags import get_flag
    return float(get_flag("FLAGS_collective_timeout", 300.0))


def _rank_world():
    from .env import get_rank, get_world_size
    return get_rank(), get_world_size()


def endpoints():
    """Resolved p2p endpoint list, one per process."""
    rank, world = _rank_world()
    exp = os.environ.get("PADDLE_TPU_P2P_ENDPOINTS")
    if exp:
        eps = [e.strip() for e in exp.split(",") if e.strip()]
        if len(eps) != world:
            raise ValueError(
                f"PADDLE_TPU_P2P_ENDPOINTS has {len(eps)} entries for "
                f"{world} processes")
        return eps
    tr = os.environ.get("PADDLE_TRAINER_ENDPOINTS")
    off = int(os.environ.get("PADDLE_TPU_P2P_PORT_OFFSET", "317"))
    if tr:
        eps = []
        for e in tr.split(","):
            host, port = e.strip().rsplit(":", 1)
            eps.append(f"{host}:{int(port) + off}")
        if len(eps) != world:
            # a silent localhost fallback would cross-wire peers of a
            # multi-host job with a stale endpoint list (elastic resize)
            raise ValueError(
                f"PADDLE_TRAINER_ENDPOINTS has {len(eps)} entries for "
                f"{world} processes; set PADDLE_TPU_P2P_ENDPOINTS explicitly")
        return eps
    base = int(os.environ.get("PADDLE_TPU_P2P_BASE_PORT", "29610"))
    return [f"127.0.0.1:{base + r}" for r in range(world)]


class _Channel:
    def __init__(self):
        self.rank, self.world = _rank_world()
        self.eps = endpoints()
        host, port = self.eps[self.rank].rsplit(":", 1)
        bind_host = "0.0.0.0" if host not in ("127.0.0.1", "localhost") \
            else host
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((bind_host, int(port)))
        self.listener.listen(max(8, self.world * 2))
        self.inbox = {}  # guarded-by: inbox_lock ((src, tag) -> Queue)
        self.inbox_lock = threading.Lock()
        self.out = {}    # guarded-by: out_lock (dst rank -> socket)
        self.out_lock = threading.Lock()
        self.closing = False
        self.aborts = {}  # src rank -> {"section", "reason", ...}
        self.abort_seen = threading.Event()
        # highest newer generation observed (None = not stale); sticky:
        # once the group moved on, every send/recv on this channel fails
        # with StaleGeneration until the channel is torn down
        self.stale = None
        # generation source; None -> the process-wide recovery generation
        # (tests emulate two ranks at different generations in a process)
        self._gen_fn = None
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="p2p-accept")
        t.start()

    # -- receive side ---------------------------------------------------------
    def _queue(self, src, tag):
        with self.inbox_lock:
            q = self.inbox.get((src, tag))
            if q is None:
                q = queue.Queue()
                self.inbox[(src, tag)] = q
            return q

    def _accept_loop(self):
        while not self.closing:
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            threading.Thread(target=self._reader, args=(conn,), daemon=True,
                             name="p2p-reader").start()

    def _reader(self, conn):
        try:
            while True:
                try:
                    frame = wire.recv_frame(conn, timeout=_READER_TIMEOUT,
                                            idle_ok=True)
                except wire.IdleTimeout:
                    # no traffic is normal; a timeout MID-frame is not (it
                    # raises FrameError and drops the connection)
                    if self.closing:
                        return
                    continue
                if not (isinstance(frame, dict) and "src" in frame
                        and "tag" in frame):
                    continue  # not ours; drop
                if frame["tag"] == _ABORT_TAG:
                    self._on_abort(int(frame["src"]),
                                   frame.get("payload") or {})
                    continue
                if frame["tag"] == _STALE_TAG:
                    self._on_stale(
                        int((frame.get("payload") or {}).get("gen", 0)),
                        src=int(frame["src"]))
                    continue
                fgen = wire.frame_generation(frame)
                mygen = self._gen()
                if fgen != mygen:
                    if fgen < mygen:
                        # a rank of an earlier incarnation replays its
                        # traffic at us: drop it and tell it where the
                        # group went (best effort: a gone peer's recv
                        # timeout still bounds it)
                        try:
                            self.send(int(frame["src"]), _STALE_TAG,
                                      {"gen": mygen},
                                      connect_timeout=min(
                                          5.0, _CONNECT_TIMEOUT))
                        except (ConnectionError, TimeoutError, OSError,
                                StaleGeneration):
                            pass
                    else:
                        # the group re-rendezvoused without us: WE are stale
                        self._on_stale(fgen, src=int(frame["src"]))
                    continue
                self._queue(int(frame["src"]), frame["tag"]).put(
                    frame.get("payload"))
        except (ConnectionError, OSError, wire.FrameError):
            conn.close()

    def _wake_all(self):
        with self.inbox_lock:
            queues = list(self.inbox.values())
        for q in queues:
            q.put(_ABORT_SENTINEL)

    def _on_abort(self, src, info):
        """A peer announced its failure: remember it and wake every blocked
        recv, so survivors fail in seconds, not at the queue timeout."""
        self.aborts[src] = info
        self.abort_seen.set()
        self._wake_all()

    def _abort_error(self):
        src = min(self.aborts)
        info = self.aborts[src]
        return PeerAbort(src, section=info.get("section", ""),
                         reason=info.get("reason", ""))

    def _raise_abort(self):
        raise self._abort_error()

    # -- generation fence -----------------------------------------------------
    def _gen(self):
        fn = self._gen_fn
        if fn is not None:
            return int(fn())
        from ..resilience.recovery import current_generation
        return current_generation()

    def _on_stale(self, newer, src=None):
        """The group moved to a newer generation without us: latch it and
        wake every blocked recv. A notice at or below the CURRENT
        generation is ignored: a delayed notice about traffic sent before
        this rank recovered must not poison a current channel."""
        if int(newer) <= self._gen():
            return
        self._stale_src = src
        self.stale = max(self.stale or 0, int(newer))
        self._wake_all()

    def _raise_stale(self):
        raise StaleGeneration(self._gen(), self.stale,
                              src=getattr(self, "_stale_src", None))

    # -- send side ------------------------------------------------------------
    def _sock_to(self, dst, connect_timeout=None):
        # connect OUTSIDE out_lock: holding it across the retry loop would
        # stall every concurrent send behind one slow dial
        with self.out_lock:
            s = self.out.get(dst)
            if s is not None:
                return s
        host, port = self.eps[dst].rsplit(":", 1)
        budget = _CONNECT_TIMEOUT if connect_timeout is None \
            else connect_timeout
        deadline = time.time() + budget
        last = None
        while time.time() < deadline:
            try:
                s = socket.create_connection((host, int(port)), timeout=10)
            except OSError as e:  # the peer's listener may not be up yet
                last = e
                time.sleep(0.1)
                continue
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self.out_lock:
                won = self.out.setdefault(dst, s)
            if won is not s:  # lost a connect race; keep the cached one
                try:
                    s.close()
                except OSError:
                    pass
            return won
        raise ConnectionError(
            f"p2p connect to rank {dst} ({self.eps[dst]}) failed: {last}")

    def _drop_sock(self, dst):
        with self.out_lock:
            s = self.out.pop(dst, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def send(self, dst, tag, payload, connect_timeout=None):
        if self.stale is not None and tag != _STALE_TAG:
            self._raise_stale()
        if dst == self.rank:
            self._queue(self.rank, tag).put(payload)
            return
        frame = wire.stamp_generation(
            {"src": self.rank, "tag": tag, "payload": payload},
            generation=self._gen())
        s = self._sock_to(dst, connect_timeout=connect_timeout)
        try:
            wire.send_frame(s, frame)
        except (ConnectionError, TimeoutError, OSError):
            # the cached socket died while idle (a peer restart): reconnect
            # ONCE and resend; the frame never reached the old wire, so
            # nothing is duplicated. A failure on the fresh socket means
            # the peer is gone; let it propagate.
            self._drop_sock(dst)
            s = self._sock_to(dst, connect_timeout=connect_timeout)
            wire.send_frame(s, frame)

    def recv(self, src, tag, timeout=None):
        if self.aborts:
            self._raise_abort()
        if self.stale is not None:
            self._raise_stale()
        t = _recv_timeout() if timeout is None else timeout
        try:
            v = self._queue(src, tag).get(timeout=t)
        except queue.Empty:
            raise TimeoutError(
                f"p2p recv from rank {src} tag {tag!r} timed out "
                f"after {t:.1f}s") from None
        if v is _ABORT_SENTINEL:
            if self.aborts:
                self._raise_abort()
            if self.stale is not None:
                self._raise_stale()
            raise ConnectionError("p2p channel aborted")
        return v

    def close(self):
        self.closing = True
        try:
            # shutdown wakes the thread blocked in accept(); a close alone
            # leaves the port listening until accept returns, and a channel
            # opened again in this process (a recovery) could not bind it
            self.listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.listener.close()
        except OSError:
            pass
        with self.out_lock:
            for s in self.out.values():
                try:
                    s.close()
                except OSError:
                    pass
            self.out.clear()


_CHAN = [None]
_CHAN_LOCK = threading.Lock()
_SEQ = {}


def _channel():
    with _CHAN_LOCK:
        if _CHAN[0] is None:
            _CHAN[0] = _Channel()
        return _CHAN[0]


def connect():
    """Open this rank's channel now (its listener up, so peers can reach
    it and its aborts), rather than at the first send or recv."""
    return _channel()


def shutdown():
    with _CHAN_LOCK:
        if _CHAN[0] is not None:
            _CHAN[0].close()
            _CHAN[0] = None
    _SEQ.clear()


def broadcast_abort(section, reason=""):
    """Announce this rank's failure to every peer (best effort, bounded).

    Peers blocked in ``recv`` then fail within seconds with "rank N
    aborted in <section>". Only an EXISTING channel is used: a rank that
    never opened it has no peers waiting on it. Returns how many peers
    were notified.
    """
    with _CHAN_LOCK:
        chan = _CHAN[0]
    if chan is None or chan.closing:
        return 0
    payload = {"section": section, "reason": reason, "rank": chan.rank}
    notified = 0
    for dst in range(chan.world):
        if dst == chan.rank:
            continue
        try:
            # a short connect budget: the exit path must not spend
            # _CONNECT_TIMEOUT per peer already dead
            chan.send(dst, _ABORT_TAG, payload,
                      connect_timeout=min(5.0, _CONNECT_TIMEOUT))
            notified += 1
        except (ConnectionError, TimeoutError, OSError, StaleGeneration):
            continue
    return notified


def peer_abort(wait=0.0):
    """The ``PeerAbort`` a peer announced on this rank's channel, waiting
    up to ``wait`` seconds for one to arrive; None without a channel or an
    abort. A collective whose transport failed asks this first: the peer
    that failed may have said so just before its sockets closed."""
    with _CHAN_LOCK:
        chan = _CHAN[0]
    if chan is None or chan.closing:
        return None
    if not chan.aborts and wait > 0:
        chan.abort_seen.wait(wait)
    return chan._abort_error() if chan.aborts else None


def _next_seq(key):
    # program order is the same on every participating process, so a
    # local per-key counter matches across peers
    _SEQ[key] = _SEQ.get(key, 0) + 1
    return _SEQ[key]


def _host(value):
    """A tensor as a host ndarray of its dtype (bf16 and fp8, which numpy
    lacks, widened to f32); anything else through np.asarray."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if _widened(t):
            t = t.float()
        return t.numpy()
    return np.asarray(value)


def _widened(value):
    return isinstance(value, torch.Tensor) and value.is_floating_point() \
        and (value.dtype == torch.bfloat16 or value.element_size() == 1)


def _narrowed(out, value):
    """A collective's result in the input's dtype: a widened bf16 or fp8
    input comes back as a host tensor of its dtype."""
    if _widened(value):
        return torch.from_numpy(np.ascontiguousarray(out)).to(value.dtype)
    return out


# -- p2p API -----------------------------------------------------------------

def send_obj(payload, dst, tag="p2p"):
    maybe_inject("p2p.send", ConnectionError)
    from ..resilience.recorder import describe
    seq = _next_seq(("s", dst, tag))
    shapes, dtypes = describe(payload)
    with watch_section(f"p2p.send[{tag}->{dst}]"):
        with get_recorder().record("p2p.send", group=tag, seq=seq, peer=dst,
                                   shapes=shapes, dtypes=dtypes):
            _channel().send(dst, (tag, seq), payload)


def recv_obj(src, tag="p2p", timeout=None):
    maybe_inject("p2p.recv", ConnectionError)
    from ..resilience.watchdog import DistributedTimeout
    seq = _next_seq(("r", src, tag))
    try:
        with watch_section(f"p2p.recv[{tag}<-{src}]", timeout=timeout):
            with get_recorder().record("p2p.recv", group=tag, seq=seq,
                                       peer=src):
                return _channel().recv(src, (tag, seq), timeout=timeout)
    except (TimeoutError, DistributedTimeout):
        # roll the counter back so a retry waits on the SAME slot: a
        # consumed seq would desynchronize the (src, tag) stream
        _SEQ[("r", src, tag)] -= 1
        raise


def send_array(arr, dst, tag="p2p"):
    """Send an ndarray or a tensor (a bf16 tensor as its 16-bit words;
    it arrives as a host tensor of its dtype)."""
    send_obj(arr if isinstance(arr, torch.Tensor) else np.asarray(arr), dst,
             tag=tag)


def recv_array(src, tag="p2p", timeout=None):
    out = recv_obj(src, tag=tag, timeout=timeout)
    if not isinstance(out, (np.ndarray, torch.Tensor)):
        raise TypeError(f"expected ndarray from rank {src}, got "
                        f"{type(out).__name__}")
    return out


# -- subgroup collectives (gather-to-root over the wire) ---------------------

def _root_exchange(value, ranks, tag, compute_per_rank):
    """Members send ``value`` to root=ranks[0]; root runs
    compute_per_rank(list_of_values) -> list aligned with ranks, and sends
    each member its slot. Returns this rank's slot."""
    chan = _channel()
    me = chan.rank
    root = ranks[0]
    seq = _next_seq(("g", tuple(ranks), tag))
    from ..resilience.recorder import describe
    shapes, dtypes = describe(value)
    with get_recorder().record(f"p2p.group.{tag}", group=str(tuple(ranks)),
                               seq=seq, shapes=shapes, dtypes=dtypes):
        if me == root:
            vals = [None] * len(ranks)
            vals[0] = np.asarray(value)
            for i, r in enumerate(ranks[1:], start=1):
                vals[i] = chan.recv(r, (tag, seq))
            outs = compute_per_rank(vals)
            for i, r in enumerate(ranks[1:], start=1):
                chan.send(r, (tag + ".out", seq), outs[i])
            return outs[0]
        chan.send(root, (tag, seq), np.asarray(value))
        return chan.recv(root, (tag + ".out", seq))


_REDUCE_NP = {"sum": lambda a: np.sum(a, axis=0),
              "max": lambda a: np.max(a, axis=0),
              "min": lambda a: np.min(a, axis=0),
              "prod": lambda a: np.prod(a, axis=0),
              "avg": lambda a: np.mean(a, axis=0)}


def group_all_reduce(value, ranks, op="sum"):
    def compute(vals):
        red = _REDUCE_NP[op](np.stack(vals))
        return [red.astype(np.asarray(vals[0]).dtype)] * len(vals)
    return _narrowed(_root_exchange(_host(value), list(ranks), f"ar.{op}",
                                    compute), value)


def group_broadcast(value, ranks, src):
    ranks = list(ranks)
    if src not in ranks:
        raise ValueError(f"broadcast src={src} is not a member of the "
                         f"group ranks {ranks}")
    # rotate so src is the root slot
    order = [src] + [r for r in ranks if r != src]

    def compute(vals):
        return [vals[0]] * len(vals)
    return _narrowed(_root_exchange(_host(value), order, "bc", compute),
                     value)


def group_all_gather(value, ranks):
    ranks = list(ranks)

    def compute(vals):
        stacked = np.stack([np.asarray(v) for v in vals])
        return [stacked] * len(vals)
    return _narrowed(_root_exchange(_host(value), ranks, "ag", compute),
                     value)


def group_reduce_scatter(value, ranks, op="sum"):
    ranks = list(ranks)
    n = len(ranks)
    v = _host(value)
    # validate on EVERY rank before exchanging: a root-only check would
    # leave the other members hanging until the recv timeout
    if v.shape[0] % n:
        raise ValueError(
            f"reduce_scatter dim0 ({v.shape[0]}) not divisible by "
            f"group size ({n})")

    def compute(vals):
        red = _REDUCE_NP[op](np.stack(vals))
        chunk = red.shape[0] // n
        return [red[i * chunk:(i + 1) * chunk] for i in range(n)]
    return _narrowed(_root_exchange(v, ranks, f"rs.{op}", compute), value)


def group_alltoall(value, ranks):
    ranks = list(ranks)
    n = len(ranks)

    def compute(vals):
        # vals[j][i] = rank j's chunk for rank i -> out[i][j]
        return [np.stack([np.asarray(vals[j])[i] for j in range(n)])
                for i in range(n)]
    v = _host(value)
    if v.shape[0] != n:
        raise ValueError(
            f"alltoall needs {n} chunks, got leading dim {v.shape[0]}")
    return _narrowed(_root_exchange(v, ranks, "a2a", compute), value)


def group_barrier(ranks):
    maybe_inject("p2p.barrier", ConnectionError)

    def compute(vals):
        return [np.zeros((), np.int32)] * len(vals)
    with watch_section(f"p2p.barrier{tuple(ranks)}"):
        _root_exchange(np.zeros((), np.int32), list(ranks), "bar", compute)
