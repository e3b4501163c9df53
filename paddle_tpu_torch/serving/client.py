"""Client for the framed-socket serving frontend (port of
paddle_tpu/serving/client.py).

Speaks the :class:`~.server.SocketFrontend` protocol over the hardened
``distributed/wire.py`` codec: one request frame, one reply frame, per call.
Server-side errors come back typed — ``ServerOverloaded`` /
``DeadlineExceeded`` re-raise as themselves so client backoff logic can
``except ServerOverloaded`` without string matching; anything else raises
:class:`RemoteInferenceError` carrying the server's error type and message.

Overload behavior: a shed reply carries the server's ``retry_after`` hint
(the admission controller computes it from how far over the limit the
system is). :meth:`InferenceClient.infer` retries sheds itself with
**deadline-aware exponential backoff + full jitter** — each wait is the max
of the server hint and the jittered exponential term, capped so the retry
still fits inside the caller's ``timeout``. When the budget can't fit
another attempt the last ``ServerOverloaded`` is re-raised with
``retry_after`` set, so callers layering their own policy still see the
hint. Sleep and RNG are injectable for deterministic tests.

The frames are the reference's, byte for byte (``distributed/wire.py``), so
this client talks to either package's frontend. Inputs may be arrays or
tensors; a tensor on the card is copied to the host before it is framed.
"""
from __future__ import annotations

import random
import socket
import threading
import time

import numpy as np
import torch

from .batcher import DeadlineExceeded, ServerOverloaded

__all__ = ["InferenceClient", "RemoteInferenceError"]


class RemoteInferenceError(RuntimeError):
    """The server answered with an error frame this client can't map to a
    local exception type."""

    def __init__(self, error_type, message):
        super().__init__(f"{error_type}: {message}")
        self.error_type = error_type
        self.remote_message = message


# error_type values that round-trip to the caller as the real exception
_TYPED = {
    "ServerOverloaded": ServerOverloaded,
    "ResourceExhaustedError": ServerOverloaded,
    "DeadlineExceeded": DeadlineExceeded,
    "TimeoutError": DeadlineExceeded,
}


def _host(a):
    """``a`` on the host: a tensor as a contiguous CPU tensor (bf16 keeps
    its dtype, which the codec carries by name), anything else as a
    C-contiguous array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().contiguous()
    return np.ascontiguousarray(a)


class InferenceClient:
    """Blocking request/response client; thread-safe (one in-flight request
    per client at a time, serialized by a lock — run N clients for N-way
    concurrency, they're cheap).

    ``retries``/``backoff_base``/``backoff_cap`` govern the overload-retry
    loop; ``sleep``/``rng``/``clock`` exist so tests drive it with zero real
    sleeps and a seeded jitter.
    """

    def __init__(self, host, port=None, connect_timeout=10.0, retries=3,
                 backoff_base=0.05, backoff_cap=2.0, sleep=None, rng=None,
                 clock=None):
        if port is None:
            host, port = host  # accept the frontend's .address tuple
        self._addr = (host, int(port))
        self._connect_timeout = connect_timeout
        self.retries = int(retries)
        self.backoff_base = float(backoff_base)
        self.backoff_cap = float(backoff_cap)
        self._sleep = sleep if sleep is not None else time.sleep
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock if clock is not None else time.monotonic
        self._sock = None
        self._lock = threading.Lock()
        # model version stamped on the most recent successful reply (the
        # serving fleet's manifest seq; None = unstamped/launch weights)
        self.last_model_version = None

    def _conn(self):
        if self._sock is None:
            s = socket.create_connection(self._addr,
                                         timeout=self._connect_timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def backoff_delay(self, attempt, retry_after=None):
        """Wait before retry ``attempt`` (0-based): exponential with full
        jitter, floored at the server's ``retry_after`` hint — the server
        knows how overloaded it is better than our local guess does."""
        exp = min(self.backoff_cap, self.backoff_base * (2 ** attempt))
        jittered = self._rng.uniform(0.0, exp)
        return max(retry_after or 0.0, jittered)

    def infer(self, inputs, timeout=None, request_id=None, priority=0):
        """Run one request; returns the list of output arrays.

        ``timeout`` travels to the server as the request deadline AND bounds
        the socket wait (plus slack for one reply frame in flight) AND caps
        the total time spent across overload retries."""
        deadline = (self._clock() + timeout) if timeout is not None else None
        last = None
        for attempt in range(self.retries + 1):
            remaining = None if deadline is None \
                else max(0.0, deadline - self._clock())
            try:
                return self._infer_once(inputs, remaining, request_id,
                                        priority)
            except ServerOverloaded as e:
                last = e
            delay = self.backoff_delay(attempt,
                                       getattr(last, "retry_after", None))
            if attempt >= self.retries:
                break
            if deadline is not None and \
                    self._clock() + delay >= deadline:
                # the budget can't fit the wait plus another attempt:
                # surface the shed (with its hint) instead of burning the
                # caller's deadline on a doomed retry
                break
            self._sleep(delay)
        raise last

    @staticmethod
    def _trace_status(exc):
        if isinstance(exc, ServerOverloaded):
            return "shed"
        if isinstance(exc, DeadlineExceeded):
            return "deadline"
        return "error"

    def _infer_once(self, inputs, timeout, request_id, priority):
        from ..distributed import wire
        from ..profiler.tracing import get_tracer
        tracer = get_tracer()
        # client-minted trace: the id (and the submit span as parent) rides
        # the request frame via stamp_trace, so the server's spans land in
        # the same trace id on its side of the wire
        trace = tracer.start(request_id=request_id, kind="client",
                             priority=int(priority))
        sid = trace.begin_span("client.submit")
        frame = {"inputs": [_host(a) for a in inputs],
                 "timeout": timeout, "id": request_id}
        if priority:
            frame["priority"] = int(priority)
        wire.stamp_trace(frame, trace.ctx(sid))
        io_timeout = (timeout + 5.0) if timeout is not None else ...
        try:
            with self._lock:
                sock = self._conn()
                try:
                    wire.send_frame(sock, frame, timeout=(
                        None if io_timeout is ... else io_timeout))
                    reply = wire.recv_frame(sock, timeout=(
                        ... if io_timeout is ... else io_timeout))
                except (wire.FrameError, ConnectionError, OSError):
                    self.close()   # desynced/dead socket: reconnect
                    raise
            if not isinstance(reply, dict):
                raise RemoteInferenceError("BadReply", repr(reply))
            self.last_model_version = wire.frame_model_version(reply)
            if reply.get("error") is not None:
                etype = reply.get("error_type", "RemoteError")
                exc = _TYPED.get(etype)
                if exc is not None:
                    err = exc(reply["error"])
                    hint = reply.get("retry_after")
                    if hint is not None:
                        err.retry_after = float(hint)
                    raise err
                raise RemoteInferenceError(etype, reply["error"])
            # a bf16 output decodes to a torch tensor (numpy has no bf16)
            outputs = [o if isinstance(o, torch.Tensor) else np.asarray(o)
                       for o in reply["outputs"]]
        except BaseException as e:
            trace.end_span(sid)
            tracer.finish(trace, status=self._trace_status(e), error=e)
            raise
        trace.end_span(sid, version=self.last_model_version)
        tracer.finish(trace, status="ok")
        return outputs

    def generate(self, prompt, max_new_tokens=None, timeout=None,
                 request_id=None, priority=0):
        """Stream one generation: yields ``int`` tokens as the server emits
        them (seq-validated — a torn stream raises ``FrameError``, a typed
        server error raises as itself with any ``retry_after`` hint
        attached). Any error that escapes mid-stream — a replica retired
        under the stream (``ReplicaRetired``), a peer abort, a torn wire —
        carries ``tokens_delivered``, the count of tokens already yielded,
        so a caller can resume from ``prompt + received`` without
        re-reading what it has. The generator returns after the
        end-of-stream frame; ``timeout`` travels as the request deadline
        and bounds each frame wait. Holds the client's lock for the whole
        stream — use one client per concurrent stream."""
        from ..distributed import wire
        from ..profiler.tracing import get_tracer
        tracer = get_tracer()
        trace = tracer.start(request_id=request_id, kind="client",
                             priority=int(priority))
        sid = trace.begin_span("client.submit")
        frame = {"op": "generate", "id": request_id, "timeout": timeout,
                 "prompt": np.ascontiguousarray(
                     np.asarray(_host(prompt), dtype=np.int64).reshape(-1))}
        if max_new_tokens is not None:
            frame["max_new_tokens"] = int(max_new_tokens)
        if priority:
            frame["priority"] = int(priority)
        wire.stamp_trace(frame, trace.ctx(sid))
        io_timeout = (timeout + 10.0) if timeout is not None else ...
        reader = wire.StreamReader()
        delivered = 0
        try:
            with self._lock:
                sock = self._conn()
                try:
                    wire.send_frame(sock, frame, timeout=(
                        None if io_timeout is ... else io_timeout))
                    while True:
                        reply = wire.recv_frame(sock, timeout=(
                            ... if io_timeout is ... else io_timeout))
                        if not isinstance(reply, dict):
                            raise wire.FrameError(
                                "stream frame must be a dict, got "
                                f"{type(reply).__name__}")
                        _, end = reader.feed(reply)
                        if reply.get("error") is not None:
                            etype = reply.get("error_type", "RemoteError")
                            exc = _TYPED.get(etype)
                            if exc is None:
                                raise RemoteInferenceError(etype,
                                                           reply["error"])
                            err = exc(reply["error"])
                            hint = reply.get("retry_after")
                            if hint is not None:
                                err.retry_after = float(hint)
                            raise err
                        if end:
                            trace.end_span(sid, frames=reader.next_seq)
                            tracer.finish(trace, status="ok")
                            return
                        yield int(reply["token"])
                        delivered += 1
                except (wire.FrameError, ConnectionError, OSError):
                    self.close()   # desynced/torn stream: reconnect
                    raise
        except BaseException as e:
            # progress marker for resumption: how many tokens the caller
            # already holds when the stream died under it
            if not hasattr(e, "tokens_delivered"):
                try:
                    e.tokens_delivered = delivered
                except (AttributeError, TypeError):
                    pass  # exceptions with __slots__ can't carry it
            trace.end_span(sid, delivered=delivered)
            tracer.finish(trace, status=self._trace_status(e), error=e)
            raise

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
