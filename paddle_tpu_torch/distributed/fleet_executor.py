"""FleetExecutor, the actor runtime (port of paddle_tpu/distributed/
fleet_executor.py).

Upstream's paddle/fluid/distributed/fleet_executor: a ``FleetExecutor``
(fleet_executor.h:31) builds a ``Carrier`` (carrier.h:34) of
``Interceptor`` actors (interceptor.h:35) wired by a ``TaskNode`` graph
(task_node.h), and a ``MessageBus`` (message_bus.h:40) carries their
InterceptorMessages (interceptor_message.proto) between ranks over brpc.

Here an actor is a thread with a queue for an inbox, one Carrier a
process. The bus delivers in the process by lookup (a payload is passed
as it is: a CUDA tensor stays on the card, and the threads' kernels queue
on the card's stream in the order the messages carry them) and across
processes as frames of the non-executable codec over TCP
(distributed/wire.py; a tensor arrives as its ndarray). A task's work is
any callable: a stage of a model, a captured step. The flow control is
upstream's credit protocol: DATA_IS_READY downstream, DATA_IS_USELESS
back upstream when a buffer slot frees, at most ``buffer_size`` payloads
in flight an edge.
"""
from __future__ import annotations

import queue
import socket
import socketserver
import threading

from ..framework.errors import FatalError
from .wire import read_frame_from, send_frame

__all__ = ["TaskNode", "Interceptor", "ComputeInterceptor", "Carrier",
           "MessageBus", "FleetExecutor"]


class _MsgType:
    DATA_IS_READY = "DATA_IS_READY"
    DATA_IS_USELESS = "DATA_IS_USELESS"   # downstream freed a buffer slot
    START = "START"
    STOP = "STOP"


class InterceptorMessage(dict):
    """interceptor_message.proto: {src_id, dst_id, message_type,
    payload}."""

    @staticmethod
    def make(src_id, dst_id, message_type, payload=None):
        return InterceptorMessage(src_id=src_id, dst_id=dst_id,
                                  message_type=message_type,
                                  payload=payload)


class TaskNode:
    """One schedulable task on a rank (task_node.h)."""

    def __init__(self, task_id, rank=0, fn=None, max_run_times=1,
                 buffer_size=2, role="compute"):
        self.task_id = task_id
        self.rank = rank
        self.fn = fn
        self.max_run_times = max_run_times   # e.g. the micro-batches
        self.buffer_size = buffer_size       # downstream credit
        self.role = role
        self.upstream = []                   # task ids
        self.downstream = []

    def add_upstream_task(self, task_id):
        if task_id not in self.upstream:
            self.upstream.append(task_id)

    def add_downstream_task(self, task_id):
        if task_id not in self.downstream:
            self.downstream.append(task_id)


class Interceptor(threading.Thread):
    """An actor with an inbox (interceptor.h); a subclass's ``handle``
    takes each message."""

    def __init__(self, interceptor_id, node, carrier):
        super().__init__(daemon=True, name=f"interceptor-{interceptor_id}")
        self.interceptor_id = interceptor_id
        self.node = node
        self.carrier = carrier
        self.inbox = queue.Queue()
        self._stopped = False

    def enqueue(self, msg):
        self.inbox.put(msg)

    def send(self, dst_id, message_type, payload=None):
        self.carrier.send(InterceptorMessage.make(
            self.interceptor_id, dst_id, message_type, payload))

    def run(self):
        while not self._stopped:
            msg = self.inbox.get()
            if msg["message_type"] == _MsgType.STOP:
                self._stopped = True
                break
            try:
                self.handle(msg)
            except Exception as e:  # the real error, raised by wait()
                self._stopped = True
                self.carrier.notify_error(e, self.interceptor_id)
                break

    def handle(self, msg):
        raise NotImplementedError


class ComputeInterceptor(Interceptor):
    """A dataflow actor on credits (compute_interceptor.cc): runs its
    task when every upstream has an input ready AND every downstream a
    free buffer slot, then sends DATA_IS_READY downstream and
    DATA_IS_USELESS upstream (the credit back)."""

    def __init__(self, interceptor_id, node, carrier):
        super().__init__(interceptor_id, node, carrier)
        self._pending_inputs = {u: queue.Queue() for u in node.upstream}
        self._credits = {d: node.buffer_size for d in node.downstream}
        self._run_count = 0
        self._lock = threading.Lock()

    def handle(self, msg):
        t = msg["message_type"]
        if t == _MsgType.START:
            pass
        elif t == _MsgType.DATA_IS_READY:
            self._pending_inputs[msg["src_id"]].put(msg["payload"])
        elif t == _MsgType.DATA_IS_USELESS:
            with self._lock:
                self._credits[msg["src_id"]] += 1
        self._maybe_run()

    def _ready(self):
        if self._run_count >= self.node.max_run_times:
            return False
        if any(q.empty() for q in self._pending_inputs.values()):
            return False
        with self._lock:
            return all(c > 0 for c in self._credits.values())

    def _maybe_run(self):
        while self._ready():
            inputs = {u: q.get() for u, q in self._pending_inputs.items()}
            if len(inputs) == 1:  # one upstream: its payload bare
                (inputs,) = inputs.values()
            out = self.node.fn(inputs) if self.node.fn else inputs
            self._run_count += 1
            for u in self.node.upstream:
                self.send(u, _MsgType.DATA_IS_USELESS)
            with self._lock:
                for d in self.node.downstream:
                    self._credits[d] -= 1
            for d in self.node.downstream:
                self.send(d, _MsgType.DATA_IS_READY, out)
            if self._run_count >= self.node.max_run_times:
                self.carrier.notify_task_done(self.node.task_id)


class _SourceInterceptor(Interceptor):
    """Feeds the micro-batches to the graph's roots
    (source_interceptor.cc)."""

    def __init__(self, interceptor_id, node, carrier, feeds):
        super().__init__(interceptor_id, node, carrier)
        self._feeds = list(feeds)
        self._credits = {d: node.buffer_size for d in node.downstream}
        self._sent = 0

    def handle(self, msg):
        # all its state changes on its own thread (by messages only)
        if msg["message_type"] == _MsgType.DATA_IS_USELESS:
            self._credits[msg["src_id"]] += 1
        self._pump()

    def _pump(self):
        while self._sent < len(self._feeds) and \
                all(c > 0 for c in self._credits.values()):
            payload = self._feeds[self._sent]
            self._sent += 1
            for d in self.node.downstream:
                self._credits[d] -= 1
                self.send(d, _MsgType.DATA_IS_READY, payload)
        if self._sent >= len(self._feeds):
            self.carrier.notify_task_done(self.node.task_id)


class _SinkInterceptor(Interceptor):
    """Collects the graph's outputs (sink_interceptor.cc)."""

    def __init__(self, interceptor_id, node, carrier):
        super().__init__(interceptor_id, node, carrier)
        self.results = []

    def handle(self, msg):
        if msg["message_type"] == _MsgType.DATA_IS_READY:
            self.results.append(msg["payload"])
            self.send(msg["src_id"], _MsgType.DATA_IS_USELESS)
            if len(self.results) >= self.node.max_run_times:
                self.carrier.notify_task_done(self.node.task_id)


class MessageBus:
    """Routes a message by its interceptor id (message_bus.h): in the
    process by enqueueing it, to another rank as a frame over TCP (a
    {rank: "host:port"} table)."""

    def __init__(self, rank=0, addr_table=None):
        self.rank = rank
        self.addr_table = addr_table or {}
        self._local = {}          # interceptor_id -> Interceptor
        self._id_to_rank = {}
        self._server = None

    def register(self, interceptor, rank=None):
        self._local[interceptor.interceptor_id] = interceptor
        self._id_to_rank[interceptor.interceptor_id] = \
            self.rank if rank is None else rank

    def route(self, interceptor_id, rank):
        self._id_to_rank[interceptor_id] = rank

    def send(self, msg):
        dst = msg["dst_id"]
        rank = self._id_to_rank.get(dst, self.rank)
        if rank == self.rank or rank is None:
            self._local[dst].enqueue(msg)
            return True
        host, port = self.addr_table[rank].rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=30) as s:
            send_frame(s, dict(msg))
        return True

    def serve(self, addr):
        """Listen at ``addr`` for other processes' messages."""
        host, port = addr.rsplit(":", 1)
        bus = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    try:
                        msg = read_frame_from(self.rfile)
                    except ValueError:
                        return  # a malformed or unverified frame: drop it
                    if msg is None:
                        return
                    if not isinstance(msg, dict) or "dst_id" not in msg:
                        return  # a frame of the wrong shape: drop the peer
                    local = bus._local.get(msg["dst_id"])
                    if local is not None:
                        local.enqueue(InterceptorMessage(msg))

        self._server = socketserver.ThreadingTCPServer(
            (host, int(port)), Handler)
        self._server.daemon_threads = True
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()

    def shutdown(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class Carrier:
    """This rank's interceptors (carrier.h): starts them and waits for
    the graph to finish."""

    def __init__(self, rank=0, message_bus=None):
        self.rank = rank
        self.bus = message_bus or MessageBus(rank)
        self.interceptors = {}
        self._done = set()
        self._all_tasks = set()
        self._done_cv = threading.Condition()
        self._error = None  # (exception, interceptor_id) of a dead actor

    def add_interceptor(self, interceptor):
        self.interceptors[interceptor.interceptor_id] = interceptor
        self.bus.register(interceptor)
        self._all_tasks.add(interceptor.node.task_id)
        return interceptor

    def send(self, msg):
        return self.bus.send(msg)

    def notify_task_done(self, task_id):
        with self._done_cv:
            self._done.add(task_id)
            self._done_cv.notify_all()

    def notify_error(self, exc, interceptor_id=None):
        """An actor's handle() raised: keep the error and wake wait() at
        once, rather than let it time out with the cause hidden."""
        with self._done_cv:
            if self._error is None:
                self._error = (exc, interceptor_id)
            self._done_cv.notify_all()

    def reset(self):
        """Ready for another run (upstream runs once a step): the
        completion state cleared; the caller registers interceptors
        anew."""
        with self._done_cv:
            self._done.clear()
            self._error = None

    def start(self):
        for it in self.interceptors.values():
            it.start()
        for it in self.interceptors.values():
            it.enqueue(InterceptorMessage.make(-1, it.interceptor_id,
                                               _MsgType.START))

    def wait(self, timeout=60):
        with self._done_cv:
            ok = self._done_cv.wait_for(
                lambda: self._error is not None
                or self._done >= self._all_tasks, timeout)
            err = self._error
        if err is not None:
            exc, iid = err
            raise FatalError(
                f"interceptor {iid} failed: {exc!r}") from exc
        if not ok:
            raise TimeoutError(
                f"carrier rank {self.rank}: tasks "
                f"{self._all_tasks - self._done} did not finish")

    def stop(self):
        for it in self.interceptors.values():
            it.enqueue(InterceptorMessage.make(-1, it.interceptor_id,
                                               _MsgType.STOP))
        for it in self.interceptors.values():
            it.join(timeout=5)


class FleetExecutor:
    """Wires TaskNodes into interceptors and runs micro-batched dataflow
    (fleet_executor.h:31)."""

    def __init__(self, task_nodes, rank=0, addr_table=None):
        self.nodes = {n.task_id: n for n in task_nodes}
        self.carrier = Carrier(rank, MessageBus(rank, addr_table))

    def run(self, feeds, timeout=60):
        """feeds: the payloads (micro-batches). Returns the sink's outputs
        in the order they completed. Each call resets the carrier and
        builds new interceptors, so it runs again. Only this rank's
        TaskNodes get interceptors here; the bus routes to other ranks'
        (``addr_table``)."""
        self.carrier.reset()
        rank = self.carrier.rank
        n_micro = len(feeds)
        roots = [n for n in self.nodes.values()
                 if not any(u in self.nodes for u in n.upstream)]
        leaves = [n for n in self.nodes.values()
                  if not any(d in self.nodes for d in n.downstream)]

        src_node = TaskNode("__source__", rank=rank,
                            max_run_times=n_micro)
        sink_node = TaskNode("__sink__", rank=rank,
                             max_run_times=n_micro * max(len(leaves), 1))
        for r in roots:
            src_node.add_downstream_task(r.task_id)
            r.add_upstream_task("__source__")
        for leaf in leaves:
            sink_node.add_upstream_task(leaf.task_id)
            leaf.add_downstream_task("__sink__")

        for node in self.nodes.values():
            node.max_run_times = n_micro
            if node.rank == rank:
                self.carrier.add_interceptor(
                    ComputeInterceptor(node.task_id, node, self.carrier))
            else:
                # a task of another rank: its id routes to that rank's bus
                self.carrier.bus.route(node.task_id, node.rank)
        src = _SourceInterceptor("__source__", src_node, self.carrier, feeds)
        sink = _SinkInterceptor("__sink__", sink_node, self.carrier)
        self.carrier.add_interceptor(src)
        self.carrier.add_interceptor(sink)

        self.carrier.start()  # the START message sets the source pumping
        try:
            self.carrier.wait(timeout)
        finally:
            self.carrier.stop()
            self.carrier.bus.shutdown()
        return sink.results
