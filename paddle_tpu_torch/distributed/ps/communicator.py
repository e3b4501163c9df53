"""The asynchronous communicator (port of paddle_tpu/distributed/ps/
communicator.py).

Upstream's service/communicator.cc: a trainer queues its gradients; a
background thread merges (sums) what is pending a table and pushes it at
``send_interval`` (asynchronous SGD). ``flush`` sends what is queued on
the caller's thread and waits until the thread is idle.

Two repairs against the reference (ROADMAP C-ref-28, not mirrored). The
reference pushes every table to server 0, whatever the table assignment
says, so under a DistributeTranspiler with two pservers a table of server
1 fails on server 0; the failure kills the background thread silently,
the update is lost, and ``flush`` waits out its timeout. Here the pushes
follow ``assignment`` ({table id: server index}), and a push that failed
on the background thread is raised again, on the caller's thread, by the
next ``push_*``, ``flush`` or ``stop``.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["Communicator"]


class Communicator:
    def __init__(self, client, send_interval=0.05, merge_size=4,
                 assignment=None):
        self.client = client
        self.send_interval = send_interval
        self.merge_size = merge_size
        self._assignment = dict(assignment or {})
        self._q = queue.Queue()
        self._running = False
        self._thread = None
        self._idle = threading.Event()
        self._idle.set()
        self._error = None

    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ps-communicator")
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        if self._thread:
            self._q.put(None)  # wake
            self._thread.join(timeout=10)
        self.flush()

    # -- worker API --------------------------------------------------------
    def push_dense(self, table_id, grad):
        self._raise_pending()
        self._idle.clear()
        self._q.put(("dense", table_id, np.asarray(grad, np.float32)))

    def push_sparse(self, table_id, ids, grads):
        self._raise_pending()
        self._idle.clear()
        self._q.put(("sparse", table_id, (list(map(int, ids)),
                                          np.asarray(grads, np.float32))))

    def flush(self, timeout=30):
        """Send what is queued, on this thread, and wait until the
        background thread is idle (the sync-mode barrier point)."""
        pending = []
        try:
            while True:
                pending.append(self._q.get_nowait())
        except queue.Empty:
            pass
        self._send([p for p in pending if p is not None])
        if self._thread is None or not self._thread.is_alive():
            self._idle.set()
        self._idle.wait(timeout)
        self._raise_pending()

    # -- internals ---------------------------------------------------------
    def _raise_pending(self):
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _loop(self):
        while self._running:
            batch = []
            try:
                item = self._q.get(timeout=self.send_interval)
                if item is not None:
                    batch.append(item)
                while len(batch) < self.merge_size:
                    item = self._q.get_nowait()
                    if item is not None:
                        batch.append(item)
            except queue.Empty:
                pass
            try:
                self._send(batch)
            except Exception as e:  # noqa: BLE001 - raised on the caller
                if self._error is None:
                    self._error = e
            if self._q.empty():
                self._idle.set()

    def _send(self, batch):
        if not batch:
            return
        # dense gradients merged a table (the communicator's merge_add)
        dense = {}
        for kind, tid, payload in batch:
            if kind == "dense":
                dense[tid] = dense.get(tid, 0) + payload
            else:
                ids, grads = payload
                self.client.push_sparse(
                    tid, ids, grads, server=self._assignment.get(tid, 0))
        for tid, g in dense.items():
            self.client.push_dense(tid, g,
                                   server=self._assignment.get(tid, 0))
