"""The parameter server's RPC service (port of paddle_tpu/distributed/ps/
service.py).

Upstream's brpc_ps_server / brpc_ps_client: request and response keyed by
(command, table id). Here: the port's framed, non-executable codec over
TCP (distributed/wire.py; decoding a peer's bytes never runs code, an
optional HMAC with PADDLE_TPU_WIRE_SECRET), one thread a connection, a
loopback bind by default. The frames are the reference's, so a client of
either package talks to a server of the other. A torch tensor crosses the
wire as its ndarray (a bf16 one as its 16-bit words).
"""
from __future__ import annotations

import socket
import socketserver
import threading

from ...framework.errors import ExternalError
from ..wire import IdleTimeout
from ..wire import recv_frame as _recv_frame
from ..wire import send_frame as _send_frame

__all__ = ["PsServer", "PsClient"]

# a server-side barrier gives up after this many seconds; the caller's
# ``barrier`` then raises
BARRIER_TIMEOUT_S = 60


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class PsServer:
    """Serves its tables' commands (``pull_dense``, ``push_dense``,
    ``init_dense``, ``pull_sparse``, ``push_sparse``, ``stat``) and a
    barrier (the role of the reference's gloo HTTP store)."""

    def __init__(self, tables=None, host="127.0.0.1", port=0):
        self.tables = {t.table_id: t for t in (tables or [])}
        self._barrier_counts = {}
        self._barrier_cv = threading.Condition()
        server_self = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    while True:
                        try:
                            req = _recv_frame(self.request, idle_ok=True)
                        except IdleTimeout:
                            continue   # a quiet client: keep serving it
                        if not isinstance(req, dict):
                            return  # wrong shape: drop the peer
                        _send_frame(self.request, server_self._dispatch(req))
                except (ConnectionError, EOFError, ValueError, KeyError,
                        TypeError, OSError):
                    pass  # peer closed or sent a malformed/unverified frame

        self._server = _Server((host, port), Handler)
        self.host, self.port = self._server.server_address

    @property
    def endpoint(self):
        return f"{self.host}:{self.port}"

    def add_table(self, table):
        self.tables[table.table_id] = table

    def start(self):
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    def _dispatch(self, req):
        cmd = req["cmd"]
        try:
            if cmd == "pull_dense":
                return {"ok": True,
                        "value": self.tables[req["table_id"]].pull()}
            if cmd == "push_dense":
                self.tables[req["table_id"]].push(req["grad"])
                return {"ok": True}
            if cmd == "init_dense":
                self.tables[req["table_id"]].set(req["value"])
                return {"ok": True}
            if cmd == "pull_sparse":
                return {"ok": True,
                        "value": self.tables[req["table_id"]].pull(
                            req["ids"])}
            if cmd == "push_sparse":
                self.tables[req["table_id"]].push(req["ids"], req["grads"])
                return {"ok": True}
            if cmd == "barrier":
                return self._barrier(req["name"], req["nranks"])
            if cmd == "stat":
                return {"ok": True,
                        "tables": {tid: getattr(t, "size", lambda: None)()
                                   for tid, t in self.tables.items()}}
            return {"ok": False, "error": f"unknown cmd {cmd}"}
        except Exception as e:  # surfaced client-side as ExternalError
            return {"ok": False, "error": repr(e)}

    def _barrier(self, name, nranks):
        """A reusable barrier, counted by generation: the ``nranks``-th
        caller advances the generation and resets the count, so one name
        synchronizes every round (a step's, an epoch's)."""
        with self._barrier_cv:
            state = self._barrier_counts.setdefault(name, [0, 0])
            gen = state[1]
            state[0] += 1
            if state[0] >= nranks:
                state[0] = 0
                state[1] += 1
                self._barrier_cv.notify_all()
                return {"ok": True}
            ok = self._barrier_cv.wait_for(lambda: state[1] != gen,
                                           timeout=BARRIER_TIMEOUT_S)
        return {"ok": ok}


class PsClient:
    """One persistent connection a server; ``server`` picks the endpoint
    by its index (modulo their number)."""

    def __init__(self, endpoints):
        if isinstance(endpoints, str):
            endpoints = [endpoints]
        self.endpoints = list(endpoints)
        self._socks = {}
        self._lock = threading.Lock()

    def _sock(self, ep):
        if ep not in self._socks:
            host, port = ep.rsplit(":", 1)
            s = socket.create_connection((host, int(port)), timeout=60)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks[ep] = s
        return self._socks[ep]

    def _call(self, req, server=0):
        ep = self.endpoints[server % len(self.endpoints)]
        with self._lock:
            sock = self._sock(ep)
            _send_frame(sock, req)
            resp = _recv_frame(sock)
        if not resp.get("ok"):
            raise ExternalError(f"ps call {req['cmd']} failed: "
                                f"{resp.get('error')}")
        return resp

    # -- dense ------------------------------------------------------------
    def pull_dense(self, table_id, server=0):
        return self._call({"cmd": "pull_dense", "table_id": table_id},
                          server)["value"]

    def push_dense(self, table_id, grad, server=0):
        self._call({"cmd": "push_dense", "table_id": table_id,
                    "grad": grad}, server)

    def init_dense(self, table_id, value, server=0):
        self._call({"cmd": "init_dense", "table_id": table_id,
                    "value": value}, server)

    # -- sparse -----------------------------------------------------------
    def pull_sparse(self, table_id, ids, server=0):
        return self._call({"cmd": "pull_sparse", "table_id": table_id,
                           "ids": list(map(int, ids))}, server)["value"]

    def push_sparse(self, table_id, ids, grads, server=0):
        self._call({"cmd": "push_sparse", "table_id": table_id,
                    "ids": list(map(int, ids)), "grads": grads}, server)

    # -- control ----------------------------------------------------------
    def barrier(self, name, nranks, server=0):
        self._call({"cmd": "barrier", "name": name, "nranks": nranks},
                   server)

    def stat(self, server=0):
        return self._call({"cmd": "stat"}, server)["tables"]

    def close(self):
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        self._socks.clear()
