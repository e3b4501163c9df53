"""The trainer's side of the parameter server (port of paddle_tpu/
distributed/ps/runtime.py).

Upstream's fleet/runtime/the_one_ps.py builds the tables from the
program, joins the trainers to the servers and drives the pull before a
step and the push after it. Here the tables come from the layer tree: an
``Embedding`` whose ``_sparse`` is set becomes a sparse table keyed by
token id, every other parameter a dense table, ``dense.{i}`` by its
place in ``model.parameters()``.

``step_begin`` pulls the dense tables and writes them into the
parameters in place (``p.data.copy_`` from the host buffer onto the
parameter's device; the reference rebinds its Tensor's value, which has no
torch meaning), and the batch's sparse rows into the embedding's weight
with an index copy on its device. ``step_end`` pushes each dense gradient
(taken to the host once a table) and the sparse gradient's rows and
values (``core.selected_rows.merge`` of the embedding's sparse COO
gradient).

Sync mode with more than one trainer meets at a barrier after the pulls
as well as after the pushes (ROADMAP C-ref-27, not mirrored). The
reference has only the second: a fast trainer then pushes step t's
gradients while a slow one is still pulling step t's tables, whose
gradient is then taken at mixed parameters. With both barriers, sync
PS with server SGD is SGD on the union of the trainers' batches.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .communicator import Communicator
from .table import CommonDenseTable, CommonSparseTable

__all__ = ["TheOnePSRuntime"]


def _param_tables(model):
    """(dense: [(table_id, param)], sparse: [(table_id, layer)])"""
    dense, sparse = [], []
    sparse_params = set()
    for name, layer in model.named_sublayers(include_self=True):
        if type(layer).__name__ == "Embedding" and getattr(layer, "_sparse",
                                                           False):
            sparse.append((f"sparse.{name or 'emb'}", layer))
            sparse_params.add(id(layer.weight))
    i = 0
    for p in model.parameters():
        if id(p) in sparse_params:
            continue
        dense.append((f"dense.{i}", p))
        i += 1
    return dense, sparse


def _host_f32(t):
    return t.detach().float().cpu().numpy()


class TheOnePSRuntime:
    def __init__(self, model, client, lr=0.01, mode="sync", nranks=1,
                 rank=0, server_optimizer="sgd", assignment=None):
        self.model = model
        self.client = client
        self.mode = mode
        self.nranks = nranks
        self.rank = rank
        self.lr = lr
        # table id -> server index (tables spread over pservers; default 0)
        self._assignment = assignment or {}
        self._dense, self._sparse = _param_tables(model)
        self._comm = None
        if mode == "async":
            self._comm = Communicator(client,
                                      assignment=self._assignment).start()
        self._last_sparse_ids = {}
        # the last step's seconds and bytes, by part (pull, barriers, push)
        self.last_step = {}

    def _server(self, tid):
        return self._assignment.get(tid, 0)

    # -- server bootstrap ---------------------------------------------------
    @staticmethod
    def build_server_tables(model, lr=0.01, server_optimizer="sgd"):
        """The server-side tables of this model's layout."""
        dense, sparse = _param_tables(model)
        tables = []
        for tid, p in dense:
            tables.append(CommonDenseTable(tid, tuple(p.shape),
                                           optimizer=server_optimizer,
                                           lr=lr))
        for tid, layer in sparse:
            tables.append(CommonSparseTable(tid, layer._embedding_dim,
                                            optimizer=server_optimizer,
                                            lr=lr))
        return tables

    def init_params(self):
        """Rank 0 seeds the dense tables from its initial values (upstream's
        init_worker / init_server handshake); every trainer then meets."""
        if self.rank == 0:
            for tid, p in self._dense:
                self.client.init_dense(tid, _host_f32(p),
                                       server=self._server(tid))
        self.client.barrier("init", self.nranks)

    # -- train-step hooks ---------------------------------------------------
    def step_begin(self, sparse_ids=None):
        """Pull the dense tables into the parameters, and the batch's
        sparse rows into the embeddings' weights. sparse_ids: {table id or
        a suffix of it: id array}."""
        t0 = time.perf_counter()
        pulled = 0
        with torch.no_grad():
            for tid, p in self._dense:
                value = self.client.pull_dense(tid, server=self._server(tid))
                pulled += value.nbytes
                p.data.copy_(torch.from_numpy(value).reshape(p.shape))
            for tid, layer in self._sparse:
                ids = None
                if sparse_ids is not None:
                    for key, v in sparse_ids.items():
                        if tid == key or tid.endswith(key):
                            ids = np.unique(np.asarray(
                                v.cpu() if isinstance(v, torch.Tensor)
                                else v).reshape(-1))
                if ids is None:
                    continue
                rows = self.client.pull_sparse(tid, ids,
                                               server=self._server(tid))
                pulled += rows.nbytes
                w = layer.weight
                w.data.index_copy_(
                    0, torch.from_numpy(ids.astype(np.int64)).to(w.device),
                    torch.from_numpy(rows).to(device=w.device,
                                              dtype=w.dtype))
                self._last_sparse_ids[tid] = ids
        t1 = time.perf_counter()
        if self.mode == "sync" and self.nranks > 1:
            # every trainer has pulled before any pushes (C-ref-27)
            self.client.barrier("pull", self.nranks)
        self.last_step = {"pull_s": t1 - t0,
                          "pull_barrier_s": time.perf_counter() - t1,
                          "pulled_bytes": pulled}

    def step_end(self):
        """Push the gradients: each dense one whole, the sparse one's rows
        and values."""
        from ...core import selected_rows
        t0 = time.perf_counter()
        pushed = 0
        for tid, p in self._dense:
            if p.grad is None:
                continue
            g = _host_f32(p.grad.to_dense() if p.grad.is_sparse else p.grad)
            pushed += g.nbytes
            if self._comm is not None:
                self._comm.push_dense(tid, g)
            else:
                self.client.push_dense(tid, g, server=self._server(tid))
        for tid, layer in self._sparse:
            g = layer.weight.grad
            if g is None:
                continue
            if g.is_sparse:
                merged = selected_rows.merge(g)
                ids = selected_rows.rows(merged).cpu().numpy()
                grads = _host_f32(selected_rows.value(merged))
            else:
                ids = self._last_sparse_ids.get(tid)
                if ids is None:
                    continue
                grads = _host_f32(g[torch.from_numpy(ids).to(g.device)])
            pushed += grads.nbytes
            if self._comm is not None:
                self._comm.push_sparse(tid, ids, grads)
            else:
                self.client.push_sparse(tid, ids, grads,
                                        server=self._server(tid))
        t1 = time.perf_counter()
        if self.mode == "sync" and self.nranks > 1:
            # every trainer has pushed before the next pull sees the
            # tables (the reusable server-side barrier)
            self.client.barrier("step", self.nranks)
        self.last_step.update(push_s=t1 - t0,
                              push_barrier_s=time.perf_counter() - t1,
                              pushed_bytes=pushed)

    def flush(self):
        if self._comm is not None:
            self._comm.flush()

    def stop(self):
        if self._comm is not None:
            self._comm.stop()
