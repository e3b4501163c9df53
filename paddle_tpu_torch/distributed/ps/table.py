"""The parameter server's tables (port of paddle_tpu/distributed/ps/
table.py).

A dense table is one parameter block with its update rule on the server
(upstream's common_dense_table.h); a sparse table maps ids to rows that
start lazily on their first pull (common_sparse_table.h). The rules are
the worker optimizers' own: sgd, adam, and sum (the geo-async rule, which
adds what it is pushed). Tables hold host numpy state in float32, as the
reference's do: a server is a host process.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["Table", "CommonDenseTable", "CommonSparseTable"]


class Table:
    def __init__(self, table_id, optimizer="sgd", lr=0.01):
        self.table_id = table_id
        self.optimizer = optimizer
        self.lr = lr
        self._lock = threading.Lock()

    def pull(self, *args):
        raise NotImplementedError

    def push(self, *args):
        raise NotImplementedError


class CommonDenseTable(Table):
    """One float32 block of ``shape``: zeros, or ``initializer``'s
    values."""

    def __init__(self, table_id, shape, optimizer="sgd", lr=0.01,
                 initializer=None):
        super().__init__(table_id, optimizer, lr)
        self.param = (np.zeros(shape, np.float32) if initializer is None
                      else np.asarray(initializer, np.float32).reshape(shape))
        if optimizer == "adam":
            self._m = np.zeros_like(self.param)
            self._v = np.zeros_like(self.param)
            self._t = 0

    def pull(self):
        with self._lock:
            return self.param.copy()

    def set(self, value):
        with self._lock:
            self.param[...] = value

    def push(self, grad):
        grad = np.asarray(grad, np.float32).reshape(self.param.shape)
        with self._lock:
            if self.optimizer == "sum":
                self.param += grad
            elif self.optimizer == "adam":
                self._t += 1
                self._m = 0.9 * self._m + 0.1 * grad
                self._v = 0.999 * self._v + 0.001 * grad * grad
                mhat = self._m / (1 - 0.9 ** self._t)
                vhat = self._v / (1 - 0.999 ** self._t)
                self.param -= self.lr * mhat / (np.sqrt(vhat) + 1e-8)
            else:  # sgd
                self.param -= self.lr * grad


class CommonSparseTable(Table):
    """id -> row of ``emb_dim`` float32; a row starts on its first pull
    (or push), drawn from N(0, 0.01^2) by one ``RandomState(seed)`` or as
    zeros.

    The draws follow the order in which requests arrive (ROADMAP
    C-ref-29, mirrored: one trainer's rows equal the reference's only
    so): with two trainers, which row gets which values depends on whose
    pull reaches the server first, and every pushed id draws a row too.
    A check against a serial model takes each row's values at its first
    pull."""

    def __init__(self, table_id, emb_dim, optimizer="sgd", lr=0.01,
                 initializer="normal", seed=0):
        super().__init__(table_id, optimizer, lr)
        self.emb_dim = emb_dim
        self.rows = {}
        self._rng = np.random.RandomState(seed)
        self._init = initializer

    def _init_row(self):
        if self._init == "zeros":
            return np.zeros(self.emb_dim, np.float32)
        return (self._rng.randn(self.emb_dim) * 0.01).astype(np.float32)

    def pull(self, ids):
        with self._lock:
            out = np.empty((len(ids), self.emb_dim), np.float32)
            for i, key in enumerate(ids):
                key = int(key)
                if key not in self.rows:
                    self.rows[key] = self._init_row()
                out[i] = self.rows[key]
            return out

    def push(self, ids, grads):
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.emb_dim)
        with self._lock:
            for key, g in zip(ids, grads):
                key = int(key)
                # a row is drawn for every pushed id, kept only for a new
                # one, as the reference does: the stream moves on a push
                row = self.rows.setdefault(key, self._init_row())
                if self.optimizer == "sum":
                    row += g
                else:
                    row -= self.lr * g

    def size(self):
        with self._lock:
            return len(self.rows)
