"""Sparse row gradients (port of paddle_tpu/core/selected_rows.py).

The reference's SelectedRows is a (rows, value, height) triple: ``value``
row i belongs to table row ``rows[i]``, duplicate rows accumulate. The
port's sparse gradient is torch's own sparse COO tensor of shape
(height, ...), the one ``F.embedding(..., sparse=True)`` gives and
autograd accumulates: its indices are the rows, its values the value
block, and an uncoalesced tensor is one with duplicate rows.
``coalesce()`` is the reference's ``merge``. There is no wrapper class on
the gradient path: these functions are the reference's operations over
that tensor.
"""
from __future__ import annotations

import torch

__all__ = ["make", "rows", "value", "height", "to_dense", "merge", "add"]


def make(rows, value, height):
    """The sparse gradient whose ``value`` row i belongs to table row
    ``rows[i]`` of a ``height``-row table."""
    rows = torch.as_tensor(rows).reshape(1, -1).to(torch.int64)
    value = torch.as_tensor(value)
    return torch.sparse_coo_tensor(rows, value,
                                   (int(height), *value.shape[1:]))


def rows(g):
    """The table row of each value row (duplicates where uncoalesced)."""
    return g._indices()[0]


def value(g):
    """The value block, one row per entry of ``rows``."""
    return g._values()


def height(g):
    return g.shape[0]


def to_dense(g):
    return g.to_dense()


def merge(g):
    """Duplicate rows summed: unique, sorted rows (the reference's
    scatter::MergeAdd)."""
    return g.coalesce()


def add(a, b):
    """a + b: the concatenated rows of two sparse gradients (no merge),
    or a dense tensor where either is dense."""
    if a.is_sparse and b.is_sparse:
        if a.shape != b.shape:
            raise ValueError(f"sparse gradients of shapes {tuple(a.shape)} "
                             f"and {tuple(b.shape)} cannot be added")
        return torch.sparse_coo_tensor(
            torch.cat([a._indices(), b._indices()], 1),
            torch.cat([a._values(), b._values()]), a.shape)
    return (a.to_dense() if a.is_sparse else a) + \
        (b.to_dense() if b.is_sparse else b)
