"""The parameter server (port of paddle_tpu/distributed/ps/).

Upstream's paddle/fluid/distributed: the brpc ``PsService``, the tables
(common_dense_table.h, common_sparse_table.h), the asynchronous
``Communicator`` and Python's ``TheOnePSRuntime``
(fleet/runtime/the_one_ps.py). The servers hold host numpy state; the
trainers run their math on the card and exchange dense blocks and sparse
rows with the servers over the framed TCP codec (distributed/wire.py). An
``Embedding(sparse=True)``'s sparse gradient maps onto ``push_sparse``.
"""
from .communicator import Communicator
from .runtime import TheOnePSRuntime
from .service import PsClient, PsServer
from .table import CommonDenseTable, CommonSparseTable, Table

__all__ = ["Table", "CommonDenseTable", "CommonSparseTable", "PsServer",
           "PsClient", "Communicator", "TheOnePSRuntime"]
