"""The legacy DistributeTranspiler (port of paddle_tpu/distributed/
transpiler.py).

Upstream's fluid/transpiler/distribute_transpiler.py rewrites a program
for the parameter server: it splits variables over the pservers, inserts
send and receive ops and emits a program a role. There is no program to
rewrite here: the classic calls (``transpile``, then a program a role)
map onto the ps package. Tables go to the pserver endpoints round robin,
in table order (the dense ones, then the sparse); a pserver's program is
its list of tables, a trainer's a ``TheOnePSRuntime`` on a client of
every endpoint, which knows each table's server.
"""
from __future__ import annotations

__all__ = ["DistributeTranspilerConfig", "DistributeTranspiler"]


class DistributeTranspilerConfig:
    """The knobs of upstream's config that still mean something here."""

    def __init__(self):
        self.slice_var_up = True       # kept for the API; tables are not
        self.min_block_size = 8192     # sliced at this scale
        self.split_method = "RoundRobin"
        self.sync_mode = True


class DistributeTranspiler:
    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()
        self._model = None
        self._pserver_eps = []
        self._trainer_id = 0
        self._trainers = 1
        self._assignment = {}   # table_id -> endpoint

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  model=None, sync_mode=None):
        """The classic signature; ``model`` (a Layer) stands for
        ``program``."""
        from .ps.runtime import _param_tables
        self._model = model if model is not None else program
        if self._model is None:
            raise ValueError("transpile needs the model (a Layer): there "
                             "is no program to rewrite")
        self._trainer_id = trainer_id
        self._trainers = trainers
        if sync_mode is not None:
            self.config.sync_mode = sync_mode
        self._pserver_eps = [e.strip() for e in pservers.split(",")
                             if e.strip()]
        if not self._pserver_eps:
            raise ValueError("pservers endpoint list is empty")
        dense, sparse = _param_tables(self._model)
        for i, (tid, _) in enumerate(list(dense) + list(sparse)):
            self._assignment[tid] = \
                self._pserver_eps[i % len(self._pserver_eps)]
        return self

    def get_pserver_program(self, endpoint, lr=0.01, server_optimizer="sgd"):
        """The tables this pserver serves (its 'program')."""
        from .ps.runtime import TheOnePSRuntime
        tables = TheOnePSRuntime.build_server_tables(
            self._model, lr=lr, server_optimizer=server_optimizer)
        return [t for t in tables
                if self._assignment.get(t.table_id) == endpoint]

    get_pserver_programs = get_pserver_program

    def get_trainer_program(self, lr=0.01, mode=None):
        """A TheOnePSRuntime driving this trainer's pulls and pushes."""
        from .ps.runtime import TheOnePSRuntime
        from .ps.service import PsClient
        client = PsClient(self._pserver_eps)
        idx = {tid: self._pserver_eps.index(ep)
               for tid, ep in self._assignment.items()}
        return TheOnePSRuntime(
            self._model, client, lr=lr,
            mode=mode or ("sync" if self.config.sync_mode else "async"),
            nranks=self._trainers, rank=self._trainer_id, assignment=idx)

    def table_assignment(self):
        return dict(self._assignment)
