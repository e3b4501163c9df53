"""The parameter server of the PyTorch/CUDA port against the JAX
reference on the host.

Each case of the reference's tests/test_ps.py runs through both packages
on the same seeded numpy inputs and the results are compared: the tables'
update rules, the service's round trips, stat and errors (and a client of
each package against a server of the other, since the frames are the
same), the reusable barrier, the asynchronous communicator, the
DistributeTranspiler over two pservers, PS training of a sparse embedding
model, and a BERT of 2 layers at hidden 64 with a sparse word embedding
trained by one sync trainer for 3 steps (losses and tables within 1e-5,
f32). BERT-base's table list (ids and shapes) is the reference's.

The reference's faults on this path, each decided (ROADMAP):
- C-ref-27: two sync trainers in threads, one's pull held back until the
  other has pushed or waits at a barrier; the port (a barrier after the
  pulls) equals serial SGD on the union batch, the reference does not;
- C-ref-28: asynchronous pushes follow the table assignment, so async
  training over two pservers moves every table on both; a failed push
  is raised on the caller's thread; the reference's pushes go to server 0;
- C-ref-29 (mirrored): lazy sparse rows follow the order of arrival in
  both packages, a push drawing a row too.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed.ps as rps
import paddle_tpu.nn as rnn
import paddle_tpu.nn.functional as RF
from paddle_tpu.distributed.transpiler import \
    DistributeTranspiler as RefTranspiler

import paddle_tpu_torch as pt
import paddle_tpu_torch.distributed.ps as pps
import paddle_tpu_torch.nn as pnn
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu_torch.distributed.launch_utils import find_free_ports
from paddle_tpu_torch.distributed.transpiler import DistributeTranspiler
from paddle_tpu_torch.framework.errors import ExternalError

torch.set_num_threads(1)

PKGS = {"ref": rps, "port": pps}
F32 = dict(rtol=1e-5, atol=1e-6)
BERT_SMALL = dict(vocab_size=120, hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, max_position=64, dropout=0.0)


def _rng_arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype("float32") for s in shapes]


def _serve(mod, tables=()):
    return mod.PsServer(list(tables)).start()


# -- tables ------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["sgd", "adam", "sum"])
def test_dense_table_rules_equal_the_reference(rule):
    init, *grads = _rng_arrays(0, (2, 3), (2, 3), (2, 3), (2, 3))
    out = {}
    for name, mod in PKGS.items():
        t = mod.CommonDenseTable("d", (2, 3), optimizer=rule, lr=0.1)
        t.set(init)
        for g in grads:
            t.push(g)
        out[name] = t.pull()
    np.testing.assert_array_equal(out["port"], out["ref"])
    assert not np.array_equal(out["port"], init)


def test_dense_table_adam_moves_toward_descent():
    t = pps.CommonDenseTable("d", (4,), optimizer="adam", lr=0.1)
    t.set(np.zeros(4))
    for _ in range(10):
        t.push(np.ones(4))
    assert (t.pull() < 0).all()


def test_sparse_table_lazy_rows_and_updates_equal_the_reference():
    """C-ref-29 (mirrored): the same pulls and pushes give the same rows,
    a push drawing a row as the reference's does."""
    (g,) = _rng_arrays(1, (3, 4))
    out = {}
    for name, mod in PKGS.items():
        t = mod.CommonSparseTable("s", emb_dim=4, lr=1.0, seed=3)
        first = t.pull([5, 7])
        t.push([5, 7, 9], g)
        out[name] = (first, t.pull([5, 7, 9, 11]), t.size())
    for a, b in zip(out["port"], out["ref"]):
        np.testing.assert_array_equal(a, b)
    first, after, size = out["port"]
    assert size == 4
    np.testing.assert_allclose(after[:2], first - g[:2], atol=1e-6)


def test_sparse_rows_depend_on_the_order_of_arrival_in_both():
    """C-ref-29: which id gets which draw follows the pulls' order."""
    for mod in PKGS.values():
        a = mod.CommonSparseTable("s", emb_dim=3, seed=0)
        b = mod.CommonSparseTable("s", emb_dim=3, seed=0)
        ra = a.pull([1, 2])
        rb = b.pull([2, 1])
        np.testing.assert_array_equal(ra, rb)        # draw i to place i
        assert not np.array_equal(a.pull([1]), b.pull([1]))


def test_sparse_table_zeros_and_sum():
    (g,) = _rng_arrays(2, (2, 3))
    out = {}
    for name, mod in PKGS.items():
        t = mod.CommonSparseTable("s", emb_dim=3, optimizer="sum",
                                  initializer="zeros")
        t.push([4, 4], g)
        out[name] = t.pull([4])
    np.testing.assert_array_equal(out["port"], out["ref"])
    np.testing.assert_allclose(out["port"][0], g.sum(0), atol=1e-6)


# -- service -----------------------------------------------------------------

def _service_run(mod, client_mod):
    init, g = _rng_arrays(4, (3, 2), (3, 2))
    (sg,) = _rng_arrays(5, (1, 4))
    srv = _serve(mod, [mod.CommonDenseTable("w", (3, 2), lr=0.1),
                       mod.CommonSparseTable("emb", emb_dim=4)])
    try:
        c = client_mod.PsClient(srv.endpoint)
        c.init_dense("w", init)
        c.push_dense("w", g)
        dense = c.pull_dense("w")
        rows = c.pull_sparse("emb", [1, 9, 1])
        c.push_sparse("emb", [9], sg)
        stat = c.stat()
        after = c.pull_sparse("emb", [9])
        try:
            c.pull_dense("no_table")
            err = None
        except RuntimeError as e:
            err = str(e)
        c.close()
    finally:
        srv.stop()
    return dense, rows, stat, after, err


@pytest.mark.parametrize("server,client", [("port", "port"), ("ref", "port"),
                                           ("port", "ref")])
def test_service_round_trips_equal_the_reference(server, client):
    want = _service_run(rps, rps)
    got = _service_run(PKGS[server], PKGS[client])
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    dense, rows, stat, after, err = got
    np.testing.assert_array_equal(rows[0], rows[2])
    assert stat == want[2] == {"w": None, "emb": 2}
    np.testing.assert_array_equal(after, want[3])
    assert "no_table" in err and "pull_dense" in err


def test_error_propagates_as_external_error():
    srv = _serve(pps)
    try:
        c = pps.PsClient(srv.endpoint)
        with pytest.raises(ExternalError, match="no_table"):
            c.pull_dense("no_table")
        c.close()
    finally:
        srv.stop()


def _barrier_rounds(mod, rounds):
    """Each round: rank 1 blocks in the barrier until rank 2 arrives."""
    srv = _serve(mod)
    seen = []
    try:
        c1, c2 = mod.PsClient(srv.endpoint), mod.PsClient(srv.endpoint)
        for _ in range(rounds):
            done = []
            t = threading.Thread(
                target=lambda: (c1.barrier("epoch", 2), done.append(1)))
            t.start()
            # blocking-ok: negative check, the barrier must NOT release yet
            time.sleep(0.1)
            seen.append(list(done))
            c2.barrier("epoch", 2)
            t.join(timeout=5)
            seen.append(list(done))
        c1.close()
        c2.close()
    finally:
        srv.stop()
    return seen


def test_barrier_blocks_until_all_and_is_reusable():
    want = _barrier_rounds(rps, 3)
    assert _barrier_rounds(pps, 3) == want == [[], [1]] * 3


# -- communicator ------------------------------------------------------------

def _async_sum(mod):
    grads = _rng_arrays(6, *[(2,)] * 10)
    srv = _serve(mod, [mod.CommonDenseTable("w", (2,), optimizer="sum")])
    try:
        c = mod.PsClient(srv.endpoint)
        comm = mod.Communicator(c, send_interval=0.01).start()
        for g in grads:
            comm.push_dense("w", g)
        comm.flush()
        comm.stop()
        out = c.pull_dense("w")
        c.close()
    finally:
        srv.stop()
    return out, np.sum(grads, axis=0)


def test_communicator_merges_and_pushes_as_the_reference():
    got, total = _async_sum(pps)
    want, _ = _async_sum(rps)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, total, rtol=1e-5)


# -- models: the same weights in both packages -------------------------------

def _regression_models():
    paddle.seed(0)

    class Ref(rnn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = rnn.Embedding(20, 4, sparse=True)
            self.fc = rnn.Linear(4, 1)

        def forward(self, ids):
            return self.fc(self.emb(ids).mean(axis=1))

    class Port(pnn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = pnn.Embedding(20, 4, sparse=True, device="cpu")
            self.fc = pnn.Linear(4, 1, device="cpu")

        def forward(self, ids):
            return self.fc(self.emb(ids).mean(axis=1))
    ref = Ref()
    port = Port()
    pt.load_numpy_state_dict(port, {k: np.asarray(v._val)
                                    for k, v in ref.state_dict().items()})
    return ref, port


def _mlp_models():
    paddle.seed(0)
    ref = rnn.Sequential(rnn.Linear(4, 8), rnn.ReLU(), rnn.Linear(8, 1))
    port = pnn.Sequential(pnn.Linear(4, 8, device="cpu"), pnn.ReLU(),
                          pnn.Linear(8, 1, device="cpu"))
    pt.load_numpy_state_dict(port, {k: np.asarray(v._val)
                                    for k, v in ref.state_dict().items()})
    return ref, port


def _step(name, model, x, y):
    if name == "ref":
        out = model(paddle.to_tensor(x))
        loss = RF.mse_loss(out, paddle.to_tensor(y))
        loss.backward()
        return float(loss.numpy())
    out = model(torch.tensor(x))
    loss = PF.mse_loss(out, torch.tensor(y))
    loss.backward()
    return float(loss.detach())


def _clear(name, model):
    for p in model.parameters():
        if name == "ref":
            p.clear_gradient()
        else:
            p.grad = None


def test_ps_training_of_a_sparse_embedding_equals_the_reference():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 20, (16, 3)).astype("int64")
    target = (rng.randn(16, 1) * 0.1).astype("float32")
    losses, tables = {}, {}
    models = dict(zip(("ref", "port"), _regression_models()))
    for name, model in models.items():
        mod = PKGS[name]
        srv = _serve(mod, mod.TheOnePSRuntime.build_server_tables(model,
                                                                  lr=0.2))
        try:
            client = mod.PsClient(srv.endpoint)
            rt = mod.TheOnePSRuntime(model, client, lr=0.2, mode="sync")
            rt.init_params()
            losses[name] = []
            for _ in range(30):
                rt.step_begin(sparse_ids={"sparse.emb": ids})
                if name == "ref":
                    out = model(paddle.to_tensor(ids))
                    loss = RF.mse_loss(out, paddle.to_tensor(target))
                else:
                    out = model(torch.tensor(ids))
                    loss = PF.mse_loss(out, torch.tensor(target))
                loss.backward()
                rt.step_end()
                _clear(name, model)
                losses[name].append(float(np.asarray(
                    loss.numpy() if name == "ref" else loss.detach())))
            tables[name] = {"stat": client.stat(),
                            "rows": client.pull_sparse("sparse.emb",
                                                       range(20)),
                            "fc": client.pull_dense("dense.0")}
            rt.stop()
            client.close()
        finally:
            srv.stop()
    np.testing.assert_allclose(losses["port"], losses["ref"], **F32)
    assert losses["port"][-1] < 0.5 * losses["port"][0]
    assert tables["port"]["stat"] == tables["ref"]["stat"]
    assert tables["port"]["stat"]["sparse.emb"] <= 20
    for k in ("rows", "fc"):
        np.testing.assert_allclose(tables["port"][k], tables["ref"][k],
                                   **F32)


def _two_servers(mod, transpiler, eps, lr):
    servers = []
    for ep in eps:
        host, port = ep.rsplit(":", 1)
        servers.append(mod.PsServer(transpiler.get_pserver_program(ep, lr=lr),
                                    host=host, port=int(port)).start())
    return servers


def test_transpiler_over_two_pservers_equals_the_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(16, 4).astype("float32")
    y = (x.sum(axis=1, keepdims=True) * 0.3).astype("float32")
    models = dict(zip(("ref", "port"), _mlp_models()))
    losses, assign, final = {}, {}, {}
    for name, model in models.items():
        mod = PKGS[name]
        eps = [f"127.0.0.1:{p}" for p in find_free_ports(2)]
        t = (RefTranspiler if name == "ref" else DistributeTranspiler)()
        t.transpile(trainer_id=0, pservers=",".join(eps), trainers=1,
                    model=model)
        assign[name] = [eps.index(ep) for ep in
                        t.table_assignment().values()]
        servers = _two_servers(mod, t, eps, 0.1)
        try:
            rt = t.get_trainer_program(lr=0.1)
            rt.init_params()
            losses[name] = []
            for _ in range(20):
                rt.step_begin()
                losses[name].append(_step(name, model, x, y))
                rt.step_end()
                _clear(name, model)
            final[name] = [rt.client.pull_dense(tid, server=i)
                           for tid, i in rt._assignment.items()]
            rt.stop()
            rt.client.close()
        finally:
            for srv in servers:
                srv.stop()
    assert assign["port"] == assign["ref"] == [0, 1, 0, 1]
    np.testing.assert_allclose(losses["port"], losses["ref"], **F32)
    assert losses["port"][-1] < 0.5 * losses["port"][0]
    for a, b in zip(final["port"], final["ref"]):
        np.testing.assert_allclose(a, b, **F32)


# -- BERT --------------------------------------------------------------------

def _bert_pair(cfg):
    from paddle_tpu.text.models.bert import BertConfig as RefCfg
    from paddle_tpu.text.models.bert import \
        BertForSequenceClassification as RefBert

    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForSequenceClassification)
    paddle.seed(0)
    ref = RefBert(RefCfg(**cfg), num_classes=2)
    port = BertForSequenceClassification(BertConfig(**cfg), num_classes=2,
                                         device="cpu",
                                         generator=pt.make_generator(1))
    pt.load_numpy_state_dict(port, {k: np.asarray(v._val)
                                    for k, v in ref.state_dict().items()})
    for m in (ref, port):
        m.bert.embeddings.word_embeddings._sparse = True
    return ref, port


def test_bert_ps_sync_training_equals_the_reference():
    """A BERT of 2 layers at hidden 64, its word embedding a sparse table,
    trained by one sync trainer through one server for 3 steps: every
    loss and every table within 1e-5 of the reference's."""
    rng = np.random.RandomState(7)
    steps = [(rng.randint(0, BERT_SMALL["vocab_size"], (2, 16)),
              rng.randint(0, 2, (2,))) for _ in range(3)]
    models = dict(zip(("ref", "port"), _bert_pair(BERT_SMALL)))
    losses, tables = {}, {}
    for name, model in models.items():
        mod = PKGS[name]
        srv = _serve(mod, mod.TheOnePSRuntime.build_server_tables(model,
                                                                  lr=0.5))
        try:
            client = mod.PsClient(srv.endpoint)
            rt = mod.TheOnePSRuntime(model, client, lr=0.5)
            rt.init_params()
            losses[name] = []
            for ids, labels in steps:
                ids, labels = ids.astype("int64"), labels.astype("int64")
                rt.step_begin(sparse_ids={"word_embeddings": ids})
                if name == "ref":
                    loss = model(paddle.to_tensor(ids),
                                 labels=paddle.to_tensor(labels))
                else:
                    loss = model(torch.tensor(ids),
                                 labels=torch.tensor(labels))
                loss.backward()
                rt.step_end()
                _clear(name, model)
                losses[name].append(float(np.asarray(
                    loss.numpy() if name == "ref" else loss.detach())))
            seen = np.unique(np.concatenate([s[0].ravel() for s in steps]))
            tables[name] = {tid: client.pull_dense(tid)
                            for tid, _ in rt._dense}
            tables[name]["sparse"] = client.pull_sparse(
                "sparse.bert.embeddings.word_embeddings", seen)
            tables[name]["stat"] = client.stat()[
                "sparse.bert.embeddings.word_embeddings"]
            client.close()
        finally:
            srv.stop()
    np.testing.assert_allclose(losses["port"], losses["ref"], rtol=1e-5)
    assert sorted(tables["port"]) == sorted(tables["ref"])
    assert tables["port"]["stat"] == tables["ref"]["stat"] == len(seen)
    for tid, want in tables["ref"].items():
        np.testing.assert_allclose(tables["port"][tid], want, rtol=1e-5,
                                   atol=1e-5, err_msg=tid)


def test_bert_base_table_list_is_the_references():
    from paddle_tpu.distributed.ps.runtime import _param_tables as ref_tables
    from paddle_tpu.text.models.bert import BertConfig as RefCfg
    from paddle_tpu.text.models.bert import \
        BertForSequenceClassification as RefBert

    from paddle_tpu_torch.distributed.ps.runtime import _param_tables
    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForSequenceClassification)
    paddle.seed(0)
    ref = RefBert(RefCfg.base(), num_classes=2)
    port = BertForSequenceClassification(BertConfig.base(), num_classes=2,
                                         device="meta")
    lists = []
    for m, fn in ((ref, ref_tables), (port, _param_tables)):
        m.bert.embeddings.word_embeddings._sparse = True
        dense, sparse = fn(m)
        lists.append(([(tid, tuple(p.shape)) for tid, p in dense],
                      [(tid, layer._embedding_dim) for tid, layer in sparse]))
    assert lists[0] == lists[1]
    dense, sparse = lists[1]
    assert len(dense) == 200
    assert sparse == [("sparse.bert.embeddings.word_embeddings", 768)]


# -- C-ref-27: the sync step's barrier after the pulls -----------------------

class _Gate:
    """Trainer 1's first pull of each step waits until trainer 0 has
    pushed, or waits at a barrier (whichever comes first)."""

    def __init__(self, steps):
        self.events = [threading.Event() for _ in range(steps)]
        self.step = [0, 0]


def _gated_client(mod, ep, gate, rank):
    class Client(mod.PsClient):
        def pull_dense(self, table_id, server=0):
            if rank == 1 and table_id == "dense.0":
                gate.events[gate.step[1]].wait(10)
                gate.step[1] += 1
            return super().pull_dense(table_id, server)

        def barrier(self, name, nranks, server=0):
            if rank == 0 and name in ("pull", "step") and \
                    not gate.events[gate.step[0]].is_set():
                gate.events[gate.step[0]].set()
            if rank == 0 and name == "step":
                gate.step[0] += 1
            return super().barrier(name, nranks, server)
    return Client(ep)


def _two_sync_trainers(name, xs, ys, lr, steps):
    mod = PKGS[name]
    models = [_mlp_models()[0 if name == "ref" else 1] for _ in range(2)]
    srv = _serve(mod, mod.TheOnePSRuntime.build_server_tables(models[0],
                                                              lr=lr))
    gate = _Gate(steps)
    errors = []
    try:
        rts = [mod.TheOnePSRuntime(models[r],
                                   _gated_client(mod, srv.endpoint, gate, r),
                                   lr=lr, mode="sync", nranks=2, rank=r)
               for r in range(2)]

        def trainer(r):
            try:
                rts[r].init_params()
                for _ in range(steps):
                    rts[r].step_begin()
                    _step(name, models[r], xs[r], ys[r])
                    rts[r].step_end()
                    _clear(name, models[r])
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)
        threads = [threading.Thread(target=trainer, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        out = [rts[0].client.pull_dense(tid) for tid, _ in rts[0]._dense]
        for rt in rts:
            rt.client.close()
    finally:
        srv.stop()
    return out


def test_c_ref_27_two_sync_trainers_equal_serial_sgd_on_the_union_batch():
    lr, steps = 0.1, 2
    rng = np.random.RandomState(3)
    xs = [rng.randn(4, 4).astype("float32") for _ in range(2)]
    ys = [rng.randn(4, 1).astype("float32") for _ in range(2)]
    # serial: SGD(2 lr) on the union of the two batches, the same weights
    _, serial = _mlp_models()
    x, y = np.concatenate(xs), np.concatenate(ys)
    for _ in range(steps):
        _step("port", serial, x, y)
        with torch.no_grad():
            for p in serial.parameters():
                p -= 2 * lr * p.grad
        _clear("port", serial)
    want = [p.detach().numpy() for p in serial.parameters()]
    port = _two_sync_trainers("port", xs, ys, lr, steps)
    ref = _two_sync_trainers("ref", xs, ys, lr, steps)
    for got, w in zip(port, want):
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6)
    # the reference's slow trainer took its gradient at step-1 tables that
    # already held the fast trainer's update
    gap = max(np.abs(r - w).max() for r, w in zip(ref, want))
    assert gap > 1e-3, gap


# -- C-ref-28: asynchronous pushes and the table assignment ------------------

def test_c_ref_28_async_training_over_two_pservers_moves_every_table():
    rng = np.random.RandomState(1)
    x = rng.randn(8, 4).astype("float32")
    y = rng.randn(8, 1).astype("float32")
    _, model = _mlp_models()
    eps = [f"127.0.0.1:{p}" for p in find_free_ports(2)]
    t = DistributeTranspiler()
    t.transpile(trainer_id=0, pservers=",".join(eps), trainers=1,
                model=model, sync_mode=False)
    servers = _two_servers(pps, t, eps, 0.1)
    try:
        rt = t.get_trainer_program(lr=0.1)
        assert rt.mode == "async"
        rt.init_params()
        before = {tid: rt.client.pull_dense(tid, server=i)
                  for tid, i in rt._assignment.items()}
        for _ in range(2):
            rt.step_begin()
            _step("port", model, x, y)
            rt.step_end()
            _clear("port", model)
        rt.flush()
        moved = {tid: not np.array_equal(
            rt.client.pull_dense(tid, server=i), before[tid])
            for tid, i in rt._assignment.items()}
        rt.stop()
        rt.client.close()
    finally:
        for srv in servers:
            srv.stop()
    assert sorted(set(rt._assignment.values())) == [0, 1]
    assert all(moved.values()), moved


def test_c_ref_28_a_failed_background_push_raises_on_the_caller():
    srv = _serve(pps, [pps.CommonDenseTable("w", (2,), optimizer="sum")])
    try:
        c = pps.PsClient(srv.endpoint)
        comm = pps.Communicator(c, send_interval=0.01).start()
        comm.push_dense("missing", np.ones(2))
        # blocking-ok: let the background thread take the push and fail
        time.sleep(0.3)
        with pytest.raises(ExternalError, match="missing"):
            comm.push_dense("w", np.ones(2))
        comm.push_dense("missing", np.ones(2))
        with pytest.raises(ExternalError, match="missing"):
            comm.flush(timeout=5)
        comm.push_dense("w", np.ones(2))
        comm.stop()
        np.testing.assert_array_equal(c.pull_dense("w"), np.ones(2))
        c.close()
    finally:
        srv.stop()


def test_c_ref_28_the_references_async_push_goes_to_server_0():
    """The reference's Communicator pushes a table of server 1 to server
    0, where it does not exist; the port's goes to server 1."""
    mods = {}
    for name, mod in PKGS.items():
        servers = [_serve(mod), _serve(mod, [mod.CommonDenseTable(
            "w", (2,), optimizer="sum")])]
        try:
            c = mod.PsClient([s.endpoint for s in servers])
            kw = {} if name == "ref" else {"assignment": {"w": 1}}
            comm = mod.Communicator(c, **kw)   # not started: flush sends
            comm.push_dense("w", np.ones(2))
            try:
                comm.flush(timeout=1)
                mods[name] = c.pull_dense("w", server=1).tolist()
            except RuntimeError as e:
                mods[name] = str(e)
            c.close()
        finally:
            for s in servers:
                s.stop()
    assert mods["port"] == [1.0, 1.0]
    assert "KeyError" in mods["ref"] and "'w'" in mods["ref"], mods["ref"]
