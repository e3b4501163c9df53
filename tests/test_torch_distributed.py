"""Data parallelism of the PyTorch/CUDA port on the host, against numpy
oracles and the JAX reference.

Ranks are real processes joined by gloo (``init_parallel_env`` over a
free localhost port), each running this file as a script (``--worker``);
one spawn of 4 ranks and one of 2 carry every check, and the ranks write
their observations as JSON for the test process to compare:

- the collectives against numpy and against the reference's collectives
  traced in ``shard_map`` on a 4-device slice of its CPU mesh, with the
  same per-rank inputs; a subgroup of ranks 0 and 2 leaves ranks 1 and 3
  untouched (the reference's 3-rank expectations,
  tests/test_multiprocess.py:241-257);
- ``_c_identity``'s backward over 4 ranks sums the ranks' gradients: 28
  for the inputs 4, 6, 8, 10, against the math (ROADMAP C-ref-1);
- the fusion decisions agree across ranks whose timings are scripted
  apart (the table answers under a group), while each rank keeps its own
  tile; ranks whose batches differ in sequence length neither wait for
  each other nor build different graphs;
- 2-rank ``DataParallel`` on a 2-layer GPT (hidden 64) in f32 against the
  reference's serial steps on the global batch from the same weights;
  the Reducer's buckets, ``no_sync`` accumulation and a late delta (a
  tied weight accumulated again by a reentrant checkpoint's inner
  backward after its bucket flushed);
- ``margin_cross_entropy`` class-sharded over 2 ranks against the
  reference's unsharded loss;
- ``SyncBatchNorm`` over 2 ranks against the reference's BatchNorm on the
  global batch (ROADMAP C-ref-21);
- ``Model.fit`` at world size 2 against one process's fit.

The JAX reference is imported only by the test process, never by a rank.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
               max_position_embeddings=64, dropout=0.0)
GPT_STEPS, GPT_BATCH, GPT_SEQ = 3, 4, 32
UNEVEN_SEQ = (32, 24)                   # each rank's sequence length
C_IDENTITY_X = (4.0, 6.0, 8.0, 10.0)   # sum 28
MCE_ROWS, MCE_CLASSES = 6, 8            # classes split over 2 ranks
BN_SHAPE = (8, 3, 4, 4)                 # the global batch, split over 2
FIT_SAMPLES, FIT_BATCH = 32, 8          # FIT_BATCH per rank
F32 = dict(rtol=1e-5, atol=1e-6)


# -- the ranks -------------------------------------------------------------

def _world_checks(rank, world, out):
    """The 4-rank spawn: collectives, subgroup, c_identity, tuner."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.ops import autotune
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    out["all_reduce_sum"] = dist.all_reduce(t).tolist()
    out["all_reduce_max"] = dist.all_reduce(
        torch.full((4,), float(rank)), op=dist.ReduceOp.MAX).tolist()
    out["all_reduce_avg"] = dist.all_reduce(
        torch.full((2,), float(rank)), op=dist.ReduceOp.AVG).tolist()
    out["broadcast"] = dist.broadcast(
        torch.full((3,), float(rank * 10 + 7)), src=1).tolist()
    lst = []
    dist.all_gather(lst, torch.full((2,), float(rank)))
    out["all_gather"] = [x.tolist() for x in lst]
    out["reduce_scatter"] = dist.reduce_scatter(
        torch.arange(2 * world, dtype=torch.float32) + rank).tolist()
    out["alltoall"] = dist.alltoall(torch.tensor(
        [[rank * 10.0 + i] for i in range(world)])).reshape(-1).tolist()
    got = torch.zeros(2)
    src_list = [torch.full((2,), 100.0 + i) for i in range(world)]
    out["scatter"] = dist.scatter(got, src_list if rank == 0 else None,
                                  src=0).tolist()
    buf = torch.zeros(2, 2)
    if rank % 2 == 0:
        dist.send(torch.full((2, 2), rank + 1.0), dst=rank + 1)
    else:
        dist.recv(buf, src=rank - 1)
    out["recv"] = buf.tolist()
    dist.barrier()
    # a subgroup of ranks 0 and 2: ranks 1 and 3 stay as they are
    sub = dist.new_group([0, 2])
    out["sub_all_reduce"] = dist.all_reduce(
        torch.full((2,), float(rank)), group=sub).tolist()
    out["sub_broadcast"] = dist.broadcast(
        torch.full((2,), 100.0 * (rank + 1)), src=2, group=sub).tolist()
    lst = []
    dist.all_gather(lst, torch.full((1,), float(rank)), group=sub)
    out["sub_all_gather"] = [x.tolist() for x in lst]
    dist.barrier(group=sub)
    out["sub_rank"] = sub.rank
    # a 2 x 2 mesh: the data group shares the model coordinate, and the
    # model group the data one (ranks laid out row-major, as the
    # reference reshapes its devices)
    from paddle_tpu_torch.distributed import mesh as dmesh
    m = dmesh.build_mesh({"model": 2, "data": 2})
    out["mesh"] = [m.axis_names, dmesh.axis_degree("model"),
                   m.group("data").ranks, m.group("model").ranks,
                   dist.all_reduce(torch.full((1,), float(rank)),
                                   group=m.group("model")).tolist()]
    try:
        dmesh.shard_map(None, m, None, None)
    except NotImplementedError as err:
        out["shard_map"] = str(err)
    # C-ref-1: the backward of _c_identity sums over the group
    w = torch.ones(1, requires_grad=True)
    (collective._c_identity(w) * C_IDENTITY_X[rank]).sum().backward()
    out["c_identity_grad"] = w.grad.tolist()
    x = torch.full((2,), float(rank + 1), requires_grad=True)
    y = collective._mp_allreduce(x)
    y.sum().backward()
    out["mp_allreduce"] = [y.tolist(), x.grad.tolist()]
    # the tuner, each rank's timings scripted to pick another candidate: a
    # tile changes no autograd graph, so each rank keeps its own answer,
    # also at a signature no other rank asks for, and none waits
    times = ({"a": 1.0, "b": 2.0, "c": 3.0} if rank == 0
             else {"a": 3.0, "b": 2.0, "c": 1.0})
    calls = []

    def scripted(fn, args):
        calls.append(fn)
        return times[fn]
    tuner = autotune.Autotuner(
        cache_dir=os.path.join(os.environ["DIST_TMP"], f"cache{rank}"),
        measure_fn=scripted, searchable=lambda: True)
    out["tuned"] = [tuner.get("testop", sig, candidates=("a", "b", "c"),
                              build=lambda c: c, make_args=lambda: (),
                              fallback="b")
                    for sig in ("sig", f"s{256 * (rank + 1)}")]
    out["tuner_measured"] = len(calls) / tuner._rounds
    # a fusion decision changes the graph: the search asked for, rank 0
    # measuring the fused form faster and the others slower, every rank
    # takes the table's answer, and nothing is timed
    seen = []

    def fused(t):
        seen.append("fused")
        return torch.neg(t)

    def unfused(t):
        seen.append("unfused")
        return torch.abs(t)
    t_of = ({"fused": 1.0, "unfused": 2.0} if rank == 0
            else {"fused": 2.0, "unfused": 1.0})
    prev = autotune.set_tuner(autotune.Autotuner(
        cache_dir=os.path.join(os.environ["DIST_TMP"], f"fusion{rank}"),
        measure_fn=lambda fn, args: (fn(*args), t_of[seen[-1]])[1],
        searchable=lambda: True, fusion_search=True))
    autotune._POLICY_FALLBACK[("scripted_op2", "f32", "fwd_bwd")] = \
        "unfused"
    before = autotune.counters()["searches"]
    try:
        out["fusion_choice"] = [autotune.choose_fused(
            op, fused, unfused, (torch.zeros(3),))[1]
            for op in ("scripted_op", "scripted_op2")]
    finally:
        autotune.set_tuner(prev)
    out["fusion_searches"] = autotune.counters()["searches"] - before
    out["fusion_probes"] = len(seen)


def _gpt_steps(rank, world, out, arrays):
    """2-layer GPT under DataParallel: this rank's rows of each global
    batch, AdamW steps; the Reducer's buckets and flushes."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    xs, ys = _gpt_stream()
    per = GPT_BATCH // world
    model = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    pt.load_numpy_state_dict(model, arrays)
    dp = pt.DataParallel(model, comm_buffer_size=0.02,
                         last_comm_buffer_size=0.01)
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    losses, flushes = [], []
    for x, y in zip(xs, ys):
        f0 = dp._reducer.flushes
        loss = dp(torch.from_numpy(x[rank * per:(rank + 1) * per]),
                  labels=torch.from_numpy(y[rank * per:(rank + 1) * per]))
        loss.backward()
        flushes.append(dp._reducer.flushes - f0)
        opt.step()
        opt.clear_grad()
        g = loss.detach().reshape(1).clone()
        losses.append(pt.distributed.all_reduce(
            g, op=pt.distributed.ReduceOp.AVG).item())
    out["gpt_losses"] = losses
    out["gpt_buckets"] = len(dp._reducer.buckets)
    out["gpt_flushes"] = flushes
    out["gpt_weights"] = {k: v.detach().numpy().tolist()
                          for k, v in model.state_dict().items()}


def _uneven_sequences(rank, world, out, arrays):
    """One DataParallel step of the 2-layer GPT where the ranks' batches
    have different sequence lengths (an uneven last batch, per-rank
    padding), with the fusion search asked for and each rank's timings
    scripted apart: every fused op decides by the table on both ranks,
    the tile of each rank's own sequence length is its own, nothing
    blocks, and the reduced gradients are the same on both ranks."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import autotune
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    seq = UNEVEN_SEQ[rank]
    timed = []

    def scripted(fn, args):
        timed.append(fn)
        return {64: 1.0 + rank, 128: 2.0 - rank}[fn]
    prev = autotune.set_tuner(autotune.Autotuner(
        cache_dir=os.path.join(os.environ["DIST_TMP"], f"uneven{rank}"),
        measure_fn=scripted, searchable=lambda: True, fusion_search=True))
    before = autotune.counters()
    try:
        model = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
        pt.load_numpy_state_dict(model, arrays)
        dp = pt.DataParallel(model)
        xs, ys = _gpt_stream()
        loss = dp(torch.from_numpy(xs[0][rank:rank + 1, :seq]),
                  labels=torch.from_numpy(ys[0][rank:rank + 1, :seq]))
        loss.backward()
        out["uneven_tile"] = autotune.get_tuner().get(
            "flash_attention", fa._signature("fwd", GPT_CFG["num_heads"],
                                             seq, seq, 64, torch.bfloat16,
                                             True),
            candidates=(64, 128), build=lambda c: c, make_args=lambda: (),
            fallback=64)
    finally:
        autotune.set_tuner(prev)
    after = autotune.counters()
    out["uneven_counts"] = {k: after[k] - before[k] for k in
                            ("searches", "policy_fused", "policy_unfused")}
    out["uneven_timed"] = len(timed)
    out["uneven_grads"] = {k: p.grad.tolist()
                           for k, p in model.named_parameters()}


def _reducer_checks(rank, world, out):
    """no_sync accumulation, and a late delta: a tied weight accumulated
    again by a reentrant checkpoint's inner backward after its bucket
    flushed."""
    import paddle_tpu_torch as pt
    gen = torch.Generator().manual_seed(7)
    lin = torch.nn.Linear(4, 3)
    with torch.no_grad():
        lin.weight.copy_(torch.randn(3, 4, generator=gen))
        lin.bias.copy_(torch.randn(3, generator=gen))
    dp = pt.DataParallel(lin)
    xa, xb = _reducer_inputs(rank)
    with dp.no_sync():
        dp(xa).square().sum().backward()
    out["no_sync_local"] = lin.weight.grad.tolist()
    dp(xb).square().sum().backward()
    out["no_sync_then_sync"] = [lin.weight.grad.tolist(),
                                lin.bias.grad.tolist()]
    dp._reducer.detach()
    # the late delta
    p = torch.nn.Parameter(torch.randn(4, 4, generator=gen))
    q = torch.nn.Parameter(torch.randn(4, 4, generator=gen))
    holder = torch.nn.Module()
    holder.p, holder.q = p, q
    dpt = pt.DataParallel(holder, comm_buffer_size=1e-5,
                          last_comm_buffer_size=1e-5)
    x = _delta_input(rank).requires_grad_()
    h = torch.utils.checkpoint.checkpoint(lambda t: (t @ p).tanh(), x,
                                          use_reentrant=True)
    ((h @ q) @ p.t()).sum().backward()
    out["delta_grads"] = [p.grad.tolist(), q.grad.tolist()]
    out["delta_buckets"] = [len(b.params) for b in dpt._reducer.buckets]


def _margin_ce(rank, world, out):
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.nn.functional as F
    logits, labels = _mce_inputs()
    c = MCE_CLASSES // world
    mine = torch.tensor(logits[:, rank * c:(rank + 1) * c],
                        requires_grad=True)
    loss, soft = F.margin_cross_entropy(
        mine, torch.tensor(labels), group=dist.get_group(0),
        return_softmax=True)
    loss.backward()
    out["mce_loss"] = loss.item()
    out["mce_grad"] = mine.grad.tolist()
    out["mce_softmax"] = soft.tolist()
    # ROADMAP C9: the reference's form, a mesh axis name, on {"model": 2}
    from paddle_tpu_torch.distributed import mesh as dmesh
    prev = dmesh.get_mesh()
    dmesh.build_mesh({"model": world})
    try:
        mine = torch.tensor(logits[:, rank * c:(rank + 1) * c],
                            requires_grad=True)
        loss, soft = F.margin_cross_entropy(
            mine, torch.tensor(labels), group="model", return_softmax=True)
        loss.backward()
    finally:
        dmesh.set_mesh(prev)
    out["mce_axis"] = [loss.item(), mine.grad.tolist(), soft.tolist()]


def _sync_bn(rank, world, out, arrays):
    import paddle_tpu_torch as pt
    x_all, c_all = _bn_inputs()
    per = BN_SHAPE[0] // world
    bn = pt.nn.BatchNorm2D(BN_SHAPE[1], device="cpu")
    pt.load_numpy_state_dict(bn, arrays)
    net = pt.nn.SyncBatchNorm.convert_sync_batchnorm(
        pt.nn.Sequential(bn))
    dp = pt.DataParallel(net)
    x = torch.tensor(x_all[rank * per:(rank + 1) * per], requires_grad=True)
    y = dp(x)
    (y * torch.tensor(c_all[rank * per:(rank + 1) * per])).mean().backward()
    out["bn_y"] = y.tolist()
    out["bn_x_grad"] = x.grad.tolist()
    out["bn_param_grads"] = [bn.weight.grad.tolist(), bn.bias.grad.tolist()]
    out["bn_stats"] = [bn._mean.tolist(), bn._variance.tolist()]
    out["bn_type"] = type(net[0]).__name__


def _fit(rank, world, out):
    out["fit_losses"] = _fit_losses(FIT_BATCH)
    import paddle_tpu_torch as pt
    g = torch.tensor(out["fit_losses"])
    out["fit_losses"] = pt.distributed.all_reduce(
        g, op=pt.distributed.ReduceOp.AVG).tolist()


def _worker(world):
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()
    rank = dist.get_rank()
    out = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.env.backend()}
    if world == 4:
        _world_checks(rank, world, out)
    else:
        with open(os.path.join(os.environ["DIST_TMP"], "arrays.json")) as f:
            arrays = {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
                      for k, d in json.load(f).items()}
        _gpt_steps(rank, world, out, arrays["gpt"])
        _reducer_checks(rank, world, out)
        _uneven_sequences(rank, world, out, arrays["gpt"])
        _margin_ce(rank, world, out)
        _sync_bn(rank, world, out, arrays["bn"])
        _fit(rank, world, out)
    with open(os.path.join(os.environ["DIST_TMP"], f"rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


# -- inputs, shared by the ranks and the test process ------------------------

def _gpt_stream():
    rng = np.random.RandomState(3)
    xs = rng.randint(0, GPT_CFG["vocab_size"],
                     (GPT_STEPS, GPT_BATCH, GPT_SEQ)).astype("int32")
    ys = rng.randint(0, GPT_CFG["vocab_size"],
                     (GPT_STEPS, GPT_BATCH, GPT_SEQ)).astype("int64")
    return xs, ys


def _reducer_inputs(rank):
    rng = np.random.RandomState(10 + rank)
    return (torch.tensor(rng.randn(5, 4).astype("float32")),
            torch.tensor(rng.randn(5, 4).astype("float32")))


def _delta_input(rank):
    return torch.tensor(np.random.RandomState(20 + rank).randn(3, 4)
                        .astype("float32"))


def _mce_inputs():
    rng = np.random.RandomState(4)
    logits = np.tanh(rng.randn(MCE_ROWS, MCE_CLASSES)).astype("float32")
    return logits, rng.randint(0, MCE_CLASSES, MCE_ROWS).astype("int64")


def _bn_inputs():
    rng = np.random.RandomState(5)
    return (rng.randn(*BN_SHAPE).astype("float32"),
            rng.randn(*BN_SHAPE).astype("float32"))


def _fit_losses(batch):
    """Model.fit of a small MLP (SGD) over FIT_SAMPLES samples: every
    step's loss (this rank's, at world size > 1)."""
    import paddle_tpu_torch as pt
    rng = np.random.RandomState(6)
    xs = rng.randn(FIT_SAMPLES, 8).astype("float32")
    ys = rng.randint(0, 3, (FIT_SAMPLES, 1)).astype("int64")
    gen = pt.make_generator(9)
    net = pt.nn.Sequential(pt.nn.Linear(8, 16, device="cpu",
                                        generator=gen),
                           pt.nn.ReLU(),
                           pt.nn.Linear(16, 3, device="cpu",
                                        generator=gen))
    model = pt.Model(net).prepare(
        pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters()),
        pt.nn.CrossEntropyLoss())

    class Log(pt.callbacks.Callback):
        def __init__(self):
            super().__init__()
            self.losses = []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(float(logs["loss"][0]))
    log = Log()
    model.fit(pt.io.TensorDataset([xs, ys]), batch_size=batch, epochs=1,
              shuffle=False, verbose=0, callbacks=[log])
    assert type(model.network).__name__ == (
        "DataParallel" if pt.distributed.get_world_size() > 1
        else "Sequential")
    return log.losses


# -- the test process ------------------------------------------------------

def _spawn(world, tmp, timeout=240):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = {**os.environ, "PADDLE_TRAINER_ID": str(r),
               "PADDLE_TRAINERS_NUM": str(world),
               "PADDLE_COORDINATOR_ADDR": f"localhost:{port}",
               "DIST_TMP": str(tmp), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": REPO}
        procs.append(subprocess.Popen(
            [sys.executable, HERE, "--worker", str(world)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=timeout)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n" \
                                  f"{log[-3000:]}"
    res = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(4, tmp_path_factory.mktemp("dist4"))


def _ref_gpt():
    """The reference's 2-layer GPT: its initial weights and its serial
    AdamW steps on the global batch."""
    import paddle_tpu as paddle
    from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
    from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT
    paddle.seed(0)
    ref = RefGPT(RefConfig(**GPT_CFG))
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=ref.parameters())
    losses = []
    for x, y in zip(*_gpt_stream()):
        loss = ref(paddle.to_tensor(x), labels=paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    after = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    return arrays, losses, after


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    import paddle_tpu as paddle
    tmp = tmp_path_factory.mktemp("dist2")
    arrays, losses, after = _ref_gpt()
    bn = paddle.nn.BatchNorm2D(BN_SHAPE[1])
    bn_arrays = {k: np.asarray(v._val).tolist()
                 for k, v in bn.state_dict().items()}
    with open(os.path.join(tmp, "arrays.json"), "w") as f:
        json.dump({"gpt": {k: v.tolist() for k, v in arrays.items()},
                   "bn": bn_arrays}, f)
    return _spawn(2, tmp), (arrays, losses, after)


def _ref_collective(fn, per_rank):
    """The reference's collective ``fn(Tensor)`` traced in shard_map over a
    4-device "data" mesh, each device given its rank's input."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed.mesh import shard_map
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))

    def body(x):
        return fn(Tensor(x[0]))._value[None]
    out = shard_map(body, mesh, in_specs=P("data"), out_specs=P("data"),
                    check_rep=False)(np.stack(per_rank))
    return np.asarray(out)


def test_collectives_match_numpy_and_the_reference(four):
    from paddle_tpu.distributed import collective as RC
    world = 4
    base = np.arange(6, dtype="float32").reshape(2, 3)
    inputs = {
        "all_reduce_sum": ([base * (r + 1) for r in range(world)],
                           lambda t: RC.all_reduce(t)),
        "all_reduce_max": ([np.full(4, float(r), "float32")
                            for r in range(world)],
                           lambda t: RC.all_reduce(t, op=RC.ReduceOp.MAX)),
        "broadcast": ([np.full(3, r * 10.0 + 7, "float32")
                       for r in range(world)],
                      lambda t: RC.broadcast(t, src=1)),
        "reduce_scatter": ([np.arange(2 * world, dtype="float32") + r
                            for r in range(world)],
                           lambda t: RC.reduce_scatter(t))}
    for name, (per_rank, fn) in inputs.items():
        ref = _ref_collective(fn, per_rank)
        for r in range(world):
            np.testing.assert_allclose(four[r][name], ref[r], err_msg=name)
    # alltoall: chunk i of rank j goes to rank i (reference's layout too)
    ref = _ref_collective(lambda t: RC.alltoall(t), [
        np.asarray([[r * 10.0 + i] for i in range(world)], "float32")
        for r in range(world)])
    want_sum = sum(base * (r + 1) for r in range(world))
    full = sum(np.arange(2 * world, dtype="float32") + j
               for j in range(world))
    for r in range(world):
        res = four[r]
        assert res["backend"] == "gloo" and res["world"] == world
        np.testing.assert_allclose(res["alltoall"],
                                   np.asarray(ref[r]).reshape(-1))
        np.testing.assert_allclose(res["alltoall"],
                                   [j * 10.0 + r for j in range(world)])
        np.testing.assert_allclose(res["all_reduce_sum"], want_sum)
        np.testing.assert_allclose(res["all_reduce_max"], [3.0] * 4)
        np.testing.assert_allclose(res["all_reduce_avg"], [1.5] * 2)
        np.testing.assert_allclose(res["broadcast"], [17.0] * 3)
        np.testing.assert_allclose(res["all_gather"],
                                   [[float(i)] * 2 for i in range(world)])
        np.testing.assert_allclose(res["reduce_scatter"],
                                   full[r * 2:(r + 1) * 2])
        np.testing.assert_allclose(res["scatter"], [100.0 + r] * 2)
        want_recv = np.full((2, 2), float(r)) if r % 2 else np.zeros((2, 2))
        np.testing.assert_allclose(res["recv"], want_recv)


def test_subgroup_leaves_nonmembers_untouched(four):
    for r in (0, 2):
        np.testing.assert_allclose(four[r]["sub_all_reduce"], [2.0, 2.0])
        np.testing.assert_allclose(four[r]["sub_broadcast"], [300.0] * 2)
        np.testing.assert_allclose(four[r]["sub_all_gather"],
                                   [[0.0], [2.0]])
    for r in (1, 3):
        np.testing.assert_allclose(four[r]["sub_all_reduce"], [float(r)] * 2)
        np.testing.assert_allclose(four[r]["sub_broadcast"],
                                   [100.0 * (r + 1)] * 2)
        assert four[r]["sub_all_gather"] == []
        assert four[r]["sub_rank"] == -1
    assert [four[r]["sub_rank"] for r in (0, 2)] == [0, 1]


def test_mesh_axes_are_groups_of_ranks(four):
    for r in range(4):
        d, m = divmod(r, 2)
        names, degree, data, model, summed = four[r]["mesh"]
        assert names == ["data", "model"] and degree == 2
        assert data == [m, m + 2] and model == [2 * d, 2 * d + 1]
        assert summed == [4.0 * d + 1.0]
        # shard_map raises, naming what the reference's uses became
        for use in ("MoELayer", "sequence_parallel", "spmd_pipeline"):
            assert use in four[r]["shard_map"], four[r]["shard_map"]


def test_c_identity_backward_sums_against_the_math(four):
    """ROADMAP C-ref-1: every rank's gradient is the sum of the ranks'
    (4 + 6 + 8 + 10 = 28), where the reference's test expects the same
    and its SPMD backward does not sum."""
    assert sum(C_IDENTITY_X) == 28.0
    for r in range(4):
        assert four[r]["c_identity_grad"] == [28.0]
        # _mp_allreduce: forward the sum, backward the identity
        assert four[r]["mp_allreduce"] == [[10.0, 10.0], [1.0, 1.0]]


def test_tuner_decisions_agree_across_ranks(four):
    """Rank 0's scripted timings pick "a", the others' "c": a tile is each
    rank's own (and a signature only one rank asks for blocks nobody);
    the fusion decisions, which change the graph, are the table's on
    every rank, whatever each rank would measure."""
    assert [four[r]["tuned"] for r in range(4)] == \
        [["a", "a"]] + [["c", "c"]] * 3
    assert all(four[r]["tuner_measured"] == 6 for r in range(4))
    assert [four[r]["fusion_choice"] for r in range(4)] == \
        [["fused", "unfused"]] * 4
    assert all(four[r]["fusion_searches"] == 0
               and four[r]["fusion_probes"] == 0 for r in range(4))


# the weights after the steps: the key projection's bias has a gradient of
# 0 in exact arithmetic (softmax ignores a shift of a row), so AdamW turns
# its rounding into updates of up to lr (1e-3) a step in both packages;
# 1e-5 absolute is 1 % of one step
WEIGHT_TOL = dict(rtol=1e-5, atol=1e-5)


def test_data_parallel_gpt_follows_the_reference_serial_steps(two):
    res, (_, losses, after) = two
    for r in range(2):
        np.testing.assert_allclose(res[r]["gpt_losses"], losses, **F32)
        for name, value in res[r]["gpt_weights"].items():
            np.testing.assert_allclose(value, after[name], **WEIGHT_TOL,
                                       err_msg=name)
        # a small cap: several buckets, every one flushed from the hooks
        assert res[r]["gpt_buckets"] > 2
        assert res[r]["gpt_flushes"] == [res[r]["gpt_buckets"]] * GPT_STEPS


def test_reducer_no_sync_and_late_delta(two):
    res, _ = two
    xa = [_reducer_inputs(r)[0] for r in range(2)]
    xb = [_reducer_inputs(r)[1] for r in range(2)]
    gen = torch.Generator().manual_seed(7)
    w0 = torch.randn(3, 4, generator=gen)
    b0 = torch.randn(3, generator=gen)

    def grads(x):
        w = w0.clone().requires_grad_()
        b = b0.clone().requires_grad_()
        (x @ w.t() + b).square().sum().backward()
        return w.grad, b.grad
    for r in range(2):
        # inside no_sync each rank keeps its own gradient
        np.testing.assert_allclose(res[r]["no_sync_local"], grads(xa[r])[0],
                                   **F32)
        # the next synced backward averages the accumulated sums
        want_w = sum(grads(xa[q])[0] + grads(xb[q])[0] for q in range(2)) / 2
        want_b = sum(grads(xa[q])[1] + grads(xb[q])[1] for q in range(2)) / 2
        np.testing.assert_allclose(res[r]["no_sync_then_sync"][0], want_w,
                                   **F32)
        np.testing.assert_allclose(res[r]["no_sync_then_sync"][1], want_b,
                                   **F32)
    p0 = torch.randn(4, 4, generator=gen)
    q0 = torch.randn(4, 4, generator=gen)
    want = []
    for r in range(2):
        p = p0.clone().requires_grad_()
        q = q0.clone().requires_grad_()
        ((( _delta_input(r) @ p).tanh() @ q) @ p.t()).sum().backward()
        want.append((p.grad, q.grad))
    for r in range(2):
        assert res[r]["delta_buckets"] == [1, 1]
        np.testing.assert_allclose(res[r]["delta_grads"][0],
                                   (want[0][0] + want[1][0]) / 2, **F32)
        np.testing.assert_allclose(res[r]["delta_grads"][1],
                                   (want[0][1] + want[1][1]) / 2, **F32)


def test_ranks_with_different_sequence_lengths_neither_block_nor_split(
        two):
    """Review case: the ranks' batches differ in length, so their
    signatures differ. Nobody waits for another rank's decision; each
    fused op took the table's form on both ranks (the same graph, so the
    buckets pair up), the search timed only each rank's own tile, and the
    reduced gradients agree on both ranks."""
    res, _ = two
    counts = [res[r]["uneven_counts"] for r in range(2)]
    assert counts[0] == counts[1] and counts[0]["searches"] == 1, counts
    assert counts[0]["policy_fused"] + counts[0]["policy_unfused"] > 0
    assert [res[r]["uneven_timed"] for r in range(2)] == [10, 10]
    assert [res[r]["uneven_tile"] for r in range(2)] == [64, 128]
    g0, g1 = res[0]["uneven_grads"], res[1]["uneven_grads"]
    assert g0.keys() == g1.keys()
    for name in g0:
        assert g0[name] == g1[name], name


def test_margin_cross_entropy_class_sharded(two):
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as RF

    import paddle_tpu_torch.nn.functional as PF
    res, _ = two
    logits, labels = _mce_inputs()
    ref_loss, ref_soft = RF.margin_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels),
        return_softmax=True)
    x = torch.tensor(logits, requires_grad=True)
    PF.margin_cross_entropy(x, torch.tensor(labels)).backward()
    c = MCE_CLASSES // 2
    for r in range(2):
        np.testing.assert_allclose(res[r]["mce_loss"], float(ref_loss),
                                   **F32)
        np.testing.assert_allclose(res[r]["mce_softmax"],
                                   np.asarray(ref_soft._val)[
                                       :, r * c:(r + 1) * c], **F32)
        np.testing.assert_allclose(res[r]["mce_grad"],
                                   x.grad[:, r * c:(r + 1) * c], **F32)


def test_margin_cross_entropy_by_mesh_axis_name(two):
    """ROADMAP C9: group="model" on a {"model": 2} mesh is the Group form
    (equal to the bit) and the reference's single-process result."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as RF
    res, _ = two
    logits, labels = _mce_inputs()
    ref_loss, ref_soft = RF.margin_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(labels),
        return_softmax=True)
    c = MCE_CLASSES // 2
    for r in range(2):
        loss, grad, soft = res[r]["mce_axis"]
        assert [loss, grad, soft] == [res[r]["mce_loss"], res[r]["mce_grad"],
                                      res[r]["mce_softmax"]]
        np.testing.assert_allclose(loss, float(ref_loss), **F32)
        np.testing.assert_allclose(soft, np.asarray(ref_soft._val)[
            :, r * c:(r + 1) * c], **F32)


def test_sync_batchnorm_normalises_by_the_global_batch(two):
    """ROADMAP C-ref-21: the ranks' outputs and running statistics are the
    reference BatchNorm's on the global batch; the parameters' averaged
    gradients are the global batch's; the input's are those of the
    ranks' summed losses (world x the global mean's)."""
    import paddle_tpu as paddle

    import paddle_tpu_torch as pt
    res, _ = two
    x, c = _bn_inputs()
    bn = paddle.nn.BatchNorm2D(BN_SHAPE[1])
    bn.train()
    y = bn(paddle.to_tensor(x))
    stats = [np.asarray(bn._mean._val), np.asarray(bn._variance._val)]
    # the gradients of the global batch's mean loss, through the port's
    # BatchNorm (held to the reference's by tests/test_torch_conv.py)
    port_bn = pt.nn.BatchNorm2D(BN_SHAPE[1], device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    (port_bn(xt) * torch.tensor(c)).mean().backward()
    gx, gw, gb = xt.grad, port_bn.weight.grad, port_bn.bias.grad
    per = BN_SHAPE[0] // 2
    for r in range(2):
        assert res[r]["bn_type"] == "SyncBatchNorm"
        np.testing.assert_allclose(res[r]["bn_y"],
                                   np.asarray(y._val)[r * per:(r + 1) * per],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res[r]["bn_stats"][0], stats[0], **F32)
        np.testing.assert_allclose(res[r]["bn_stats"][1], stats[1], **F32)
        np.testing.assert_allclose(res[r]["bn_param_grads"][0], gw, **F32)
        np.testing.assert_allclose(res[r]["bn_param_grads"][1], gb, **F32)
        np.testing.assert_allclose(
            res[r]["bn_x_grad"],
            2 * np.asarray(gx)[r * per:(r + 1) * per], **F32)


def test_model_fit_at_world_size_two_follows_one_process(two):
    res, _ = two
    want = _fit_losses(2 * FIT_BATCH)
    assert len(want) == FIT_SAMPLES // (2 * FIT_BATCH)
    for r in range(2):
        np.testing.assert_allclose(res[r]["fit_losses"], want, **F32)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]))
