"""distributed.auto_parallel of the PyTorch/CUDA port on the host, against
the JAX reference (paddle_tpu/distributed/auto_parallel/__init__.py and
its tests, tests/test_auto_parallel.py).

At world size 1: ProcessMesh's accessors, validation and scope; the
annotations keep the value and pass the gradient, as the reference's do
on its 8-device CPU mesh; ``dtensor_from_fn`` advances the generator as
a plain call does (in both packages); the Engine's fit, evaluate and
predict against the reference's Engine (its MLP's weights carried in by
name; Adam, f32, rtol 1e-5), the partial batch, eval mode, and the
refusals. Two gloo ranks (this file run as a script, ``--worker``) under
``ProcessMesh([0, 1], dim_names=["dp"])``: the Engine's losses, eval loss,
predictions and final weights under data parallelism, gradient merge
(k 2, avg) and ZeRO stages 1 and 3 against the reference's Engine with the
same strategy on its mesh of 2 devices; a second prepare wraps nothing
again; the mesh's groups.
"""
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
TOL = dict(rtol=1e-5, atol=1e-6)
LANES = {"dp": {}, "merge": {"merge": 2},
         "zero1": {"merge": 2, "stage": 1}, "zero3": {"merge": 2, "stage": 3}}


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 8).astype("float32"),
            rng.randint(0, 4, (n, 1)).astype("int64"))


def _ref_mlp(dropout=False):
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    paddle.seed(0)
    layers = [nn.Linear(8, 16), nn.ReLU()]
    if dropout:
        layers.append(nn.Dropout(0.5))
    layers.append(nn.Linear(16, 4))
    return nn.Sequential(*layers)


def _strategy(pkg, merge=1, stage=None):
    s = pkg.distributed.auto_parallel.Strategy()
    if merge > 1:
        s.gradient_merge.enable = True
        s.gradient_merge.k_steps = merge
    if stage is not None:
        s.sharding.enable = True
        s.sharding.degree = 2
        s.sharding.stage = stage
    return s


def _ref_engine_run(arrays, ndev, lane):
    """The reference's Engine on a mesh of ``ndev`` devices: losses, eval
    loss, the first prediction and the final weights. It runs without a
    global mesh (a sharding Engine refuses one that lacks its axis, such
    as the ('data',) mesh an earlier test file may leave: ROADMAP C-ref-3)
    and puts the global mesh back as it was (a sharding Engine sets
    one)."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as F
    from paddle_tpu.distributed import mesh as ref_mesh
    from paddle_tpu.distributed.auto_parallel import Engine, ProcessMesh
    prev = dict(ref_mesh._STATE)
    ref_mesh._STATE.update(mesh=None, axis_degrees=None)
    try:
        model = _ref_mlp()
        model.set_state_dict({k: paddle.to_tensor(v)
                              for k, v in arrays.items()})
        opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                    parameters=model.parameters())
        engine = Engine(model, loss=F.cross_entropy, optimizer=opt,
                        strategy=_strategy(paddle, **LANES[lane]),
                        process_mesh=ProcessMesh(np.arange(ndev),
                                                 dim_names=["dp"]))
        x, y = _data()
        hist = engine.fit((x, y), epochs=1, batch_size=16)
        ev = engine.evaluate((x, y), batch_size=32)
        pred = engine.predict((x, y), batch_size=32)
        return {"losses": np.array(hist["loss"]),
                "eval": ev["eval_loss"],
                "pred": np.asarray(pred[0]._val),
                "weights": {k: np.asarray(v._val)
                            for k, v in model.state_dict().items()}}
    finally:
        ref_mesh._STATE.clear()
        ref_mesh._STATE.update(prev)


def _port_mlp(pt, arrays, dropout=False, device="cpu"):
    nn = pt.nn
    layers = [nn.Linear(8, 16, device=device), nn.ReLU()]
    if dropout:
        layers.append(nn.Dropout(0.5))
    layers.append(nn.Linear(16, 4, device=device))
    model = nn.Sequential(*layers)
    if dropout:   # the second Linear is layer 3 behind the Dropout
        arrays = {("3" + k[1:] if k.startswith("2.") else k): v
                  for k, v in arrays.items()}
    pt.load_numpy_state_dict(model, arrays)
    return model


def _port_engine(pt, arrays, pm, lane="dp", dropout=False):
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    model = _port_mlp(pt, arrays, dropout)
    opt = pt.optimizer.Adam(learning_rate=1e-2,
                            parameters=model.parameters())
    return Engine(model, loss=F.cross_entropy, optimizer=opt,
                  strategy=_strategy(pt, **LANES[lane]),
                  process_mesh=pm), model


@pytest.fixture(scope="module")
def arrays():
    return {k: np.asarray(v._val) for k, v in _ref_mlp().state_dict()
            .items()}


# -- ProcessMesh and the annotations ------------------------------------------

def test_process_mesh_topology_and_validation():
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh
    pm = ProcessMesh([[0]], dim_names=["x", "y"])
    assert pm.shape == [1, 1] and pm.dim_names == ["x", "y"]
    assert pm.process_ids == [0] and pm.ndim == 2
    assert pm.get_dim_size("y") == 1
    assert ProcessMesh([0]).dim_names == ["d0"]
    assert pm == ProcessMesh(np.zeros((1, 1), int), dim_names=["x", "y"])
    assert hash(pm) == hash(ProcessMesh([[0]], dim_names=["x", "y"]))
    assert pm.mesh_groups.group("x").nranks == 1
    for bad in (lambda: ProcessMesh(np.arange(8).reshape(4, 2),
                                    dim_names=["x"]),
                lambda: ProcessMesh(np.arange(10_000)),
                lambda: ProcessMesh(np.array([0, -1]), dim_names=["x"])):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(TypeError):
        ProcessMesh(np.zeros(2), dim_names=["x"])
    assert ProcessMesh([1], dim_names=["x"], process_ids=[0, 0]) \
        .process_ids == [0]


def test_default_scope_and_annotations_keep_the_value_and_grad():
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    from paddle_tpu.distributed import auto_parallel as ref_ap
    from paddle_tpu_torch.distributed import auto_parallel as ap
    ref_pm = ref_ap.ProcessMesh(np.arange(8).reshape(4, 2),
                                dim_names=["x", "y"])
    pm = ap.ProcessMesh([[0]], dim_names=["x", "y"])
    x = np.arange(32, dtype="float32").reshape(8, 4)
    prev = pt.get_device()
    pt.set_device("cpu")
    try:
        with pm:
            assert ap.get_default_process_mesh() is pm
            t = ap.shard_tensor(x, shard_spec=["x", None])
            assert t.dist_attr.process_mesh is pm
        assert ap.get_default_process_mesh() is None
        with ref_pm:
            want = ref_ap.shard_tensor(x, shard_spec=["x", None])
        np.testing.assert_array_equal(t.numpy(), np.asarray(want._val))
        r = ap.reshard(t, pm, [None, "y"])
        assert r.dist_attr.shard_spec == [None, "y"]
        assert r.dist_attr.partition_spec() == (None, "y")
        np.testing.assert_array_equal(r.numpy(), x)
        # the gradient flows through (tests/test_auto_parallel.py:65)
        leaf = torch.ones(8, 4, requires_grad=True)
        s = ap.shard_tensor(leaf, pm, ["x", None])
        (s * s).sum().backward()
        rt = paddle.to_tensor(np.ones((8, 4), "float32"))
        rt.stop_gradient = False
        rs = ref_ap.shard_tensor(rt, ref_pm, ["x", None])
        (rs * rs).sum().backward()
        np.testing.assert_array_equal(leaf.grad.numpy(),
                                      np.asarray(rt.grad._val))
        with pytest.raises(ValueError):
            ap.shard_tensor(x, pm, ["z", None])
        with pytest.raises(Exception, match="ProcessMesh"):
            ap.shard_tensor(x, shard_spec=["x", None])
    finally:
        pt.set_device(prev)


def test_shard_op_gives_the_unannotated_result():
    import paddle_tpu as paddle
    from paddle_tpu.distributed import auto_parallel as ref_ap
    from paddle_tpu_torch.distributed import auto_parallel as ap
    w = np.random.RandomState(0).randn(4, 6).astype("float32")
    x = np.ones((8, 4), "float32")
    ref_pm = ref_ap.ProcessMesh(np.arange(8).reshape(4, 2),
                                dim_names=["x", "y"])
    want = ref_ap.shard_op(paddle.matmul, ref_pm,
                           in_shard_specs=[["x", None], [None, "y"]],
                           out_shard_specs=[["x", "y"]])(
        paddle.to_tensor(x), paddle.to_tensor(w))
    pm = ap.ProcessMesh([[0]], dim_names=["x", "y"])
    f = ap.shard_op(torch.matmul, pm,
                    in_shard_specs=[["x", None], [None, "y"]],
                    out_shard_specs=[["x", "y"]])
    got = f(torch.tensor(x), torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want._val),
                               rtol=1e-6)
    assert got.dist_attr.shard_spec == ["x", "y"]
    g = ap.shard_op(lambda a: (a, a), pm, out_shard_specs=[["x"]])
    with pytest.raises(ValueError, match="out_shard_specs"):
        g(torch.ones(2))


def test_dtensor_from_fn_advances_the_generator_as_a_plain_call():
    """tests/test_auto_parallel.py:188: the creation function's draws
    come from the global generator, so the next draw is the one a plain
    call would be followed by; in both packages."""
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    from paddle_tpu.distributed import auto_parallel as ref_ap
    from paddle_tpu_torch.distributed import auto_parallel as ap
    for pkg, mod, pm in (
            (paddle, ref_ap, ref_ap.ProcessMesh(np.arange(8),
                                                dim_names=["dp"])),
            (pt, ap, ap.ProcessMesh([0], dim_names=["dp"]))):
        def draw():
            return pkg.randn([8, 4])

        def arr(t):
            return np.asarray(t._val) if hasattr(t, "_val") else \
                t.cpu().numpy()
        prev = pt.get_device()
        pt.set_device("cpu")
        try:
            pkg.seed(5)
            a, b = draw(), draw()
            pkg.seed(5)
            t = mod.dtensor_from_fn(draw, pm, ["dp", None])
            c = draw()
        finally:
            pt.set_device(prev)
        np.testing.assert_array_equal(arr(t), arr(a))
        np.testing.assert_array_equal(arr(c), arr(b))
        assert t.dist_attr.shard_spec == ["dp", None]
        ones = mod.dtensor_from_fn(
            lambda: pkg.zeros((8, 4)).fill_(1.0) if pkg is paddle
            else torch.zeros(8, 4).fill_(1.0), pm, ["dp", None])
        np.testing.assert_array_equal(arr(ones), np.ones((8, 4)))


# -- the Engine at world size 1 -----------------------------------------------

@pytest.mark.parametrize("lane", ["dp", "merge"])
def test_engine_fit_evaluate_predict_match_the_reference(arrays, lane):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh
    ref = _ref_engine_run(arrays, 8, lane)
    engine, model = _port_engine(pt, arrays, ProcessMesh([0],
                                                          dim_names=["dp"]),
                                 lane)
    x, y = _data()
    hist = engine.fit((x, y), epochs=1, batch_size=16)
    np.testing.assert_allclose(hist["loss"], ref["losses"], **TOL)
    ev = engine.evaluate((x, y), batch_size=32)
    np.testing.assert_allclose(ev["eval_loss"], ref["eval"], **TOL)
    pred = engine.predict((x, y), batch_size=32)
    assert tuple(pred[0].shape) == (32, 4)
    np.testing.assert_allclose(pred[0].numpy(), ref["pred"], **TOL)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref["weights"][k], **TOL)
    assert engine.history == [hist["loss"][-1]]
    cost = engine.cost()
    assert cost["params"] == 8 * 16 + 16 + 16 * 4 + 4 and \
        cost["devices"] == 1


def test_engine_partial_batch_and_eval_mode(arrays):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh
    pm = ProcessMesh([0], dim_names=["dp"])
    engine, _ = _port_engine(pt, arrays, pm)
    x, y = _data(20)
    assert len(engine.fit((x, y), epochs=1, batch_size=16)["loss"]) == 2
    engine, model = _port_engine(pt, arrays, pm, dropout=True)
    x, y = _data(16)
    a = engine.evaluate((x, y))["eval_loss"]
    b = engine.evaluate((x, y))["eval_loss"]
    assert a == b and model.training
    engine.predict(x)
    assert model.training


def test_engine_refusals_raise_as_the_reference_does(arrays):
    import paddle_tpu as paddle
    import paddle_tpu_torch as pt
    from paddle_tpu.distributed.auto_parallel import Engine as RefEngine
    from paddle_tpu_torch.distributed.auto_parallel import (ProcessMesh,
                                                            shard_tensor)
    pm = ProcessMesh([0], dim_names=["dp"])
    engine, _ = _port_engine(pt, arrays, pm)
    ref = RefEngine(_ref_mlp(), loss=paddle.nn.functional.cross_entropy,
                    optimizer=None)
    for e in (engine, ref):
        with pytest.raises(ValueError, match="needs .x, y."):
            e.fit(np.ones((16, 8), "float32"), batch_size=8)
        with pytest.raises(ValueError, match="mismatched"):
            e.fit((np.ones((10, 8), "f"), np.ones((9, 1), "i")),
                  batch_size=4)
    for section in ("pipeline", "recompute"):
        for pkg, make in ((pt, lambda: _port_engine(pt, arrays, pm)[0]),
                          (paddle, lambda: RefEngine(_ref_mlp()))):
            e = make()
            getattr(e.strategy, section).enable = True
            with pytest.raises(NotImplementedError):
                e.prepare()
    engine, _ = _port_engine(pt, arrays, pm, lane="zero1")
    with pytest.raises(ValueError, match="degree"):
        engine.prepare()
    # an annotation over another mesh axis: fleet's TP layers instead
    pm2 = ProcessMesh([[0]], dim_names=["dp", "mp"])
    engine, model = _port_engine(pt, arrays, pm2)
    shard_tensor(model[0].weight, pm2, [None, "mp"])
    with pytest.raises(NotImplementedError, match="'mp'.*ColumnParallel"):
        engine.prepare()


# -- two gloo ranks -----------------------------------------------------------

def _worker():
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.auto_parallel import ProcessMesh
    from paddle_tpu_torch.framework.io_utils import full_state_dict
    dist.init_parallel_env()
    tmp = os.environ["DIST_TMP"]
    rank = dist.get_rank()
    arrays = dict(np.load(os.path.join(tmp, "mlp.npz")))
    pm = ProcessMesh([0, 1], dim_names=["dp"])
    groups = pm.mesh_groups
    out = {"group": np.array([groups.group("dp").nranks,
                              groups.group("dp").rank])}
    x, y = _data()
    for lane in LANES:
        engine, model = _port_engine(pt, arrays, pm, lane)
        hist = engine.fit((x, y), epochs=1, batch_size=16)
        out[f"{lane}.losses"] = np.array(hist["loss"])
        out[f"{lane}.eval"] = np.array(
            engine.evaluate((x, y), batch_size=32)["eval_loss"])
        out[f"{lane}.pred"] = engine.predict((x, y), batch_size=32)[0] \
            .numpy()
        wrapped = engine.optimizer
        engine.prepare()
        out[f"{lane}.same_after_prepare"] = np.array(
            engine.optimizer is wrapped)
        out[f"{lane}.sharded"] = np.array(sum(
            getattr(p, "fsdp_split", None) is not None
            for p in model.parameters()))
        for k, v in full_state_dict(model).items():
            out[f"{lane}.w.{k}"] = v.numpy()
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.barrier()
    torch.distributed.destroy_process_group()


def _spawn(world, tmp, timeout=120):
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
            [sys.executable, HERE, "--worker"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=timeout)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def two(arrays, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("auto")
    np.savez(os.path.join(tmp, "mlp.npz"), **arrays)
    return {"ranks": _spawn(2, tmp),
            "refs": {lane: _ref_engine_run(arrays, 2, lane)
                     for lane in LANES}}


@pytest.mark.parametrize("lane", list(LANES))
def test_engine_on_two_ranks_matches_the_reference(two, lane):
    ref = two["refs"][lane]
    for got in two["ranks"]:
        np.testing.assert_allclose(got[f"{lane}.losses"], ref["losses"],
                                   **TOL)
        np.testing.assert_allclose(got[f"{lane}.eval"], ref["eval"], **TOL)
        np.testing.assert_allclose(got[f"{lane}.pred"], ref["pred"], **TOL)
        for k, v in ref["weights"].items():
            np.testing.assert_allclose(got[f"{lane}.w.{k}"], v, **TOL)


def test_engine_prepare_twice_wraps_once_and_stage_3_shards(two):
    for got in two["ranks"]:
        for lane in LANES:
            assert bool(got[f"{lane}.same_after_prepare"]), lane
        assert int(got["zero3.sharded"]) == 4
        assert int(got["zero1.sharded"]) == 0
    assert [g["group"].tolist() for g in two["ranks"]] == [[2, 0], [2, 1]]


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker()
