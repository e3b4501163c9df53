"""SpecLayout and ZeRO-3 of the PyTorch/CUDA port on the host, against
the JAX reference's (tests/test_compiled_step.py:278-330 and :568).

The specs are pure functions of the mesh's axis degrees: each case is
held to the reference's on a mesh of the same degrees. The lanes run in
gloo processes running this file as a script (``--worker``): one spawn
of 4 ranks (data 2 x sharding 2) and one of 2 (sharding 2); the
reference runs its lanes in the test process on its 8-device CPU mesh.
The reference's MLP (tests/test_compiled_step.py:_mlp, its weights
carried in by name) trains 6 AdamW steps on the reference's batches:

- the port's ZeRO-3 lane (``shard_params`` with ``shard_batch`` and a
  DataParallel over the data group) against the reference's ZeRO lane
  and against the port's DP lane (``SpecLayout(shard_params=False)``),
  at the reference's 2e-5; the DP lane against the replicated oracle at
  its 5e-4;
- ``Model.prepare(spec_layout=...)`` through ``fit`` at data 2 x
  sharding 2 against the reference's lane at 5e-4
  (tests/test_compiled_step.py:568);
- ``ShardingOptimizerWrapper(shard_params=True)`` at sharding 2: half
  the parameter and optimizer-state bytes a rank (within 1 %), the
  losses at 2e-5;
- ``unshard`` and sharding again round trip; the state dict of a
  sharded network gathers each shard to the reference's name and shape;
  a DataParallel made before the shards is re-armed by them;
- a hybrid checkpoint saved at sharding 2 loads into the serial model
  (weights and AdamW moments and masters against the serial run), and
  one saved by the serial run at step 3 loads at sharding 2 and trains
  on to the serial run's weights.
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
STEPS, BATCH, LR = 6, 16, 0.01
ZERO_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_compiled_step.py:311
DP_TOL = dict(rtol=5e-4, atol=5e-4)     # tests/test_compiled_step.py:301
RESUME_AT = 3
CLIP = 0.05


def _batches():
    """tests/test_compiled_step.py:_mlp_batches(6, batch=16, seed=6)."""
    rng = np.random.RandomState(6)
    xs = rng.randn(STEPS, BATCH, 8).astype("float32")
    ys = rng.randint(0, 4, (STEPS, BATCH)).astype("int64")
    return xs, ys


# -- the port's side ---------------------------------------------------------

def _port_mlp(arrays):
    import paddle_tpu_torch as pt
    nn = pt.nn
    net = nn.Sequential(nn.Linear(8, 32, device="cpu"), nn.Tanh(),
                        nn.Linear(32, 4, device="cpu"))
    pt.load_numpy_state_dict(net, arrays)
    return net


def _adamw(pt, net, **kw):
    return pt.optimizer.AdamW(learning_rate=LR, parameters=net.parameters(),
                              **kw)


def _clipped(pt, net):
    """AdamW under a global-norm clip that binds at every step."""
    return _adamw(pt, net, grad_clip=pt.nn.ClipGradByGlobalNorm(CLIP))


def _state_bytes(opt):
    base = opt
    while hasattr(base, "_inner"):
        base = base._inner
    return sum(t.numel() * t.element_size()
               for accs in base._accumulators.values()
               for t in accs.values())


def _grads(net):
    """Each parameter's gradient, gathered whole where it is a shard."""
    from paddle_tpu_torch.framework.io_utils import param_split, unshard
    return {n: (unshard(p.grad, param_split(p)) if param_split(p)
                is not None else p.grad).numpy()
            for n, p in net.named_parameters()}


def _serial(pt, arrays, steps=STEPS, net=None, opt=None, start=0,
            first=None):
    """The port's serial lane: (losses, its net, its optimizer); the first
    step's gradients into ``first``."""
    import paddle_tpu_torch.nn.functional as F
    net = net if net is not None else _port_mlp(arrays)
    opt = opt if opt is not None else _adamw(pt, net)
    xs, ys = _batches()
    losses = []
    for i in range(start, steps):
        loss = F.cross_entropy(net(torch.tensor(xs[i])), torch.tensor(ys[i]))
        loss.backward()
        if first is not None and i == start:
            first.update(_grads(net))
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, net, opt


def _lane(pt, arrays, layout):
    """shard_params, shard_batch and a DataParallel over the data group:
    (global losses, gathered weights, this rank's parameter elements and
    optimizer-state bytes, the network, its optimizer)."""
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed.mesh import get_mesh
    from paddle_tpu_torch.framework.io_utils import full_state_dict
    net = _port_mlp(arrays)
    opt = _adamw(pt, net)            # before the shards, as prepare sees it
    n_sharded = dist.shard_params(net, layout)
    data = get_mesh().group("data")
    model = dist.DataParallel(net, group=data)
    xs, ys = _batches()
    losses, first = [], {}
    for i in range(STEPS):
        x, y = dist.shard_batch(layout, torch.tensor(xs[i]),
                                torch.tensor(ys[i]))
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        if i == 0:
            first = _grads(net)
        opt.step()
        opt.clear_grad()
        losses.append(dist.all_reduce(loss.detach().clone(),
                                      op=dist.ReduceOp.AVG,
                                      group=data).item())
    full = {k: v.numpy() for k, v in full_state_dict(net).items()}
    return {"losses": np.array(losses), "n_sharded": np.array(n_sharded),
            "elements": np.array(sum(p.numel() for p in net.parameters())),
            "state_bytes": np.array(_state_bytes(opt)),
            **{f"w.{k}": v for k, v in full.items()},
            **{f"g.{k}": v for k, v in first.items()}}, net, opt


def _four(pt, arrays, out):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.framework.io_utils import local_state_dict
    build_mesh({"data": 2, "sharding": 2})
    zero, net, _ = _lane(pt, arrays, dist.SpecLayout(shard_params=True))
    out.update({f"zero.{k}": v for k, v in zero.items()})
    out["specs"] = np.array([str(p.sharding_spec)
                             for p in net.parameters()])
    local = {k: v.clone() for k, v in local_state_dict(net).items()}
    state = net.state_dict()
    out["state_names"] = np.array(list(state))
    for k, v in state.items():
        out[f"state.{k}"] = v.numpy()
    dist.unshard(net)
    out["unsharded_specs"] = np.array([str(p.sharding_spec)
                                       for p in net.parameters()])
    for k, v in net.state_dict().items():
        out[f"unsharded.{k}"] = v.detach().numpy()
    again = dist.shard_params(net, dist.SpecLayout(shard_params=True))
    out["reshard_same"] = np.array(again == len(local) and all(
        torch.equal(v, local_state_dict(net)[k]) for k, v in local.items()))
    dp, _, _ = _lane(pt, arrays, dist.SpecLayout(shard_params=False))
    out.update({f"dp.{k}": v for k, v in dp.items()})
    out["prepare_losses"] = np.array(_fit(pt, arrays))


def _fit(pt, arrays):
    """Model.prepare(spec_layout=SpecLayout(shard_params=True)) and fit
    over the reference's batches, in order: the losses fit logs."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.hapi.callbacks import Callback
    xs, ys = _batches()
    samples = [(xs[i, j], ys[i, j]) for i in range(STEPS)
               for j in range(BATCH)]
    losses = []

    class Log(Callback):
        def on_train_batch_end(self, step, logs=None):
            losses.append(logs["loss"][0])
    net = _port_mlp(arrays)
    m = pt.Model(net)
    m.prepare(_adamw(pt, net), pt.nn.CrossEntropyLoss(),
              spec_layout=dist.SpecLayout(shard_params=True))
    m.fit(samples, batch_size=BATCH, epochs=1, shuffle=False, verbose=0,
          callbacks=[Log()])
    assert type(m.network).__name__ == "DataParallel"
    return losses


def _two(pt, arrays, out, tmp):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet.sharding_optimizer import \
        ShardingOptimizerWrapper
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.framework.io_utils import full_state_dict
    build_mesh({"sharding": 2})
    net = _port_mlp(arrays)
    opt = ShardingOptimizerWrapper(_adamw(pt, net, multi_precision=True),
                                   shard_params=True)
    losses, _, _ = _serial(pt, arrays, net=net, opt=opt)
    out["wrapper_losses"] = np.array(losses)
    out["wrapper_elements"] = np.array(sum(p.numel()
                                           for p in net.parameters()))
    out["wrapper_state_bytes"] = np.array(_state_bytes(opt))
    for k, v in full_state_dict(net).items():
        out[f"wrapper.{k}"] = v.numpy()
    dist.save_hybrid_checkpoint(os.path.join(tmp, "zero3.pdckpt"), net, opt,
                                meta={"step": STEPS})
    # a DataParallel made before the shards: sharding re-arms its Reducer,
    # which then leaves the shards' gradients (averaged over the fsdp
    # group already; no data axis) as they are
    net = _port_mlp(arrays)
    opt = _adamw(pt, net)
    model = dist.DataParallel(net)
    dist.shard_params(net, dist.SpecLayout(shard_params=True))
    losses, _, _ = _serial(pt, arrays, net=model, opt=opt)
    out["dp_first_losses"] = np.array(losses)
    for k, v in full_state_dict(net).items():
        out[f"dp_first.{k}"] = v.numpy()
    # a global-norm clip over the shards: the norm of the whole gradient
    net = _port_mlp(arrays)
    opt = ShardingOptimizerWrapper(_clipped(pt, net), shard_params=True)
    losses, _, _ = _serial(pt, arrays, net=net, opt=opt)
    out["clip_losses"] = np.array(losses)
    for k, v in full_state_dict(net).items():
        out[f"clip.{k}"] = v.numpy()
    # the serial run's checkpoint at step RESUME_AT, resumed at sharding 2
    net = _port_mlp(arrays)
    opt = ShardingOptimizerWrapper(_adamw(pt, net), shard_params=True)
    dist.load_hybrid_checkpoint(os.path.join(tmp, "serial.pdckpt"), net, opt)
    losses, _, _ = _serial(pt, arrays, net=net, opt=opt, start=RESUME_AT)
    out["resumed_losses"] = np.array(losses)
    for k, v in full_state_dict(net).items():
        out[f"resumed.{k}"] = v.numpy()


def _worker(world):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()
    tmp = os.environ["DIST_TMP"]
    arrays = dict(np.load(os.path.join(tmp, "mlp.npz")))
    out = {}
    if world == 4:
        _four(pt, arrays, out)
    else:
        _two(pt, arrays, out, tmp)
    np.savez(os.path.join(tmp, f"rank{dist.get_rank()}.npz"), **out)
    dist.barrier()
    torch.distributed.destroy_process_group()


# -- the test process ----------------------------------------------------------

def _ref_mlp():
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    paddle.seed(4)
    return nn.Sequential(nn.Linear(8, 32), nn.Tanh(), nn.Linear(32, 4))


def _ref_lane(layout, mesh):
    """The reference's lane (tests/test_compiled_step.py:_run_lane): its
    losses and final weights by name."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    from paddle_tpu.distributed.mesh import build_mesh
    from paddle_tpu.distributed.spec_layout import (shard_batch,
                                                    shard_params, unshard)
    from paddle_tpu.jit.compiled_step import CompiledTrainStep
    build_mesh(mesh)
    try:
        model = _ref_mlp()
        if layout is not None:
            shard_params(model, layout)
        opt = paddle.optimizer.AdamW(learning_rate=LR,
                                     parameters=model.parameters())
        loss_fn = nn.CrossEntropyLoss()

        def body(x, y):
            loss = loss_fn(model(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        step = CompiledTrainStep(body, label="test.spec")
        xs, ys = _batches()
        losses = []
        for i in range(STEPS):
            x, y = paddle.to_tensor(xs[i]), paddle.to_tensor(ys[i])
            if layout is not None:
                shard_batch(layout, x, y)
            losses.append(float(np.asarray(step(x, y).numpy())))
        unshard(model)
        return np.array(losses), {k: np.asarray(v._val)
                                  for k, v in model.state_dict().items()}
    finally:
        build_mesh()


@pytest.fixture(scope="module")
def reference():
    from paddle_tpu.distributed.spec_layout import SpecLayout
    arrays = {k: np.asarray(v._val) for k, v in _ref_mlp().state_dict()
              .items()}
    return {"arrays": arrays,
            "oracle": _ref_lane(None, None),
            "zero": _ref_lane(SpecLayout(shard_params=True),
                              {"data": 4, "sharding": 2})}


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
    failed = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(world)]


@pytest.fixture(scope="module")
def serial(reference, tmp_path_factory):
    """The port's serial lane at world size 1, with its checkpoint at
    step RESUME_AT, and the directory the spawns share."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import save_hybrid_checkpoint
    from paddle_tpu_torch.distributed.mesh import build_mesh
    build_mesh()
    tmp = tmp_path_factory.mktemp("spec")
    np.savez(os.path.join(tmp, "mlp.npz"), **reference["arrays"])
    first = {}
    head, net, opt = _serial(pt, reference["arrays"], steps=RESUME_AT,
                             first=first)
    save_hybrid_checkpoint(os.path.join(tmp, "serial.pdckpt"), net, opt)
    tail, net, opt = _serial(pt, None, net=net, opt=opt, start=RESUME_AT)
    clip = _port_mlp(reference["arrays"])
    clip_losses, _, _ = _serial(pt, None, net=clip, opt=_clipped(pt, clip))
    return {"tmp": tmp, "losses": head + tail, "net": net, "opt": opt,
            "arrays": reference["arrays"], "first_grads": first,
            "clip": (clip_losses, {k: v.detach().numpy() for k, v in
                                   clip.state_dict().items()})}


@pytest.fixture(scope="module")
def four(serial):
    return _spawn(4, serial["tmp"])


@pytest.fixture(scope="module")
def two(serial):
    return _spawn(2, serial["tmp"])


# -- the specs -------------------------------------------------------------------

MESHES = ({"data": 8}, {"data": 4, "sharding": 2},
          {"data": 2, "sharding": 4}, {"data": 2, "sharding": 2, "sep": 2},
          {"pipe": 2, "sep": 4})
CALLS = (("batch_spec", (0,), {}), ("batch_spec", (1,), {}),
         ("batch_spec", (3,), {}), ("stacked_batch_spec", (1,), {}),
         ("stacked_batch_spec", (3,), {}), ("activation_spec", (2,), {}),
         ("sequence_spec", (4,), {}), ("sequence_spec", (4,),
                                       {"seq_dim": 2}),
         ("sequence_spec", (1,), {}),
         ("param_spec", ((32, 8),), {}), ("param_spec", ((8, 32),), {}),
         ("param_spec", ((3, 5),), {}), ("param_spec", ((),), {}),
         ("param_spec", ((6, 4),), {}), ("param_spec", ((2,),), {}))


@pytest.mark.parametrize("shard", [False, True], ids=["dp", "zero3"])
@pytest.mark.parametrize("call", CALLS,
                         ids=lambda c: f"{c[0]}{c[1]}{c[2] or ''}")
@pytest.mark.parametrize("degrees", MESHES,
                         ids=lambda m: "x".join(f"{k}{v}"
                                                for k, v in m.items()))
def test_specs_match_the_reference(degrees, call, shard):
    from paddle_tpu.distributed.mesh import build_mesh as ref_mesh
    from paddle_tpu.distributed.spec_layout import SpecLayout as RefLayout
    from paddle_tpu_torch.distributed import SpecLayout
    from paddle_tpu_torch.distributed.mesh import HYBRID_AXES, Mesh
    name, args, kw = call
    names = [a for a in HYBRID_AXES if a in degrees]
    mesh = Mesh(np.arange(8).reshape([degrees[a] for a in names]), names)
    got = getattr(SpecLayout(shard_params=shard), name)(*args, mesh=mesh,
                                                        **kw)
    try:
        want = getattr(RefLayout(shard_params=shard), name)(
            *args, mesh=ref_mesh(degrees), **kw)
    finally:
        ref_mesh()
    assert isinstance(got, tuple) and got == tuple(want), (got, want)


# -- the lanes -------------------------------------------------------------------

def _weights(got, prefix, want, tol):
    for k, v in want.items():
        np.testing.assert_allclose(got[f"{prefix}.{k}"], v, err_msg=k, **tol)


def test_zero3_lane_matches_the_reference_and_the_dp_lane(four, reference):
    losses, weights = reference["zero"]
    for got in four:
        assert int(got["zero.n_sharded"]) == 4
        np.testing.assert_allclose(got["zero.losses"], losses, **ZERO_TOL)
        _weights(got, "zero.w", weights, ZERO_TOL)
        np.testing.assert_allclose(got["zero.losses"], got["dp.losses"],
                                   **ZERO_TOL)
        _weights(got, "zero.w", {k[5:]: v for k, v in got.items()
                                 if k.startswith("dp.w.")}, ZERO_TOL)


def test_zero3_gradient_is_the_mean_over_the_fsdp_group(four, serial):
    """The first step's gradients, gathered, against the serial step's:
    the fsdp ranks of a data rank hold the same batch, so a sum over them
    would double every shard's gradient (AdamW alone would not show it:
    its update is nearly blind to the gradient's scale)."""
    for got in four:
        for k, want in serial["first_grads"].items():
            for lane in ("zero", "dp"):
                np.testing.assert_allclose(got[f"{lane}.g.{k}"], want,
                                           err_msg=k, **ZERO_TOL)


def test_dp_lane_matches_the_replicated_oracle(four, reference):
    losses, weights = reference["oracle"]
    for got in four:
        assert int(got["dp.n_sharded"]) == 0
        np.testing.assert_allclose(got["dp.losses"], losses, **DP_TOL)
        _weights(got, "dp.w", weights, DP_TOL)


def test_zero3_halves_parameter_and_optimizer_state_bytes(four, two):
    """At sharding 2 every parameter of the MLP divides: a rank holds half
    the elements, and half the moments (the 0-d beta powers stay)."""
    for got in four:
        assert 2 * int(got["zero.elements"]) == int(got["dp.elements"])
        ratio = int(got["zero.state_bytes"]) / int(got["dp.state_bytes"])
        assert abs(ratio - 0.5) <= 0.005, ratio
    for got in two:
        assert 2 * int(got["wrapper_elements"]) == int(four[0]["dp.elements"])


def test_prepare_spec_layout_through_fit(four, reference):
    losses, _ = reference["zero"]
    for got in four:
        np.testing.assert_allclose(got["prepare_losses"], losses, **DP_TOL)


def test_sharding_optimizer_wrapper_shards_params(two, serial):
    for got in two:
        np.testing.assert_allclose(got["wrapper_losses"], serial["losses"],
                                   **ZERO_TOL)
        _weights(got, "wrapper", {k: v.detach().numpy() for k, v in
                                  serial["net"].state_dict().items()},
                 ZERO_TOL)


def test_unshard_round_trips(four):
    for got in four:
        assert all(s == "None" for s in got["unsharded_specs"])
        assert "('sharding', None)" in list(got["specs"]) or \
            "(None, 'sharding')" in list(got["specs"])
        for k in got["state_names"]:
            np.testing.assert_array_equal(got[f"unsharded.{k}"],
                                          got[f"zero.w.{k}"])
        assert bool(got["reshard_same"])


def test_sharded_state_dict_gathers_to_the_reference_names(four, reference):
    for got in four:
        assert list(got["state_names"]) == list(reference["arrays"])
        for k, v in reference["arrays"].items():
            assert got[f"state.{k}"].shape == v.shape
            np.testing.assert_array_equal(got[f"state.{k}"],
                                          got[f"zero.w.{k}"])


def test_checkpoint_saved_at_sharding_2_loads_serially(two, serial):
    """Weights and AdamW moments of the ZeRO-3 run into the serial model
    and optimizer, against the serial run's."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import load_hybrid_checkpoint
    from paddle_tpu_torch.distributed.mesh import build_mesh
    build_mesh()
    net = _port_mlp(serial["arrays"])
    opt = _adamw(pt, net, multi_precision=True)
    meta = load_hybrid_checkpoint(os.path.join(serial["tmp"],
                                               "zero3.pdckpt"), net, opt)
    assert meta["step"] == STEPS
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.detach().numpy(),
                                      two[0][f"wrapper.{k}"])
    want = serial["opt"]
    for name in ("moment1", "moment2"):
        got_acc, want_acc = opt._accumulators[name], \
            want._accumulators[name]
        assert got_acc and len(got_acc) == len(want_acc)
        for p, q in zip(net.parameters(), serial["net"].parameters()):
            np.testing.assert_allclose(got_acc[id(p)].numpy(),
                                       want_acc[id(q)].numpy(), **ZERO_TOL)


def test_data_parallel_made_before_the_shards_rearms(two, serial):
    for got in two:
        np.testing.assert_allclose(got["dp_first_losses"], serial["losses"],
                                   **ZERO_TOL)
        _weights(got, "dp_first", {k: v.detach().numpy() for k, v in
                                   serial["net"].state_dict().items()},
                 ZERO_TOL)


def test_global_norm_clip_takes_the_whole_gradients_norm(two, serial):
    """ClipGradByGlobalNorm under ZeRO-3 sums the shards' squares over
    the fsdp group: the clipped steps equal the serial clipped ones (a
    clip on the local slice alone would scale by another norm)."""
    losses, weights = serial["clip"]
    for got in two:
        np.testing.assert_allclose(got["clip_losses"], losses, **ZERO_TOL)
        _weights(got, "clip", weights, ZERO_TOL)


def test_checkpoint_saved_serially_resumes_at_sharding_2(two, serial):
    for got in two:
        np.testing.assert_allclose(got["resumed_losses"],
                                   serial["losses"][RESUME_AT:], **ZERO_TOL)
        _weights(got, "resumed", {k: v.detach().numpy() for k, v in
                                  serial["net"].state_dict().items()},
                 ZERO_TOL)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[2]))
