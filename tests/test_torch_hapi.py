"""The port's high-level training API (hapi.Model) against the JAX
reference on the host.

The same network (the reference's weights carried into the port by
name), the same numpy data and the same numpy seed go through
``Model.prepare`` / ``fit`` / ``evaluate`` / ``predict`` / ``save`` /
``load`` in both packages:

- LeNet on synthetic MNIST with Adam(1e-3): the per-step losses of
  ``fit`` within LOSS_RTOL (1e-5 relative), with ``shuffle=False`` and
  with ``shuffle=True`` under one ``np.random.seed`` (both packages draw
  the order from numpy's global generator), and with
  ``steps_per_execution=4`` over a ragged last batch; ``evaluate``'s loss
  within LOSS_RTOL and its accuracy equal.
- On the port alone, ``steps_per_execution=4`` gives the losses of
  ``steps_per_execution=1`` exactly (on the host both run the same
  Python step).
- ``Model.save`` of either package loads in the other (parameters and
  Adam's moments equal; the evaluation after loading equal).
- ``Model.load`` into another network: a name only one side has is
  skipped and a shape that differs raises, in both packages; on the port
  ``skip_mismatch=True`` loads a backbone under a new head (ROADMAP
  C-ref-9).
- The reference's TestHapi cases: fit/evaluate/predict/save/load, the
  per-rank loader at world size 2 (where the port's ``prepare`` wraps in
  DataParallel, and raises while the launcher's variables say so and no
  process group was joined), EarlyStopping, summary and flops;
  and the callbacks (LRScheduler, ReduceLROnPlateau, VisualDL,
  ProgBarLogger).

The reference's compiled step runs under XLA on the host and the port's
under torch, so the losses differ by rounding: hence LOSS_RTOL, not
equality.
"""
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
BATCH = 64


def _lenet_pair():
    """The reference's LeNet from seed 0 and the port's with its weights."""
    paddle.seed(0)
    ref = paddle.vision.models.LeNet()
    port = pt.vision.models.LeNet(device="cpu")
    pt.load_numpy_state_dict(port, {k: np.array(v._val)
                                    for k, v in ref.state_dict().items()})
    return ref, port


def _models(ref_net, port_net, lr=1e-3, metrics=True):
    ref = paddle.Model(ref_net)
    ref.prepare(paddle.optimizer.Adam(learning_rate=lr,
                                      parameters=ref_net.parameters()),
                paddle.nn.CrossEntropyLoss(),
                paddle.metric.Accuracy() if metrics else None)
    port = pt.Model(port_net)
    port.prepare(pt.optimizer.Adam(learning_rate=lr,
                                   parameters=port_net.parameters()),
                 pnn.CrossEntropyLoss(),
                 pt.metric.Accuracy() if metrics else None)
    return ref, port


class Recorder(pt.callbacks.Callback):
    """Records each step's loss; works with either package's fit (the
    callback protocol is duck-typed)."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"][0]))


def _fit_losses(model, data, **kw):
    rec = Recorder()
    model.fit(data, verbose=0, callbacks=[rec], **kw)
    return rec.losses


def _assert_losses(port, ref, rtol=LOSS_RTOL):
    assert len(port) == len(ref) > 0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=0)


@pytest.mark.parametrize("shuffle", [False, True])
def test_lenet_fit_losses_match_reference(shuffle):
    ref_net, port_net = _lenet_pair()
    ref, port = _models(ref_net, port_net)
    np.random.seed(7)
    ref_losses = _fit_losses(ref, paddle.vision.datasets.MNIST(mode="train"),
                             batch_size=BATCH, shuffle=shuffle, num_iters=8)
    np.random.seed(7)
    port_losses = _fit_losses(port, pt.vision.datasets.MNIST(mode="train"),
                              batch_size=BATCH, shuffle=shuffle, num_iters=8)
    _assert_losses(port_losses, ref_losses)
    # evaluate on a held-in slice (the synthetic test split draws other
    # class means: ROADMAP C-ref-8)
    idx = list(range(0, 2048, 4))
    r = ref.evaluate(paddle.io.Subset(
        paddle.vision.datasets.MNIST(mode="train"), idx), batch_size=128,
        verbose=0)
    p = port.evaluate(pt.io.Subset(pt.vision.datasets.MNIST(mode="train"),
                                   idx), batch_size=128, verbose=0)
    np.testing.assert_allclose(p["loss"], r["loss"], rtol=LOSS_RTOL)
    assert p["acc"] == r["acc"]


def test_ragged_groups_match_reference():
    """steps_per_execution=4 over 600 samples at batch 64: two groups of
    four, then the last full batch and the ragged 24-sample batch run
    step by step (a new signature), in both packages."""
    ref_net, port_net = _lenet_pair()
    ref, port = _models(ref_net, port_net, metrics=False)
    r_ds = paddle.io.Subset(paddle.vision.datasets.MNIST(mode="train"),
                            list(range(600)))
    p_ds = pt.io.Subset(pt.vision.datasets.MNIST(mode="train"),
                        list(range(600)))
    ref_losses = _fit_losses(ref, r_ds, batch_size=BATCH, shuffle=False,
                             steps_per_execution=4)
    port_losses = _fit_losses(port, p_ds, batch_size=BATCH, shuffle=False,
                              steps_per_execution=4)
    assert len(port_losses) == 10
    _assert_losses(port_losses, ref_losses)


@pytest.mark.parametrize("spe", [2, 4])
def test_steps_per_execution_equals_single_steps(spe):
    _, a = _lenet_pair()
    _, b = _lenet_pair()
    _, one = _models(paddle.vision.models.LeNet(), a, metrics=False)
    _, grouped = _models(paddle.vision.models.LeNet(), b, metrics=False)
    ds = pt.vision.datasets.MNIST(mode="train")
    l1 = _fit_losses(one, ds, batch_size=BATCH, shuffle=False, num_iters=8)
    lk = _fit_losses(grouped, ds, batch_size=BATCH, shuffle=False,
                     num_iters=8, steps_per_execution=spe)
    assert l1 == lk
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)


def test_train_and_eval_batch_match_reference():
    ref_net, port_net = _lenet_pair()
    ref, port = _models(ref_net, port_net)
    rng = np.random.RandomState(1)
    x = rng.randn(16, 1, 28, 28).astype("float32")
    y = rng.randint(0, 10, (16,)).astype("int64")
    r = ref.train_batch([x], [y])
    p = port.train_batch([x], [torch.tensor(y)])
    np.testing.assert_allclose(p, r, rtol=LOSS_RTOL)
    r_loss, r_acc = ref.eval_batch([x], [y])
    p_loss, p_acc = port.eval_batch([x], [y])
    np.testing.assert_allclose(p_loss, r_loss, rtol=LOSS_RTOL)
    assert p_acc == r_acc
    np.testing.assert_allclose(port.predict_batch([x])[0],
                               ref.predict_batch([x])[0], rtol=1e-4,
                               atol=1e-5)


def _saved_state(model, package):
    """(parameters, Adam's moments) of a Model of either package, as
    numpy."""
    def arr(v):
        return v.detach().numpy() if package == "port" \
            else np.asarray(v._val)
    net = {k: arr(v) for k, v in model.network.state_dict().items()}
    moments = {k: arr(v).reshape(-1)
               for k, v in model._optimizer.state_dict().items()
               if "moment" in k}
    return net, moments


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """Model.save after 4 steps in one package, Model.load into a fresh
    Model of the other: parameters and Adam's moments equal, and the same
    evaluation."""
    pkgs = {"port": pt, "ref": paddle}
    reader = "ref" if writer == "port" else "port"
    ref_net, port_net = _lenet_pair()
    trained = dict(zip(("ref", "port"), _models(ref_net, port_net)))
    fresh = dict(zip(("ref", "port"), _models(
        paddle.vision.models.LeNet(), pt.vision.models.LeNet(device="cpu"))))
    w, r = trained[writer], fresh[reader]
    w.fit(pkgs[writer].vision.datasets.MNIST(mode="train"), batch_size=BATCH,
          shuffle=False, num_iters=4, verbose=0)
    w.save(str(tmp_path / "m"))
    r.load(str(tmp_path / "m"))
    (w_net, w_mom), (r_net, r_mom) = (_saved_state(w, writer),
                                      _saved_state(r, reader))
    assert sorted(w_net) == sorted(r_net)
    for k in w_net:
        np.testing.assert_array_equal(r_net[k], w_net[k])
    assert sorted(w_mom) == sorted(r_mom) and len(w_mom) == 20
    for k in w_mom:
        np.testing.assert_array_equal(r_mom[k], w_mom[k])
    idx = list(range(256))
    ew, er = (m.evaluate(pkgs[name].io.Subset(
        pkgs[name].vision.datasets.MNIST(mode="train"), idx),
        batch_size=128, verbose=0) for m, name in ((w, writer), (r, reader)))
    np.testing.assert_allclose(er["loss"], ew["loss"], rtol=LOSS_RTOL)
    assert er["acc"] == ew["acc"]



def _trained_checkpoint(tmp_path, writer, steps=2):
    """A LeNet (10 classes) Model of ``writer``'s package after ``steps``
    fit steps, saved to tmp_path/m: (path, its parameters, its moments)."""
    pkgs = {"port": pt, "ref": paddle}
    ref_net, port_net = _lenet_pair()
    w = dict(zip(("ref", "port"), _models(ref_net, port_net)))[writer]
    w.fit(pkgs[writer].vision.datasets.MNIST(mode="train"), batch_size=BATCH,
          shuffle=False, num_iters=steps, verbose=0)
    path = str(tmp_path / "m")
    w.save(path)
    return (path, *_saved_state(w, writer))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_load_skips_names_only_one_side_has(tmp_path, writer):
    """A LeNet checkpoint into a LeNet without its classifier
    (num_classes=0), in both packages: the classifier's names are skipped,
    as the reference's set_state_dict skips them, and the backbone
    loads."""
    path, saved, _ = _trained_checkpoint(tmp_path, writer)
    readers = _models(paddle.vision.models.LeNet(num_classes=0),
                      pt.vision.models.LeNet(num_classes=0, device="cpu"),
                      metrics=False)
    for r, name in zip(readers, ("ref", "port")):
        r.load(path)
        net, _ = _saved_state(r, name)
        assert sorted(net) == sorted(k for k in saved
                                     if k.startswith("features."))
        for k in net:
            np.testing.assert_array_equal(net[k], saved[k])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_load_under_a_new_head(tmp_path, writer):
    """A LeNet checkpoint (10 classes) into a LeNet with 5: a shape that
    differs raises ValueError in both packages. With skip_mismatch=True
    the port loads every other parameter and its Adam moments, keeps its
    own head and trains on; the reference does not read skip_mismatch and
    raises again (ROADMAP C-ref-9)."""
    path, saved, moments = _trained_checkpoint(tmp_path, writer)
    ref5, port5 = _models(paddle.vision.models.LeNet(num_classes=5),
                          pt.vision.models.LeNet(num_classes=5, device="cpu"),
                          metrics=False)
    head = {k: v.detach().clone()
            for k, v in port5.network.state_dict().items()
            if k.startswith("fc.2.")}
    for m in (ref5, port5):
        with pytest.raises(ValueError):
            m.load(path)
    with pytest.raises(ValueError):
        ref5.load(path, skip_mismatch=True)
    port5.load(path, skip_mismatch=True)
    net, moms = _saved_state(port5, "port")
    assert sorted(net) == sorted(saved) and len(head) == 2
    for k in net:
        if k in head:
            assert torch.equal(port5.network.state_dict()[k], head[k])
        else:
            np.testing.assert_array_equal(net[k], saved[k])
    # Adam's two moments of the 8 parameters outside the head, as saved
    assert len(moms) == 16
    for k in moms:
        np.testing.assert_array_equal(moms[k], moments[k])
    losses = _fit_losses(port5, _Relabel(pt.vision.datasets.MNIST(
        mode="train"), 5), batch_size=BATCH, shuffle=False, num_iters=2)
    assert len(losses) == 2 and np.isfinite(losses).all()


class _Relabel(pt.io.Dataset):
    """A dataset's samples with their labels taken modulo ``n``."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        x, y = self.ds[i]
        return x, np.asarray(y) % self.n


# -- the reference's TestHapi ---------------------------------------------

def _dataset(n=64):
    """n samples of a noisy linear 3-class problem, the same for every
    call, whatever ran before."""
    rng = np.random.RandomState(3)
    x = rng.randn(n, 4).astype("float32")
    w = rng.randn(4, 3).astype("float32")
    y = np.argmax(x @ w + 0.05 * rng.randn(n, 3), axis=1).astype("int64")
    return pt.io.TensorDataset([x, y])


def _mlp():
    return pnn.Sequential(pnn.Linear(4, 16, device="cpu"),
                          pnn.ReLU(device="cpu"),
                          pnn.Linear(16, 3, device="cpu"))


def test_fit_evaluate_predict(tmp_path):
    net = _mlp()
    model = pt.Model(net)
    model.prepare(
        optimizer=pt.optimizer.Adam(learning_rate=0.01,
                                    parameters=net.parameters()),
        loss=pnn.CrossEntropyLoss(),
        metrics=pt.metric.Accuracy())
    ds = _dataset()
    model.fit(ds, batch_size=16, epochs=3, verbose=0)
    result = model.evaluate(ds, batch_size=16, verbose=0)
    assert result["acc"] > 0.5, result
    preds = model.predict(ds, batch_size=16, stack_outputs=True)
    assert preds[0].shape == (64, 3)
    before = [p.detach().clone() for p in net.parameters()]
    model.save(str(tmp_path / "m"))
    model.fit(ds, batch_size=16, epochs=1, verbose=0)
    model.load(str(tmp_path / "m"))
    for a, b in zip(net.parameters(), before):
        assert torch.equal(a, b)


_LAUNCHER_VARS = ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                  "JAX_PROCESS_ID", "JAX_NUM_PROCESSES", "RANK",
                  "WORLD_SIZE")


def _launcher_env(monkeypatch, env):
    for name in _LAUNCHER_VARS:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2", "RANK": "0"},
                                 {"PADDLE_TRAINERS_NUM": "2",
                                  "PADDLE_TRAINER_ID": "0"}])
def test_distributed_loader_shards_and_prepare_raises(monkeypatch, env):
    """Rank 0 of two, as torchrun or the reference's launcher starts it:
    the loader takes its shard, and prepare never trains an
    unsynchronised replica (without init_parallel_env it raises)."""
    from paddle_tpu_torch.hapi.model import Model
    from paddle_tpu_torch.io import DataLoader, DistributedBatchSampler
    _launcher_env(monkeypatch, env)
    net = pnn.Linear(4, 3, device="cpu")
    model = Model(net)
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        model.prepare(
            optimizer=pt.optimizer.SGD(learning_rate=0.1,
                                       parameters=net.parameters()),
            loss=pnn.CrossEntropyLoss())
    ds = _dataset(20)
    loader = Model._make_loader(ds, batch_size=4, shuffle=False,
                                drop_last=False, num_workers=0)
    assert isinstance(loader.batch_sampler, DistributedBatchSampler)
    # rank 0 of 2 sees ceil(20/2) = 10 samples: 3 batches of <= 4
    assert len(loader.batch_sampler) == 3
    dl = DataLoader(ds, batch_size=4)
    assert Model._make_loader(dl, 4, False, False, 0) is dl


@pytest.mark.parametrize("env, expected", [
    ({}, (0, 1)),
    ({"RANK": "1", "WORLD_SIZE": "2"}, (1, 2)),
    ({"JAX_PROCESS_ID": "2", "JAX_NUM_PROCESSES": "3"}, (2, 3)),
    ({"PADDLE_TRAINER_ID": "0", "PADDLE_TRAINERS_NUM": "4", "RANK": "1",
      "WORLD_SIZE": "2"}, (0, 4)),
])
def test_rank_and_world_size_from_the_launcher(monkeypatch, env, expected):
    """The reference's variables first, then torch's launcher's; the
    flight recorder takes the same rank."""
    from paddle_tpu_torch.distributed import get_rank, get_world_size
    from paddle_tpu_torch.resilience.recorder import FlightRecorder
    _launcher_env(monkeypatch, env)
    assert (get_rank(), get_world_size()) == expected
    assert FlightRecorder(size=4).rank == expected[0]


def test_an_initialised_group_comes_before_torchs_variables(monkeypatch):
    import socket

    import torch.distributed as tdist
    from paddle_tpu_torch.distributed import get_rank, get_world_size
    _launcher_env(monkeypatch, {"RANK": "1", "WORLD_SIZE": "2"})
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             world_size=1, rank=0)
    try:
        assert (get_rank(), get_world_size()) == (0, 1)
    finally:
        tdist.destroy_process_group()
    assert (get_rank(), get_world_size()) == (1, 2)


def test_spec_layout_raises():
    """A spec_layout that is no SpecLayout raises; a SpecLayout at world
    size 1 shards nothing and wraps nothing."""
    net = pnn.Linear(4, 3, device="cpu")
    with pytest.raises(TypeError, match="SpecLayout"):
        pt.Model(net).prepare(loss=pnn.CrossEntropyLoss(),
                              spec_layout=object())
    from paddle_tpu_torch.distributed import SpecLayout
    m = pt.Model(net).prepare(loss=pnn.CrossEntropyLoss(),
                              spec_layout=SpecLayout(shard_params=True))
    assert m.network is net and m._captures()
    assert tuple(net.weight.shape) == (4, 3)


def test_amp_configs_accepted_and_not_read():
    net = pnn.Linear(4, 3, device="cpu")
    m = pt.Model(net).prepare(
        pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters()),
        pnn.CrossEntropyLoss(), amp_configs={"level": "O2"})
    m.fit(_dataset(16), batch_size=8, epochs=1, verbose=0)
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_early_stopping():
    net = pnn.Linear(4, 3, device="cpu")
    model = pt.Model(net)
    model.prepare(
        optimizer=pt.optimizer.SGD(learning_rate=0.0,
                                   parameters=net.parameters()),
        loss=pnn.CrossEntropyLoss())
    es = pt.callbacks.EarlyStopping(monitor="loss", patience=1, mode="min")
    model.fit(_dataset(32), batch_size=16, epochs=10, verbose=0,
              callbacks=[es])
    assert model.stop_training


def test_summary_and_flops_match_reference(capsys):
    ref_net, port_net = _lenet_pair()
    info = pt.summary(port_net, (1, 1, 28, 28))
    assert info["total_params"] == 61610  # LeNet (the reference's count)
    assert info == paddle.summary(ref_net, (1, 1, 28, 28))
    assert pt.flops(port_net, (1, 1, 28, 28)) == \
        paddle.flops(ref_net, (1, 1, 28, 28))
    assert "Total params: 61,610" in capsys.readouterr().out


def test_lr_scheduler_callback_steps_the_schedule():
    net = pnn.Linear(4, 3, device="cpu")
    sched = pt.optimizer.lr.StepDecay(learning_rate=0.1, step_size=2,
                                      gamma=0.5)
    model = pt.Model(net).prepare(
        pt.optimizer.SGD(learning_rate=sched, parameters=net.parameters()),
        pnn.CrossEntropyLoss())
    lrs = []

    class LrRead(pt.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            lrs.append(model._optimizer.get_lr())
    model.fit(_dataset(48), batch_size=8, epochs=1, verbose=0,
              callbacks=[LrRead(), pt.callbacks.LRScheduler()])
    assert lrs == [0.1, 0.1, 0.05, 0.05, 0.025, 0.025]


def test_reduce_lr_on_plateau_and_visualdl(tmp_path):
    net = pnn.Linear(4, 3, device="cpu")
    with torch.no_grad():  # from zero weights: the first loss is ~ln 3
        for p in net.parameters():
            p.zero_()
    model = pt.Model(net).prepare(
        pt.optimizer.SGD(learning_rate=0.0, parameters=net.parameters()),
        pnn.CrossEntropyLoss())
    model._optimizer.set_lr(0.4)
    rl = pt.callbacks.ReduceLROnPlateau(patience=1, factor=0.5, verbose=0,
                                        min_delta=10.0)
    vdl = pt.callbacks.VisualDL(log_dir=str(tmp_path / "vdl"))
    model.fit(_dataset(16), batch_size=8, epochs=3, verbose=0,
              callbacks=[rl, vdl])
    # a loss near ln 3 never improves by min_delta: the lr halves after
    # epochs 1 and 2
    assert model._optimizer.get_lr() == pytest.approx(0.1)
    with open(tmp_path / "vdl" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    # one row a step; the batch logs' own "step" (the step in its epoch)
    # wins over the writer's counter, as in the reference
    assert [r["step"] for r in rows] == [0, 1] * 3
    assert all(len(r["loss"]) == 1 for r in rows)


def test_progbar_logger_prints(capsys):
    net = pnn.Linear(4, 3, device="cpu")
    model = pt.Model(net).prepare(
        pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters()),
        pnn.CrossEntropyLoss())
    model.fit(_dataset(32), batch_size=8, epochs=1, log_freq=2, verbose=2)
    out = capsys.readouterr().out
    assert "Epoch 0 step 0: loss" in out and "Epoch 0 step 2: loss" in out
    assert "Epoch 0 done in" in out


def test_model_checkpoint_saves_each_epoch(tmp_path):
    net = pnn.Linear(4, 3, device="cpu")
    model = pt.Model(net).prepare(
        pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters()),
        pnn.CrossEntropyLoss())
    cb = pt.callbacks.ModelCheckpoint(save_freq=1, save_dir=str(tmp_path))
    model.fit(_dataset(16), batch_size=8, epochs=2, verbose=0, callbacks=[cb])
    for tag in ("0", "1", "final"):
        assert os.path.exists(tmp_path / f"{tag}.pdparams")
        assert os.path.exists(tmp_path / f"{tag}.pdopt")


def test_seed_reseeds_torch_and_not_numpy():
    np.random.seed(3)
    before = np.random.get_state()[1].copy()
    pt.seed(11)
    a = torch.rand(4)
    pt.seed(11)
    b = torch.rand(4)
    assert torch.equal(a, b)
    np.testing.assert_array_equal(np.random.get_state()[1], before)
