"""What ``Model.fit`` and ``Model.save`` lean on, in the port, held
against the reference where the reference has the same observable
result:

- the StepTimer (profiler/steptimer.py): the reference's fake-clock cases
  (nesting, phases outside a step, the disabled pass-through, sampled
  syncs, per-step normalisation, the singleton), and ``sync`` on host
  tensors; the reference's wall-clock overhead ratio is not asserted
  (load-sensitive);
- the StepGuard (resilience/guard.py): a NaN step skipped with the
  parameters unchanged, the GradScaler backed off, BadStepError without a
  rollback target, a saver's rollback; and ``fit`` under
  ``FLAGS_check_nan_inf`` over a poisoned batch, where both packages skip
  the same steps and end with the same weights (1e-6);
- preemption (resilience/preempt.py): the signal handler, a drain that
  runs each action once, and ``fit`` stopping resumable;
- checkpoints (resilience/snapshot.py): ``Model.save``'s manifest and
  sidecars, ``ModelCheckpoint``'s tags, restore by manifest discovery
  past a damaged newest manifest, keep-K retention, the unported
  ``FLAGS_async_checkpoint`` raising, a manifest of either package
  verifying and restoring in the other, and exact resume of a
  DataLoader's cursor.
"""
import os
import signal

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
import paddle_tpu.nn.functional as RF  # noqa: E402
from paddle_tpu.resilience import snapshot as rsnap  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
import paddle_tpu_torch.nn.functional as PF  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.profiler import metrics as pmetrics  # noqa: E402
from paddle_tpu_torch.profiler import steptimer  # noqa: E402
from paddle_tpu_torch.resilience import guard, preempt  # noqa: E402
from paddle_tpu_torch.resilience import snapshot as snap  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_flags():
    yield
    pt.set_flags({"FLAGS_check_nan_inf": False,
                  "FLAGS_guard_max_bad_steps": 3,
                  "FLAGS_async_checkpoint": False})
    paddle.set_flags({"FLAGS_check_nan_inf": False,
                      "FLAGS_guard_max_bad_steps": 3})
    preempt.uninstall()


# -- the StepTimer -------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


def _timer(clk, **kw):
    return steptimer.StepTimer(clock=clk, enabled=True,
                               registry=pmetrics.MetricsRegistry(),
                               **{"sync_interval": 0, **kw})


def test_fake_clock_nested_phase_attribution():
    clk = FakeClock()
    st = _timer(clk)
    with st.step():
        with st.phase("step/input_wait"):
            clk.advance(0.005)
        with st.phase("step/h2d"):
            clk.advance(0.010)
        with st.phase("step/compute"):
            clk.advance(0.050)
            with st.phase("step/collective_wait"):
                clk.advance(0.020)
            clk.advance(0.020)
    b = st.breakdown()
    assert b["phase_ms"]["compute"] == pytest.approx(70.0)
    assert b["phase_ms"]["collective_wait"] == pytest.approx(20.0)
    assert b["phase_ms"]["input_wait"] == pytest.approx(5.0)
    assert b["phase_ms"]["h2d"] == pytest.approx(10.0)
    assert b["wall_ms"] == pytest.approx(105.0)
    assert b["attributed_ms"] == pytest.approx(105.0)
    assert b["unattributed_ms"] == pytest.approx(0.0)
    assert b["step_ms_p50"] == pytest.approx(105.0)
    assert sum(b["phase_fraction"].values()) == pytest.approx(1.0)


def test_phase_outside_step_accumulates_globally():
    clk = FakeClock()
    reg = pmetrics.MetricsRegistry()
    st = steptimer.StepTimer(clock=clk, sync_interval=0, enabled=True,
                             registry=reg)
    with st.phase("step/ckpt_io"):
        clk.advance(0.030)
    b = st.breakdown()
    assert b["phase_ms"]["ckpt_io"] == pytest.approx(30.0)
    assert b["unattributed_ms"] == 0.0
    assert reg.histogram_summary("steptimer.ckpt_io_ms")["count"] == 1


def test_steptimer_disabled_is_passthrough():
    clk = FakeClock()
    st = steptimer.StepTimer(clock=clk, enabled=False)
    with st.step():
        with st.phase("step/compute"):
            clk.advance(1.0)
    assert st.breakdown()["steps"] == 0
    assert st.overhead_ms == 0.0


def test_sync_interval_samples_steps_and_passes_host_values():
    clk = FakeClock()
    st = _timer(clk, sync_interval=2)
    x = torch.ones(3)
    for _ in range(4):
        with st.step():
            assert st.sync(x) is x  # a host tensor needs no wait
            assert st.sync(None) is None
            clk.advance(0.001)
    b = st.breakdown()
    assert b["steps"] == 4
    assert b["synced_steps"] == 2  # steps 0 and 2 under interval 2
    assert b["device_wait_ms"] == 0.0


def test_step_histograms_normalized_per_step():
    clk = FakeClock()
    reg = pmetrics.MetricsRegistry()
    st = steptimer.StepTimer(clock=clk, sync_interval=0, enabled=True,
                             registry=reg)
    with st.step(n_steps=4):
        with st.phase("step/compute"):
            clk.advance(0.040)
    s = reg.histogram_summary("steptimer.step_ms")
    assert s["count"] == 1 and s["sum"] == pytest.approx(10.0)
    assert reg.histogram_summary("steptimer.compute_ms")["sum"] == \
        pytest.approx(10.0)


def test_module_level_phase_uses_singleton():
    st = steptimer.get_steptimer()
    with steptimer.phase("step/ckpt_io"):
        pass
    assert "ckpt_io" in st.breakdown()["phase_ms"]
    steptimer.reset_steptimer()
    assert steptimer.get_steptimer() is not st


def test_fit_attributes_its_phases():
    steptimer.reset_steptimer()
    net = pnn.Linear(4, 1, device="cpu")
    m = pt.Model(net).prepare(
        pt.optimizer.SGD(learning_rate=0.01, parameters=net.parameters()),
        PF.mse_loss)
    rng = np.random.RandomState(0)
    ds = [(rng.randn(4).astype("float32"), rng.randn(1).astype("float32"))
          for _ in range(16)]
    m.fit(ds, batch_size=4, epochs=1, verbose=0)
    b = steptimer.get_steptimer().breakdown()
    assert b["steps"] == 4
    assert {"input_wait", "h2d", "compute", "compile"} <= set(b["phase_ms"])
    steptimer.reset_steptimer()


# -- the StepGuard -------------------------------------------------------------

def _linear_pair():
    paddle.seed(0)
    ref = paddle.nn.Linear(4, 4)
    port = pnn.Linear(4, 4, device="cpu")
    pt.load_numpy_state_dict(port, {k: np.array(v._val)
                                    for k, v in ref.state_dict().items()})
    return ref, port


def test_nan_step_skipped_params_unchanged():
    _, model = _linear_pair()
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    g = guard.StepGuard([model, opt], max_bad_steps=5)

    def step(x, y):
        loss = PF.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(8, 4).astype(np.float32))
    y = torch.tensor(rng.randn(8, 4).astype(np.float32))
    _, ok = g.guard(step, x, y)
    assert ok and g.steps == 1
    w_good = model.weight.detach().clone()
    _, ok = g.guard(step, torch.full((8, 4), float("nan")), y)
    assert not ok and g.steps == 2 and g.skipped == 1
    assert torch.equal(model.weight, w_good)


def test_scaler_backoff_on_bad_step():
    _, model = _linear_pair()
    sc = pt.amp.GradScaler(init_loss_scaling=1024.0)
    g = guard.StepGuard([model], scaler=sc, max_bad_steps=100)
    g.before_step()
    assert not g.after_step(float("nan"))
    assert float(sc._scale) == 512.0


def test_no_rollback_target_raises_bad_step_error():
    _, model = _linear_pair()
    g = guard.StepGuard([model], max_bad_steps=1)
    g.before_step()
    with pytest.raises(guard.BadStepError):
        g.after_step(float("inf"))


def test_rollback_restores_the_savers_state():
    _, model = _linear_pair()
    saved = {k: v.clone() for k, v in model.state_dict().items()}

    class Saver:
        def load_checkpoint(self):
            return {"0": saved}, {}

    with torch.no_grad():
        model.weight.add_(1.0)
    g = guard.StepGuard([model], max_bad_steps=2, saver=Saver())
    for expected_rollbacks in (0, 1):
        g.before_step()
        assert not g.after_step(torch.tensor(float("nan")))
        assert g.rollbacks == expected_rollbacks
    assert torch.equal(model.weight, saved["weight"])


def test_fit_with_check_nan_inf_matches_reference():
    """One poisoned batch of four: each package skips it, and both end
    with the same finite weights."""
    paddle.seed(0)
    rnet = paddle.nn.Linear(4, 1)
    pnet = pnn.Linear(4, 1, device="cpu")
    pt.load_numpy_state_dict(pnet, {k: np.array(v._val)
                                    for k, v in rnet.state_dict().items()})
    rng = np.random.RandomState(0)
    X = rng.randn(16, 4).astype(np.float32)
    X[4] = np.nan
    Y = rng.randn(16, 1).astype(np.float32)
    ds = [(X[i], Y[i]) for i in range(16)]
    paddle.set_flags({"FLAGS_check_nan_inf": True,
                      "FLAGS_guard_max_bad_steps": 10})
    pt.set_flags({"FLAGS_check_nan_inf": True,
                  "FLAGS_guard_max_bad_steps": 10})
    rm = paddle.Model(rnet)
    rm.prepare(optimizer=paddle.optimizer.SGD(
        learning_rate=0.01, parameters=rnet.parameters()), loss=RF.mse_loss)
    rm.fit(ds, batch_size=4, epochs=1, verbose=0, shuffle=False)
    pm = pt.Model(pnet)
    pm.prepare(optimizer=pt.optimizer.SGD(
        learning_rate=0.01, parameters=pnet.parameters()), loss=PF.mse_loss)
    pm.fit(ds, batch_size=4, epochs=1, verbose=0, shuffle=False)
    assert (pm._step_guard.steps, pm._step_guard.skipped) == \
        (rm._step_guard.steps, rm._step_guard.skipped) == (4, 1)
    assert torch.isfinite(pnet.weight).all()
    np.testing.assert_allclose(pnet.weight.detach().numpy(),
                               rnet.weight.numpy(), rtol=1e-6, atol=1e-7)


# -- preemption ----------------------------------------------------------------

def test_signal_handler_install_uninstall():
    prev = signal.getsignal(signal.SIGTERM)
    handler = preempt.install()
    assert signal.getsignal(signal.SIGTERM) == handler._on_signal
    assert preempt.install() is handler  # idempotent
    preempt.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_drain_runs_actions_once_and_survives_failures():
    h = preempt.PreemptionHandler()
    ran = []
    h.add_action(lambda: ran.append("a"), name="a")

    def broken():
        raise RuntimeError("saver died")
    h.add_action(broken, name="b")
    h.add_action(lambda: ran.append("c"), name="c")
    h.notify()
    failures = h.drain()
    assert ran == ["a", "c"]
    assert [n for n, _ in failures] == ["b"]
    assert h.drain() == []


def test_sigterm_sets_the_flag_and_check_raises_resumable():
    handler = preempt.install()
    saved = []
    handler.add_action(lambda: saved.append(True))
    os.kill(os.getpid(), signal.SIGTERM)
    assert preempt.is_preempted()
    with pytest.raises(preempt.Preempted) as exc:
        preempt.check()
    assert exc.value.code == 128 + signal.SIGTERM and saved == [True]


def test_fit_stops_resumable_on_preemption(tmp_path):
    rng = np.random.RandomState(0)
    net = pnn.Linear(4, 1, device="cpu")
    m = pt.Model(net)
    m.prepare(optimizer=pt.optimizer.SGD(
        learning_rate=0.01, parameters=net.parameters()), loss=PF.mse_loss)
    ds = [(rng.randn(4).astype(np.float32),
           rng.randn(1).astype(np.float32)) for _ in range(12)]
    handler = preempt.install()
    seen = []

    class TriggerAt(pt.callbacks.Callback):
        def on_train_batch_end(self, step, logs=None):
            seen.append(step)
            if step == 1:
                handler.notify()

    cb = preempt.PreemptionCallback(save_path=str(tmp_path / "pre"))
    with pytest.raises(preempt.Preempted):
        m.fit(ds, batch_size=4, epochs=4, verbose=0, callbacks=[TriggerAt(),
                                                               cb])
    assert m.stop_training and seen == [0, 1, 2]
    assert os.path.exists(tmp_path / "pre.pdparams")


# -- checkpoints ---------------------------------------------------------------

def _hapi_model(seed=0):
    torch.manual_seed(seed)
    net = pnn.Sequential(pnn.Linear(4, 8, device="cpu"),
                         pnn.ReLU(device="cpu"),
                         pnn.Linear(8, 3, device="cpu"))
    model = pt.Model(net)
    model.prepare(optimizer=pt.optimizer.Adam(learning_rate=0.01,
                                              parameters=net.parameters()),
                  loss=pnn.CrossEntropyLoss())
    return model


def _hapi_data(n=32):
    r = np.random.RandomState(3)
    x = r.randn(n, 4).astype(np.float32)
    y = r.randint(0, 3, (n,)).astype(np.int64)
    return pt.io.TensorDataset([x, y])


def test_model_save_commits_manifest_and_sidecars(tmp_path):
    model = _hapi_model()
    model.fit(_hapi_data(), batch_size=8, epochs=1, verbose=0)
    path = str(tmp_path / "m")
    model.save(path)
    for suffix in (".pdparams", ".pdparams.sha256", ".pdopt",
                   ".pdopt.sha256", ".pdstate"):
        assert os.path.exists(path + suffix), suffix
    mans = snap.list_manifests(str(tmp_path))
    assert len(mans) == 1
    man = snap.verify_manifest(mans[0][1])
    assert man["meta"]["tag"] == "m"
    assert {os.path.basename(r) for r in man["files"]} == \
        {"m.pdparams", "m.pdopt", "m.pdstate"}
    model.load(path)


def test_modelcheckpoint_commits_every_tag_and_restores(tmp_path):
    model = _hapi_model()
    cb = pt.callbacks.ModelCheckpoint(save_freq=1, save_dir=str(tmp_path))
    model.fit(_hapi_data(), batch_size=8, epochs=2, verbose=0,
              callbacks=[cb])
    tags = {(snap.verify_manifest(mp)["meta"] or {}).get("tag")
            for _, mp in snap.list_manifests(str(tmp_path))}
    assert {"0", "1", "final"} <= tags
    model2 = _hapi_model(seed=1)
    snap.checkpointer_for(str(tmp_path)).restore(model2.network,
                                                 model2._optimizer)
    for a, b in zip(model.network.parameters(), model2.network.parameters()):
        assert torch.equal(a, b)


def test_restore_falls_back_past_a_damaged_manifest(tmp_path):
    model = _hapi_model()
    model.save(str(tmp_path / "a"))
    first = [p.detach().clone() for p in model.network.parameters()]
    model.fit(_hapi_data(), batch_size=8, epochs=1, verbose=0)
    model.save(str(tmp_path / "b"))
    newest = snap.list_manifests(str(tmp_path))[0][1]
    data = [r for r in snap.read_manifest(newest)["files"]
            if r.endswith(".pdparams")][0]
    with open(tmp_path / data, "ab") as f:
        f.write(b"torn")

    class Journal:
        rows = []

        def record(self, kind, **fields):
            self.rows.append(kind)
    blob, mpath = snap.load_blob(str(tmp_path), journal=Journal())
    assert mpath != newest and Journal.rows == ["corrupt_restore"]
    model2 = _hapi_model(seed=2)
    snap.apply_blob(blob, model2.network)
    for a, b in zip(model2.network.parameters(), first):
        assert torch.equal(a, b)


def test_keep_k_retention(tmp_path):
    pt.set_flags({"FLAGS_ckpt_keep": 2})
    try:
        ck = snap.Checkpointer(str(tmp_path))
        for i in range(4):
            ck.save({f"t{i}.pdparams": {"w": torch.full((2,), float(i))}})
    finally:
        pt.set_flags({"FLAGS_ckpt_keep": 3})
    assert [s for s, _ in snap.list_manifests(str(tmp_path))] == [4, 3]
    assert sorted(n for n in os.listdir(tmp_path)
                  if n.endswith(".pdparams")) == ["t2.pdparams",
                                                  "t3.pdparams"]
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("data-")) \
        == ["data-0000000003", "data-0000000004"]


def test_async_checkpoint_flag_raises():
    model = _hapi_model()
    pt.set_flags({"FLAGS_async_checkpoint": True})
    with pytest.raises(NotImplementedError, match="A11"):
        model.save("unused/m")
    assert not os.path.exists("unused")


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_manifests_cross_packages(tmp_path, writer):
    sd = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    if writer == "port":
        snap.Checkpointer(str(tmp_path)).save(
            {"m.pdparams": {"w": torch.tensor(sd["w"])}}, meta={"tag": "m"})
        blob, mp = rsnap.load_blob(str(tmp_path))
        got = np.asarray(blob["model"]["w"].numpy())
    else:
        rsnap.AsyncCheckpointer(str(tmp_path), background=False).save(
            {"m.pdparams": {"w": paddle.to_tensor(sd["w"])}},
            meta={"tag": "m"}, blocking=True)
        blob, mp = snap.load_blob(str(tmp_path))
        got = blob["model"]["w"].numpy()
    assert os.path.basename(mp) == snap.manifest_name(1)
    assert blob["meta"]["tag"] == "m"
    np.testing.assert_array_equal(got, sd["w"])


def test_exact_resume_of_the_loader_cursor():
    ds = pt.io.TensorDataset([np.arange(40, dtype=np.int64)])
    dl = pt.io.DataLoader(ds, batch_size=4, shuffle=False)
    it = iter(dl)
    seen = [next(it)[0].tolist() for _ in range(3)]
    np.random.seed(9)
    state = snap.capture_train_state(loader=dl)
    draw = np.random.rand()
    assert state["cursor"]["batches_consumed"] == 3
    fresh = pt.io.DataLoader(ds, batch_size=4, shuffle=False)
    snap.restore_train_state(state, loader=fresh)
    rest = [b[0].tolist() for b in fresh]
    assert seen + rest == [list(range(i, i + 4)) for i in range(0, 40, 4)]
    assert np.random.rand() == draw
