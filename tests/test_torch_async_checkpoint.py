"""The port's zero-stall checkpoints (resilience/snapshot.py), case by
case with the reference's tests/test_snapshot.py: commit boundaries with
the committer inline and in the background, async failures surfacing
through ``flush``, manifest discovery, keep-K retention and the consumer
pins, the async half of the hapi wiring, the preempt drain landing a
pending commit before its actions, and the incubate CheckpointSaver's GC.

Across the packages: a manifest either package's AsyncCheckpointer
commits loads in the other's ``load_manifest_blob``,
``tools/ckpt_inspect.py`` verifies a port root, and a
``RecoveryManager.restart`` restores only after a held background commit
landed. Background-commit ordering is gated on events: no real sleeps.
"""
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.resilience import snapshot as rsnap  # noqa: E402

import paddle_tpu_torch as pt  # noqa: E402
import paddle_tpu_torch.nn.functional as F  # noqa: E402
from paddle_tpu_torch import nn  # noqa: E402
from paddle_tpu_torch.distributed.checkpoint import (  # noqa: E402
    load_hybrid_checkpoint, save_hybrid_checkpoint)
from paddle_tpu_torch.distributed.fleet.elastic import (  # noqa: E402
    ElasticManager, FileStore)
from paddle_tpu_torch.profiler import metrics  # noqa: E402
from paddle_tpu_torch.resilience import (faults, preempt,  # noqa: E402
                                         recovery)
from paddle_tpu_torch.resilience import snapshot as snap  # noqa: E402
from paddle_tpu_torch.resilience.snapshot import (  # noqa: E402
    AsyncCheckpointer, CheckpointCommitError, list_manifests, load_blob,
    verify_manifest)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_snapshot_state(tmp_path, monkeypatch):
    """Fresh faults, journal, generation and registry per test; artifacts
    into tmp_path; the async flag off unless a test opts in; the per-root
    checkpointers closed so no committer thread leaks across tests."""
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "artifacts"))
    pt.set_flags({"FLAGS_async_checkpoint": False, "FLAGS_ckpt_keep": 3,
                  "FLAGS_retry_backoff_base": 0.0})
    faults.reset()
    recovery.reset_generation()
    recovery.reset_journal()
    metrics.reset_registry()
    yield
    faults.reset()
    for ck in list(snap._BY_ROOT.values()):
        ck.close()
    snap._BY_ROOT.clear()
    recovery.reset_generation()
    recovery.reset_journal()
    metrics.reset_registry()
    preempt.uninstall()
    from paddle_tpu_torch.distributed import env
    env._STATE["rendezvous"] = None
    pt.set_flags({"FLAGS_async_checkpoint": False, "FLAGS_ckpt_keep": 3,
                  "FLAGS_retry_backoff_base": 0.5})


def _counters():
    return metrics.get_registry().snapshot()["counters"]


def _journal_events():
    return [e["event"] for e in recovery.get_journal().entries()]


def _payload(v):
    return {"w": np.full((3,), float(v), dtype=np.float32)}


def _files(v):
    return {"m.pdparams": (_payload(v), "model"),
            "m.pdopt": ({"lr": np.float32(v)}, "optimizer")}


def _model_w(blob):
    w = blob["model"]["w"]
    return float(np.asarray(w.numpy() if hasattr(w, "numpy") else w)[0])


def _gate(monkeypatch):
    """Hold every serialize_file on an event; returns the event."""
    release = threading.Event()
    orig = snap.serialize_file

    def gated(payload, path):
        assert release.wait(30.0), "commit gate never released"
        return orig(payload, path)
    monkeypatch.setattr(snap, "serialize_file", gated)
    return release


# -- kill mid-commit: every file boundary, inline and in the background -----

class TestCommitBoundaries:
    @pytest.mark.parametrize("boundary", [1, 2, 3])
    def test_torn_commit_leaves_previous_manifest(self, tmp_path, boundary):
        root = str(tmp_path / "ck")
        ck = AsyncCheckpointer(root, background=False)
        good = ck.save(_files(1.0), step=10, blocking=True)
        assert os.path.exists(good)
        faults.configure(f"ckpt.commit:#{boundary}")
        with pytest.raises(CheckpointCommitError):
            ck.save(_files(2.0), step=11, blocking=True)
        faults.reset()
        assert [s for s, _ in list_manifests(root)] == [1]
        blob, src = load_blob(root)
        assert src == good and blob["meta"]["step"] == 10
        assert _model_w(blob) == 1.0
        ck.save(_files(3.0), step=12, blocking=True)
        assert _model_w(load_blob(root)[0]) == 3.0

    @pytest.mark.parametrize("boundary", [1, 2, 3])
    def test_torn_background_commit_leaves_previous_manifest(
            self, tmp_path, boundary):
        root = str(tmp_path / "ck")
        ck = AsyncCheckpointer(root)
        ck.save(_files(1.0), step=10)
        assert ck.flush(timeout=30.0) == []
        faults.configure(f"ckpt.commit:#{boundary}")
        ck.save(_files(2.0), step=11)   # never raises into the caller
        errs = ck.flush(timeout=30.0)
        faults.reset()
        assert len(errs) == 1 and isinstance(errs[0][1],
                                             CheckpointCommitError)
        assert [s for s, _ in list_manifests(root)] == [1]
        assert _model_w(load_blob(root)[0]) == 1.0
        ck.save(_files(3.0), step=12)
        assert ck.flush(timeout=30.0) == []
        assert _model_w(load_blob(root)[0]) == 3.0
        ck.close()

    def test_serialize_fault_also_aborts_commit(self, tmp_path):
        root = str(tmp_path / "ck")
        ck = AsyncCheckpointer(root, background=False)
        ck.save(_files(1.0), step=1, blocking=True)
        faults.configure("ckpt.serialize:#1")
        with pytest.raises(CheckpointCommitError):
            ck.save(_files(2.0), step=2, blocking=True)
        faults.reset()
        assert _model_w(load_blob(root)[0]) == 1.0

    def test_snapshot_fault_fails_before_any_io(self, tmp_path):
        root = str(tmp_path / "ck")
        ck = AsyncCheckpointer(root, background=False)
        faults.configure("ckpt.snapshot:#1")
        with pytest.raises(CheckpointCommitError):
            ck.save(_files(1.0), blocking=True)
        faults.reset()
        assert list_manifests(root) == [] and os.listdir(root) == []

    def test_per_file_extra_info_lands_in_manifest(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False)
        mp = ck.save({"a.pdexpert": (_payload(1.0), "expert_shard",
                                     {"expert_ids": [0, 4], "ep_degree": 4,
                                      "kind": "spoofed"}),
                      "b.pdparams": (_payload(2.0), "model")},
                     step=1, blocking=True)
        files = verify_manifest(mp)["files"]
        by_name = {os.path.basename(rel): fi for rel, fi in files.items()}
        a = by_name["a.pdexpert"]
        assert a["expert_ids"] == [0, 4] and a["ep_degree"] == 4
        assert a["kind"] == "expert_shard" and a["sha256"] and a["bytes"]
        assert "expert_ids" not in by_name["b.pdparams"]

    def test_snapshot_is_a_host_copy_the_loop_cannot_touch(self, tmp_path,
                                                           monkeypatch):
        """A background commit pickles what the save copied, not what the
        next step writes into the live tensor."""
        release = _gate(monkeypatch)
        w = torch.arange(4, dtype=torch.float32)
        ck = AsyncCheckpointer(str(tmp_path / "ck"))
        ck.save({"m.pdparams": ({"w": w}, "model")}, step=1)
        w.add_(100.0)
        release.set()
        assert ck.flush(timeout=30.0) == []
        got = load_blob(ck.root)[0]["model"]["w"]
        np.testing.assert_array_equal(np.asarray(got), np.arange(4.0))
        ck.close()


# -- async semantics: errors surface through flush, never raise ------------

class TestAsyncErrors:
    def test_background_failure_counted_journaled_flushed(self, tmp_path):
        root = str(tmp_path / "ck")
        ck = AsyncCheckpointer(root)
        ck.save(_files(1.0), step=1)
        assert not ck.flush(timeout=30.0)
        faults.configure("ckpt.commit:#1")
        ck.save(_files(2.0), step=2)
        errs = ck.flush(timeout=30.0)
        faults.reset()
        assert len(errs) == 1
        assert isinstance(errs[0][1], CheckpointCommitError)
        assert _counters().get("ckpt.commit_failures_total") == 1.0
        assert "ckpt_commit_failed" in _journal_events()
        assert ck.flush(timeout=30.0) == []
        assert _model_w(load_blob(root)[0]) == 1.0
        ck.close()

    def test_flush_all_covers_live_checkpointers(self, tmp_path):
        a = AsyncCheckpointer(str(tmp_path / "a"))
        b = AsyncCheckpointer(str(tmp_path / "b"))
        a.save(_files(1.0))
        b.save(_files(2.0))
        assert snap.flush_all(timeout=30.0) == []
        assert a.pending == 0 and b.pending == 0
        assert a.latest_manifest() and b.latest_manifest()
        a.close()
        b.close()

    def test_pending_gauge_and_flush_timeout(self, tmp_path, monkeypatch):
        release = _gate(monkeypatch)
        ck = AsyncCheckpointer(str(tmp_path / "ck"))
        ck.save(_files(1.0), step=1)
        assert ck.pending == 1
        assert metrics.get_registry().snapshot()["gauges"][
            "ckpt.pending_count"] == 1.0
        assert ck.flush(timeout=0.0) == [] and ck.pending == 1
        release.set()
        assert ck.flush(timeout=30.0) == [] and ck.pending == 0
        ck.close()


# -- manifest discovery and fallback ----------------------------------------

def _resume_net(seed):
    torch.manual_seed(seed)
    net = nn.Linear(4, 3, device="cpu")
    opt = pt.optimizer.SGD(learning_rate=0.05, parameters=net.parameters())
    return net, opt


class TestManifestDiscovery:
    def test_corrupt_newest_falls_back_and_journals(self, tmp_path):
        root = str(tmp_path / "ck")
        os.makedirs(root)
        model, opt = _resume_net(7)
        pt.set_flags({"FLAGS_async_checkpoint": True})
        save_hybrid_checkpoint(os.path.join(root, "hy"), model, opt,
                               meta={"step": 2})
        save_hybrid_checkpoint(os.path.join(root, "hy"), model, opt,
                               meta={"step": 3})
        pt.set_flags({"FLAGS_async_checkpoint": False})
        assert snap.flush_all(timeout=30.0) == []
        mans = list_manifests(root)
        assert len(mans) == 2
        newest = snap.read_manifest(mans[0][1])
        victim = os.path.join(root, next(iter(newest["files"])))
        data = bytearray(open(victim, "rb").read())
        data[len(data) // 2] ^= 0xFF
        with open(victim, "wb") as f:
            f.write(bytes(data))
        model2, opt2 = _resume_net(99)
        meta = load_hybrid_checkpoint(root, model2, opt2)
        assert meta["step"] == 2 and meta["restored_from"] == mans[1][1]
        assert "corrupt_restore" in _journal_events()
        assert torch.equal(model2.weight, model.weight)

    def test_all_manifests_dead_falls_back_to_legacy_old(self, tmp_path):
        root = str(tmp_path / "ck")
        model, opt = _resume_net(7)
        save_hybrid_checkpoint(os.path.join(root, "hy"), model, opt,
                               meta={"step": 1})
        save_hybrid_checkpoint(os.path.join(root, "hy"), model, opt,
                               meta={"step": 2})
        ck = AsyncCheckpointer(root, background=False)
        ck.save(_files(9.0), step=9, blocking=True)
        for rel in snap.read_manifest(ck.latest_manifest())["files"]:
            os.remove(os.path.join(root, rel))
        blob, src = load_blob(root)
        assert src.endswith(".old")
        assert blob["meta"]["restored_from_fallback"] is True
        assert _journal_events().count("corrupt_restore") >= 1

    def test_nothing_restorable_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_blob(str(tmp_path))

    def test_load_manifest_blob_never_substitutes(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False)
        first = ck.save(_files(1.0), step=1, blocking=True)
        second = ck.save(_files(2.0), step=2, blocking=True)
        assert _model_w(snap.load_manifest_blob(first)) == 1.0
        rel = next(iter(snap.read_manifest(second)["files"]))
        with open(os.path.join(ck.root, rel), "ab") as f:
            f.write(b"torn")
        with pytest.raises(CheckpointCommitError):
            snap.load_manifest_blob(second)


# -- retention and pins ------------------------------------------------------

class TestRetention:
    def test_keep_k_never_newest_never_old(self, tmp_path):
        root = str(tmp_path / "ck")
        os.makedirs(root)
        legacy = os.path.join(root, "m.pdparams.old")
        with open(legacy, "w") as f:
            f.write("legacy fallback")
        ck = AsyncCheckpointer(root, keep=2, background=False)
        paths = [ck.save({f"s{i}.pdparams": _payload(i)}, step=i,
                         blocking=True) for i in range(5)]
        assert [s for s, _ in list_manifests(root)] == [5, 4]
        assert not os.path.exists(paths[0])
        assert not os.path.exists(os.path.join(root, "s0.pdparams"))
        for _, mp in list_manifests(root):
            verify_manifest(mp)
        assert os.path.exists(legacy)

    def test_shared_alias_survives_while_referenced(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), keep=1,
                               background=False)
        for i in range(3):
            ck.save({"m.pdparams": _payload(i)}, blocking=True)
        assert [s for s, _ in list_manifests(ck.root)] == [3]
        assert os.path.exists(os.path.join(ck.root, "m.pdparams"))
        assert _model_w(load_blob(ck.root)[0]) == 2.0
        dirs = [n for n in os.listdir(ck.root) if snap.DATA_DIR_RE.match(n)]
        assert dirs == [snap._data_dir(3)]

    def test_gc_failures_counted_not_raised(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), keep=1,
                               background=False)
        ck.save({"a.pdparams": _payload(0)}, blocking=True)
        faults.configure("fs.remove:1.0")
        ck.save({"b.pdparams": _payload(1)}, blocking=True)
        faults.reset()
        assert _counters().get("ckpt.gc_failures_total", 0) >= 1.0
        ck.save({"c.pdparams": _payload(2)}, blocking=True)
        assert [s for s, _ in list_manifests(ck.root)] == [3]

    def test_pinned_manifest_survives_keep_k(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), keep=1,
                               background=False)
        first = ck.save({"a.pdparams": _payload(0)}, blocking=True)
        pin = snap.write_pin(ck.root, "rollout", [first, None],
                             meta={"version": 1})
        assert os.path.basename(pin) == "rollout.json"
        assert snap.read_pins(ck.root) == {
            "rollout": [os.path.basename(first)]}
        for i in range(1, 4):
            ck.save({f"s{i}.pdparams": _payload(i)}, blocking=True)
        assert [s for s, _ in list_manifests(ck.root)] == [4, 1]
        verify_manifest(first)
        assert snap.pinned_manifests(ck.root) == {os.path.basename(first)}
        snap.clear_pin(ck.root, "rollout")
        ck.save({"s5.pdparams": _payload(5)}, blocking=True)
        assert [s for s, _ in list_manifests(ck.root)] == [5]

    def test_unreadable_pin_pins_nothing(self, tmp_path):
        root = str(tmp_path / "ck")
        os.makedirs(os.path.join(root, snap.PINS_DIR))
        with open(os.path.join(root, snap.PINS_DIR, "bad.json"), "w") as f:
            f.write("{not json")
        assert snap.read_pins(root) == {}
        # the reference reads the port's pin file as its own
        snap.write_pin(root, "c", ["manifest-0000000002.json"])
        assert rsnap.read_pins(root) == {"c": ["manifest-0000000002.json"]}

    def test_protected_files_name_manifest_data_and_aliases(self, tmp_path):
        ck = AsyncCheckpointer(str(tmp_path / "ck"), background=False)
        mp = ck.save({"m.pdparams": _payload(1)}, blocking=True)
        got = snap.protected_files(ck.root)
        rel = next(iter(snap.read_manifest(mp)["files"]))
        for p in (mp, os.path.join(ck.root, rel),
                  os.path.join(ck.root, rel) + ".sha256",
                  os.path.join(ck.root, "m.pdparams")):
            assert os.path.abspath(p) in got, p
        assert got == rsnap.protected_files(ck.root)


# -- hapi wiring and the flag ------------------------------------------------

def _hapi_model(seed=0):
    torch.manual_seed(seed)
    net = nn.Sequential(nn.Linear(4, 8, device="cpu"), nn.ReLU(),
                        nn.Linear(8, 3, device="cpu"))
    model = pt.Model(net)
    model.prepare(optimizer=pt.optimizer.Adam(learning_rate=0.01,
                                              parameters=net.parameters()),
                  loss=nn.CrossEntropyLoss())
    return model


def _hapi_data(n=32):
    r = np.random.RandomState(3)
    x = r.randn(n, 4).astype(np.float32)
    y = r.randint(0, 3, (n,)).astype(np.int64)
    return pt.io.TensorDataset([x, y])


class TestHapiWiring:
    def test_model_save_async_is_restorable_after_flush(self, tmp_path):
        pt.set_flags({"FLAGS_async_checkpoint": True})
        model = _hapi_model()
        model.fit(_hapi_data(), batch_size=8, epochs=1, verbose=0)
        path = str(tmp_path / "m")
        model.save(path)
        assert snap.flush_all(timeout=30.0) == []
        man = verify_manifest(list_manifests(str(tmp_path))[0][1])
        assert "m.pdstate" in {os.path.basename(r) for r in man["files"]}
        model.load(path)
        model2 = _hapi_model(seed=1)
        meta = load_hybrid_checkpoint(str(tmp_path), model2.network,
                                      model2._optimizer)
        assert meta["tag"] == "m"
        for a, b in zip(model.network.parameters(),
                        model2.network.parameters()):
            assert torch.equal(a, b)

    def test_modelcheckpoint_commits_in_the_background(self, tmp_path):
        pt.set_flags({"FLAGS_async_checkpoint": True})
        model = _hapi_model()
        cb = pt.callbacks.ModelCheckpoint(save_freq=1,
                                          save_dir=str(tmp_path))
        model.fit(_hapi_data(), batch_size=8, epochs=2, verbose=0,
                  callbacks=[cb])
        assert snap.checkpointer_for(str(tmp_path)).background
        assert snap.flush_all(timeout=30.0) == []
        tags = {(verify_manifest(mp)["meta"] or {}).get("tag")
                for _, mp in list_manifests(str(tmp_path))}
        assert {"0", "1", "final"} <= tags
        load_hybrid_checkpoint(str(tmp_path), _hapi_model(seed=2).network)

    def test_blocking_save_overrides_the_flag(self, tmp_path):
        pt.set_flags({"FLAGS_async_checkpoint": True})
        model = _hapi_model()
        mp = snap.save_model(model.network, model._optimizer,
                             str(tmp_path / "m"), blocking=True)
        assert os.path.exists(mp)
        assert not snap.checkpointer_for(str(tmp_path),
                                         background=False).background


# -- preempt ordering ----------------------------------------------------------

class TestPreemptFlush:
    def test_drain_lands_pending_commits_before_actions(self, tmp_path,
                                                        monkeypatch):
        release = _gate(monkeypatch)
        ck = AsyncCheckpointer(str(tmp_path / "ck"))
        ck.save(_files(1.0), step=1)
        seen = []
        handler = preempt.PreemptionHandler()
        handler.add_action(lambda: seen.append(ck.latest_manifest()))
        done = []
        t = threading.Thread(
            target=lambda: done.extend(handler.drain() or [()]))
        t.start()
        assert t.is_alive() and seen == []
        release.set()
        t.join(timeout=30.0)
        assert not t.is_alive()
        assert seen and seen[0] is not None and os.path.exists(seen[0])
        ck.close()


# -- RecoveryManager.restart flushes before it restores ------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TestRecoveryFlush:
    def test_restart_restores_only_after_a_held_commit_lands(
            self, tmp_path, monkeypatch):
        from paddle_tpu_torch.resilience.recovery import RecoveryManager
        from paddle_tpu_torch.resilience.watchdog import PeerAbort
        clock = FakeClock()
        em = ElasticManager(FileStore(str(tmp_path / "store"), ttl=1e6),
                            "job", np_min=1, np_max=1, rank=0,
                            endpoint="h0:1", clock=clock,
                            sleep=clock.advance)
        em.register()
        ck = AsyncCheckpointer(str(tmp_path / "ck"))
        ck.save(_files(1.0), step=1)
        assert ck.flush(timeout=30.0) == []
        release = _gate(monkeypatch)
        ck.save(_files(2.0), step=2)          # held by the gate
        seen = []

        def restore(gen):
            blob, mp = load_blob(ck.root)
            seen.append((gen, _model_w(blob), os.path.basename(mp)))
            return blob["meta"]

        rm = RecoveryManager(em, restore=restore, max_restarts=1,
                             rendezvous_timeout=5.0, backoff_base=0.0,
                             sleep=clock.advance)
        out = []
        t = threading.Thread(target=lambda: out.append(rm.restart(
            cause=PeerAbort(1, section="collective.all_reduce",
                            reason="injected"))))
        t.start()
        t.join(timeout=0.5)
        assert t.is_alive() and seen == []   # parked in flush_all
        release.set()
        t.join(timeout=30.0)
        assert not t.is_alive()
        assert seen == [(1, 2.0, snap.manifest_name(2))]
        assert out[0]["step"] == 2
        ck.close()


# -- the incubate CheckpointSaver's retention ----------------------------------

class TestCheckpointSaverGC:
    def _saver(self, tmp_path):
        from paddle_tpu_torch.distributed.fleet.fs import LocalFS
        from paddle_tpu_torch.incubate.checkpoint import CheckpointSaver
        root = tmp_path / "auto"
        root.mkdir()
        return CheckpointSaver(LocalFS(), str(root / "snap")), root

    def test_sweeps_staging_and_stale_epochs_only(self, tmp_path):
        saver, root = self._saver(tmp_path)
        for name in ("snap", "snap.old", "snap.tmp", "snap.tmpXYZ",
                     "snap.e1", "snap.e2", "snap.e3"):
            (root / name).mkdir()
        assert saver.clean_redundant_epochs(keep=1) == 4
        assert sorted(os.listdir(root)) == ["snap", "snap.e3", "snap.old"]

    def test_manifest_referenced_files_protected(self, tmp_path):
        saver, root = self._saver(tmp_path)
        (root / "snap").mkdir()
        ck = AsyncCheckpointer(str(root), background=False)
        ck.save({"snap.e1": (_payload(1), "blob")}, blocking=True)
        (root / "snap.e2").mkdir()
        (root / "snap.e3").mkdir()
        saver.clean_redundant_epochs(keep=1)
        assert (root / "snap.e1").exists()
        assert (root / "snap.e3").exists()
        assert not (root / "snap.e2").exists()

    def test_remove_failures_counted_not_raised(self, tmp_path):
        saver, root = self._saver(tmp_path)
        (root / "snap.tmpA").mkdir()
        faults.configure("fs.remove:1.0")
        removed = saver.clean_redundant_epochs()
        faults.reset()
        assert removed == 0 and (root / "snap.tmpA").exists()
        assert _counters().get("ckpt.gc_failures_total") == 1.0

    def test_snapshot_calls_gc(self, tmp_path):
        from paddle_tpu_torch.incubate import checkpoint as inc
        inc.register()
        tr = inc.TrainEpochRange(2, "t", checkpoint_path=str(tmp_path))
        stale = os.path.join(os.path.dirname(tr._saver._path),
                             os.path.basename(tr._saver._path) + ".tmpOLD")
        os.makedirs(stale)
        tr._snapshot(0)
        assert not os.path.exists(stale)


# -- across the packages ---------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("background", [False, True])
def test_manifest_loads_in_the_other_package(tmp_path, writer, background):
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    files = {"m.pdparams": ({"w": w}, "model", {"note": "x"})}
    root = str(tmp_path / "ck")
    if writer == "port":
        ck = AsyncCheckpointer(root, background=background)
        mp = ck.save({"m.pdparams": ({"w": torch.tensor(w)}, "model",
                                     {"note": "x"})}, step=5,
                     meta={"tag": "m"})
        assert ck.flush(timeout=30.0) == []
        blob = rsnap.load_manifest_blob(mp)
        got = np.asarray(blob["model"]["w"].numpy())
        ck.close()
    else:
        ck = rsnap.AsyncCheckpointer(root, background=background)
        mp = ck.save({"m.pdparams": ({"w": paddle.to_tensor(w)}, "model",
                                     {"note": "x"})}, step=5,
                     meta={"tag": "m"})
        assert ck.flush(timeout=30.0) == []
        blob = snap.load_manifest_blob(mp)
        got = np.asarray(blob["model"]["w"])
        ck.close()
    assert files and blob["meta"]["tag"] == "m" and blob["meta"]["step"] == 5
    assert snap.read_manifest(mp)["files"][
        f"{snap._data_dir(1)}/m.pdparams"]["note"] == "x"
    np.testing.assert_array_equal(got, w)


def test_bf16_snapshot_loads_in_the_reference(tmp_path):
    t = torch.randn(3, 5).to(torch.bfloat16)
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    mp = ck.save({"m.pdparams": ({"w": t}, "model")})
    assert ck.flush(timeout=30.0) == []
    got = rsnap.load_manifest_blob(mp)["model"]["w"]
    assert str(got.dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(got._val if hasattr(got, "_val") else got)
        .astype(np.float32), t.float().numpy())
    ck.close()


def _inspect_mod():
    spec = importlib.util.spec_from_file_location(
        "ckpt_inspect", os.path.join(REPO, "tools", "ckpt_inspect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ckpt_inspect_verifies_a_port_root(tmp_path, capsys):
    ci = _inspect_mod()
    root = str(tmp_path / "ck")
    ck = AsyncCheckpointer(root)
    ck.save(_files(1.0), step=7, meta={"generation": 3})
    assert ck.flush(timeout=30.0) == []
    snap.write_pin(root, "rollout", [ck.latest_manifest()])
    assert ci.main([root]) == 0
    out = capsys.readouterr().out
    assert "step=7" in out and "gen=3" in out
    assert "restore would pick: manifest-0000000001.json" in out
    assert ci.main(["--json", root]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["restore_pick"].endswith("manifest-0000000001.json")
    ck.close()
