"""fleet's file systems and auto-checkpoint of the port
(paddle_tpu_torch/distributed/fleet/fs.py, incubate/checkpoint.py)
against the reference's: LocalFS gives the reference's answers on one
temporary tree, HDFSClient raises without hadoop as the reference's does,
and ``train_epoch_range`` resumes a crashed run after its last saved
epoch, with the weights of a run that never crashed (and of the
reference's run from the same weights within f32 1e-6); a torn snapshot
falls back to ``.old`` and journals ``corrupt_restore``."""
import os

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.distributed.fleet import LocalFS
from paddle_tpu_torch.distributed.fleet import fs as pt_fs
from paddle_tpu_torch.incubate import checkpoint as acp
from paddle_tpu_torch.resilience import recovery

torch.set_num_threads(1)


def _fs_script(fs, root):
    """A sequence of LocalFS calls and what each answered."""
    out = []
    d = os.path.join(root, "dir")
    f = os.path.join(d, "a.txt")
    fs.mkdirs(d)
    out.append(("dir", fs.is_dir(d), fs.is_exist(d), fs.is_file(d)))
    fs.touch(f)
    fs.touch(f)  # exist_ok
    out.append(("ls", fs.ls_dir(d), fs.is_file(f)))
    try:
        fs.touch(f, exist_ok=False)
    except Exception as e:  # noqa: BLE001 - the type is the answer
        out.append(("touch_again", type(e).__name__))
    fs.mv(f, os.path.join(d, "b.txt"))
    out.append(("mv", fs.ls_dir(d), fs.list_dirs(root)))
    try:
        fs.mv(os.path.join(d, "nope"), os.path.join(d, "c"))
    except Exception as e:  # noqa: BLE001
        out.append(("mv_missing", type(e).__name__))
    with open(os.path.join(d, "c.txt"), "w") as fh:
        fh.write("hello")
    out.append(("cat", fs.cat(os.path.join(d, "c.txt"))))
    try:
        fs.mv(os.path.join(d, "b.txt"), os.path.join(d, "c.txt"))
    except Exception as e:  # noqa: BLE001
        out.append(("mv_exists", type(e).__name__))
    fs.mv(os.path.join(d, "b.txt"), os.path.join(d, "c.txt"),
          overwrite=True)
    out.append(("overwrite", sorted(fs.ls_dir(d)[1])))
    fs.upload(d, os.path.join(root, "up"))
    out.append(("upload", sorted(fs.ls_dir(os.path.join(root, "up"))[1])))
    fs.download(os.path.join(root, "up", "c.txt"),
                os.path.join(root, "down.txt"))
    out.append(("download", fs.is_file(os.path.join(root, "down.txt"))))
    fs.rename(os.path.join(root, "down.txt"), os.path.join(root, "r.txt"))
    out.append(("rename", sorted(fs.ls_dir(root)[1]),
                sorted(fs.list_dirs(root))))
    fs.delete(d)
    fs.delete(d)  # a second delete is a no-op
    out.append(("delete", fs.is_exist(d), fs.ls_dir(d),
                fs.need_upload_download()))
    return out


def test_local_fs_gives_the_references_answers(tmp_path):
    from paddle_tpu.distributed.fleet import LocalFS as RefFS
    mine = _fs_script(LocalFS(), str(tmp_path / "port"))
    theirs = _fs_script(RefFS(), str(tmp_path / "ref"))
    assert mine == theirs
    assert ("touch_again", "FSFileExistsError") in mine
    assert ("mv_missing", "FSFileNotExistsError") in mine


def test_hdfs_client_without_hadoop_raises_as_the_reference(monkeypatch):
    from paddle_tpu.distributed.fleet import fs as ref_fs
    monkeypatch.setenv("PATH", "")
    for mod in (pt_fs, ref_fs):
        client = mod.HDFSClient()
        assert client.need_upload_download() is True
        with pytest.raises(mod.ExecuteError, match="hadoop CLI"):
            client.mkdirs("/x")
        assert client.is_exist("/x") is False


def _ref_linear():
    import paddle_tpu
    paddle_tpu.seed(0)
    return {k: np.asarray(v._val)
            for k, v in paddle_tpu.nn.Linear(4, 4).state_dict().items()}


def _make():
    model = pt.nn.Linear(4, 4, device="cpu")
    pt.load_numpy_state_dict(model, _ref_linear())
    opt = pt.optimizer.Adam(learning_rate=0.1, parameters=model.parameters())
    return model, opt


def _batch(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(8, 4).astype(np.float32),
            rng.randn(8, 4).astype(np.float32))


def _train_epoch(model, opt, seed):
    x, y = _batch(seed)
    loss = pt.nn.functional.mse_loss(model(torch.tensor(x)),
                                     torch.tensor(y))
    loss.backward()
    opt.step()
    opt.clear_grad()


def _ref_weights(epochs):
    import paddle_tpu
    import paddle_tpu.nn.functional as RF
    paddle_tpu.seed(0)
    model = paddle_tpu.nn.Linear(4, 4)
    opt = paddle_tpu.optimizer.Adam(learning_rate=0.1,
                                    parameters=model.parameters())
    for e in range(epochs):
        x, y = _batch(e)
        loss = RF.mse_loss(model(paddle_tpu.to_tensor(x)),
                           paddle_tpu.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
    return {k: np.asarray(v._val) for k, v in model.state_dict().items()}


def test_disabled_passthrough(monkeypatch):
    monkeypatch.delenv("PADDLE_RUNNING_ENV", raising=False)
    assert list(acp.train_epoch_range(3)) == [0, 1, 2]


def test_crash_resume_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "acp")
    monkeypatch.setenv("PADDLE_JOB_ID", "job_resume_test")
    model_ref, opt_ref = _make()
    for e in range(5):
        _train_epoch(model_ref, opt_ref, e)

    # crashing run: dies inside epoch 2, after epoch 1's snapshot
    model_a, opt_a = _make()
    acp.register(model_a, opt_a)
    seen = []
    with pytest.raises(RuntimeError, match="simulated crash"):
        for e in acp.train_epoch_range(5, checkpoint_path=ckpt, name="m"):
            _train_epoch(model_a, opt_a, e)
            seen.append(e)
            if e == 2:
                raise RuntimeError("simulated crash")
    assert seen == [0, 1, 2]

    # relaunch: fresh objects resume at epoch 2, Adam's moments restored
    model_b, opt_b = _make()
    acp.register(model_b, opt_b)
    seen_b = []
    for e in acp.train_epoch_range(5, checkpoint_path=ckpt, name="m"):
        _train_epoch(model_b, opt_b, e)
        seen_b.append(e)
    assert seen_b == [2, 3, 4]
    for k, v in model_b.state_dict().items():
        assert torch.equal(v, model_ref.state_dict()[k]), k
    for k, v in _ref_weights(5).items():
        np.testing.assert_allclose(model_b.state_dict()[k].numpy(), v,
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_interval_snapshotting(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_JOB_ID", "job_inter")
    ckpt = str(tmp_path / "acp2")
    model, opt = _make()
    acp.register(model, opt)
    for e in acp.train_epoch_range(4, save_checkpoint_inter=2,
                                   checkpoint_path=ckpt, name="m2"):
        _train_epoch(model, opt, e)
    model2, opt2 = _make()
    acp.register(model2, opt2)
    assert list(acp.train_epoch_range(4, checkpoint_path=ckpt,
                                      name="m2")) == []


def test_torn_snapshot_falls_back_and_journals(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_ARTIFACTS_DIR", str(tmp_path / "art"))
    recovery.reset_journal()
    fs = LocalFS()
    saver = acp.CheckpointSaver(fs, str(tmp_path / "snap"))
    saver.save_checkpoint({"w": torch.ones(2)}, {"epoch_no": 0})
    saver.save_checkpoint({"w": torch.full((2,), 2.0)}, {"epoch_no": 1})
    with open(tmp_path / "snap" / "state.pdparams", "ab") as f:
        f.write(b"torn")
    state, meta = saver.load_checkpoint()
    assert meta["epoch_no"] == 0 and torch.equal(state["w"], torch.ones(2))
    (entry,) = recovery.get_journal().entries()
    assert entry["event"] == "corrupt_restore"
    assert "checksum mismatch" in entry["detail"]
    with pytest.raises(acp.CorruptSnapshotError):
        saver._read_snapshot(str(tmp_path / "nowhere"))
    recovery.reset_journal()
