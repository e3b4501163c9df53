"""Auto-checkpoint: transparent periodic train-state snapshots and resume
(port of paddle_tpu/incubate/checkpoint.py).

Paddle's fluid/incubate/checkpoint/auto_checkpoint.py and
checkpoint_saver.py: ``train_epoch_range(n)`` yields epoch indices,
snapshots the registered state to an FS between epochs, keyed by job id
and name, and on a relaunch resumes after the last saved epoch. The
state is the state_dicts of the Layers and Optimizers given to
``register``; storage goes through the fleet FS abstraction
(``distributed/fleet/fs.py``); the snapshot itself is the framework's
``save`` (``framework/io_utils.py``, the reference's pickle of numpy
arrays), beside a meta.json with its sha256. Enabled when
PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT (the reference's contract)
or when ``train_epoch_range`` is given a checkpoint_path.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile

from ..resilience.faults import maybe_inject
from ..resilience.retry import retry_call

__all__ = ["train_epoch_range", "register", "CheckpointSaver",
           "CorruptSnapshotError", "_get_train_epoch_range"]


def _file_sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CorruptSnapshotError(RuntimeError):
    """A snapshot directory exists but its payload is unreadable or fails
    the meta.json checksum."""

g_train_epoch_range = None
_g_registered = []


def register(*objs):
    """Set the EXACT list of Layers/Optimizers whose state_dict is
    checkpointed — each call REPLACES the previous registration (resume
    restores by position, so the set must be declared atomically:
    `register(model, opt)`, not two separate calls). Call before entering
    train_epoch_range (the dygraph analog of the reference's executor
    auto-capture)."""
    _g_registered.clear()
    _g_registered.extend(objs)


class CheckpointSaver:
    """checkpoint_saver.py parity over an FS object. Serialization happens in
    a local staging dir; remote FSes (need_upload_download) get the staged
    dir uploaded/downloaded as a unit."""

    def __init__(self, fs, path):
        self._fs = fs
        self._path = path

    def save_checkpoint(self, state, meta):
        import shutil

        from ..framework.io_utils import save as save_obj
        stage = tempfile.mkdtemp(prefix="paddle_tpu_ckpt_")
        try:
            save_obj(state, os.path.join(stage, "state.pdparams"))
            # checksum lets load_checkpoint detect a torn/corrupted payload
            # even when meta.json itself survived intact
            meta = dict(meta)
            meta["checksum"] = _file_sha256(
                os.path.join(stage, "state.pdparams"))
            with open(os.path.join(stage, "meta.json"), "w") as f:
                json.dump(meta, f)
            tmp = self._path + ".tmp"
            old = self._path + ".old"

            def _stage_in():
                self._fs.delete(tmp)
                maybe_inject("fs.upload")
                if self._fs.need_upload_download():
                    self._fs.upload(stage, tmp)
                else:
                    shutil.copytree(stage, tmp)

            retry_call(_stage_in, retry_on=Exception)
            # crash-safe swap: the previous snapshot moves aside and STAYS
            # there — `.old` doubles as the corruption fallback, so the mv
            # window AND a torn current snapshot both recover from it
            self._fs.delete(old)
            if self._fs.is_exist(self._path):
                retry_call(self._fs.mv, self._path, old,
                           retry_on=Exception)
            retry_call(self._fs.mv, tmp, self._path, retry_on=Exception)
        finally:
            shutil.rmtree(stage, ignore_errors=True)

    def _read_snapshot(self, fs_path):
        """Fetch + validate one snapshot dir; raises CorruptSnapshotError on
        checksum mismatch or an unreadable payload."""
        import shutil

        from ..framework.io_utils import load as load_obj
        local = fs_path
        stage = None
        try:
            if self._fs.need_upload_download():
                stage = tempfile.mkdtemp(prefix="paddle_tpu_ckpt_")
                retry_call(self._fs.download, fs_path, stage,
                           retry_on=Exception)
                local = os.path.join(stage, os.path.basename(fs_path))
                if not os.path.isdir(local):
                    local = stage
            try:
                with open(os.path.join(local, "meta.json")) as f:
                    meta = json.load(f)
            except (OSError, ValueError) as e:
                raise CorruptSnapshotError(f"{fs_path}: bad meta.json: {e}")
            payload = os.path.join(local, "state.pdparams")
            want = meta.get("checksum")
            if want is not None:
                try:
                    got = _file_sha256(payload)
                except OSError as e:
                    raise CorruptSnapshotError(f"{fs_path}: {e}")
                if got != want:
                    raise CorruptSnapshotError(
                        f"{fs_path}: state.pdparams checksum mismatch "
                        f"(got {got[:12]}, want {want[:12]})")
            try:
                state = load_obj(payload)
            except Exception as e:
                raise CorruptSnapshotError(
                    f"{fs_path}: unreadable state.pdparams: {e}")
            return state, meta
        finally:
            if stage is not None:
                shutil.rmtree(stage, ignore_errors=True)

    def load_checkpoint(self):
        old = self._path + ".old"
        if not self._fs.is_exist(os.path.join(self._path, "meta.json")):
            # crash fell between the swap's mv steps: recover the snapshot
            # that was renamed aside by save_checkpoint
            if self._fs.is_exist(os.path.join(old, "meta.json")):
                self._fs.mv(old, self._path)
            else:
                return None, None
        try:
            return self._read_snapshot(self._path)
        except CorruptSnapshotError as e:
            # torn current snapshot (e.g. partial write before a crash):
            # fall back to the retained previous snapshot and promote it so
            # the next save swaps against a healthy current. Journaled as a
            # corrupt_restore cause — losing a snapshot to corruption is a
            # health signal (disk/SDC), not just an inconvenience.
            try:
                from ..resilience.recovery import get_journal
                get_journal().record("corrupt_restore", path=self._path,
                                     detail=str(e), fallback=old)
            except Exception:
                pass
            if not self._fs.is_exist(os.path.join(old, "meta.json")):
                return None, None
            state, meta = self._read_snapshot(old)  # may raise: both torn
            self._fs.delete(self._path)
            self._fs.mv(old, self._path)
            return state, meta

    def clean_redundant_epochs(self, keep=1):
        """Retention GC for the snapshot family rooted at ``self._path``.

        Deletable: leftover ``.tmp*`` staging dirs (a crash mid-swap strands
        them) and numbered ``.e<N>`` epoch archives beyond the newest
        ``keep``. NEVER deletable: the live snapshot, the ``.old`` crash/
        corruption fallback, and anything referenced by a committed
        manifest in the same directory (``snapshot.protected_files``, where
        the snapshot module has it). ``fs.remove`` failures are counted
        into ``ckpt.gc_failures_total``: GC is advisory, and a failed
        delete must never take down a save path."""
        import re

        root = os.path.dirname(self._path) or "."
        base = os.path.basename(self._path)
        try:
            _dirs, _files = self._fs.ls_dir(root)
            entries = list(_dirs) + list(_files)
        except Exception:
            return 0
        protected = {self._path, self._path + ".old"}
        try:
            from ..resilience import snapshot as _snapshot
            protected |= _snapshot.protected_files(root)
        except Exception:
            pass

        epoch_re = re.compile(re.escape(base) + r"\.e(\d+)$")
        epochs = []   # (epoch_no, abspath)
        doomed = []
        for name in entries:
            full = os.path.join(root, name)
            m = epoch_re.match(name)
            if m:
                epochs.append((int(m.group(1)), full))
            elif name.startswith(base + ".tmp"):
                doomed.append(full)
        epochs.sort(reverse=True)
        doomed.extend(p for _, p in epochs[max(0, int(keep)):])

        removed = 0
        for full in doomed:
            if full in protected or full.endswith(".old"):
                continue
            try:
                maybe_inject("fs.remove", OSError)
                self._fs.delete(full)
                removed += 1
            except OSError:
                try:
                    from ..profiler.metrics import get_registry
                    get_registry().inc_counter("ckpt.gc_failures_total")
                except Exception:
                    pass
        return removed


class TrainEpochRange:
    def __init__(self, max_epoch_num, name, checkpoint_path=None,
                 save_checkpoint_inter=1, fs=None):
        from ..distributed.fleet.fs import LocalFS
        self.name = name
        self.max_epoch_num = max_epoch_num
        self.save_checkpoint_inter = save_checkpoint_inter
        self.restored_from = None
        root = checkpoint_path or os.environ.get(
            "PADDLE_EDL_FS_CHECKPOINT_DIR",
            os.path.join(tempfile.gettempdir(), "paddle_tpu_auto_ckpt"))
        job = os.environ.get("PADDLE_JOB_ID", "default_job")
        key = hashlib.md5(f"{job}:{name}".encode()).hexdigest()[:16]
        self._fs = fs or LocalFS()
        self._fs.mkdirs(root)
        self._saver = CheckpointSaver(self._fs, os.path.join(root, key))
        self._start_epoch = 0
        state, meta = self._saver.load_checkpoint()
        if meta is not None and meta.get("max_epoch_num") == max_epoch_num:
            self._start_epoch = meta["epoch_no"] + 1
            self.restored_from = "CHECKPOINT"
            self._restore(state)

    def _restore(self, state):
        for i, obj in enumerate(_g_registered):
            sub = state.get(str(i))
            if sub is not None and hasattr(obj, "set_state_dict"):
                obj.set_state_dict(sub)

    def _snapshot(self, epoch_no, extra=None):
        state = {str(i): obj.state_dict()
                 for i, obj in enumerate(_g_registered)
                 if hasattr(obj, "state_dict")}
        meta = {"epoch_no": epoch_no, "max_epoch_num": self.max_epoch_num,
                "name": self.name}
        from ..resilience.recovery import current_generation
        gen = current_generation()
        if gen:
            # which incarnation of the collective group wrote this snapshot
            meta["generation"] = gen
        if extra:
            meta.update(extra)
        self._saver.save_checkpoint(state, meta)
        # retention: sweep stranded staging dirs / stale epoch archives
        # after every successful save (failures counted, never raised)
        self._saver.clean_redundant_epochs()

    def next(self):
        from ..resilience import preempt
        epoch_done = self._start_epoch - 1
        for epoch in range(self._start_epoch, self.max_epoch_num):
            self._check_preempt(preempt, epoch_done)
            yield epoch
            epoch_done = epoch
            if (epoch + 1) % self.save_checkpoint_inter == 0 or \
                    epoch == self.max_epoch_num - 1:
                self._snapshot(epoch)
            self._check_preempt(preempt, epoch_done)

    def _check_preempt(self, preempt, epoch_done):
        """Epoch-boundary preemption poll: one emergency snapshot stamped
        `preempted`, then a resumable SystemExit (preempt.Preempted)."""
        handler = preempt.get_handler()
        if handler is None or not handler.is_preempted():
            return
        self._snapshot(epoch_done, extra={"preempted": True})
        handler.drain()
        raise preempt.Preempted(handler._signum)


def _get_train_epoch_range():
    return g_train_epoch_range


def _enabled(checkpoint_path):
    return checkpoint_path is not None or os.environ.get(
        "PADDLE_RUNNING_ENV") == "PADDLE_EDL_AUTO_CHECKPOINT"


def train_epoch_range(max_epoch_num, save_checkpoint_inter=1,
                      checkpoint_path=None, name="train", fs=None):
    """auto_checkpoint.py:598 parity. Yields epoch numbers, resuming past
    completed epochs after a crash/relaunch."""
    global g_train_epoch_range
    if not _enabled(checkpoint_path):
        yield from range(max_epoch_num)
        return
    g_train_epoch_range = TrainEpochRange(
        max_epoch_num, name, checkpoint_path=checkpoint_path,
        save_checkpoint_inter=save_checkpoint_inter, fs=fs)
    try:
        yield from g_train_epoch_range.next()
    finally:
        g_train_epoch_range = None
