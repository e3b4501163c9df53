"""Filesystem abstraction for checkpoint and save paths (port of
paddle_tpu/distributed/fleet/fs.py).

Paddle's fleet/utils/fs.py: the FS base, LocalFS and HDFSClient (driven by
the hadoop CLI), so auto-checkpoint and fleet save paths are
storage-agnostic. HDFSClient shells out to `hadoop fs` when it is on the
PATH and raises ExecuteError otherwise, as the reference does.
"""
from __future__ import annotations

import os
import shutil
import subprocess

from ...resilience.faults import maybe_inject
from ...resilience.retry import retry_call

__all__ = ["FS", "LocalFS", "HDFSClient", "ExecuteError",
           "FSFileExistsError", "FSFileNotExistsError", "FSTimeOut",
           "FSShellCmdAborted"]


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FSShellCmdAborted(ExecuteError):
    pass


class FS:
    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def list_dirs(self, fs_path):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError

    def cat(self, fs_path=None):
        raise NotImplementedError


class LocalFS(FS):
    def ls_dir(self, fs_path):
        """Returns (dirs, files) (fs.py:132 contract)."""
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in os.listdir(fs_path):
            if os.path.isdir(os.path.join(fs_path, name)):
                dirs.append(name)
            else:
                files.append(name)
        return dirs, files

    def mkdirs(self, fs_path):
        assert not os.path.isfile(fs_path), f"{fs_path} is already a file"
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def delete(self, fs_path):
        if not self.is_exist(fs_path):
            return
        if os.path.isfile(fs_path) or os.path.islink(fs_path):
            os.remove(fs_path)
        else:
            shutil.rmtree(fs_path)

    def need_upload_download(self):
        return False

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(fs_path)
        with open(fs_path, "a"):
            pass

    def upload(self, local_path, fs_path):
        """Local staging copy (dir or file). Injection site: fs.upload."""
        def _once():
            maybe_inject("fs.upload", ExecuteError)
            self.delete(fs_path)
            if os.path.isdir(local_path):
                shutil.copytree(local_path, fs_path)
            else:
                shutil.copy2(local_path, fs_path)
        retry_call(_once, retry_on=(ExecuteError, FSTimeOut, OSError))

    def download(self, fs_path, local_path):
        def _once():
            maybe_inject("fs.download", ExecuteError)
            self.delete(local_path)
            if os.path.isdir(fs_path):
                shutil.copytree(fs_path, local_path)
            else:
                shutil.copy2(fs_path, local_path)
        retry_call(_once, retry_on=(ExecuteError, FSTimeOut, OSError))

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        # injected BEFORE any state change, so a simulated mv fault is
        # always safely retryable by the caller
        maybe_inject("fs.mv", ExecuteError)
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if overwrite and self.is_exist(dst_path):
            self.delete(dst_path)
        if self.is_exist(dst_path):
            raise FSFileExistsError(dst_path)
        os.rename(src_path, dst_path)

    def list_dirs(self, fs_path):
        if not self.is_exist(fs_path):
            return []
        return [d for d in os.listdir(fs_path)
                if os.path.isdir(os.path.join(fs_path, d))]

    def cat(self, fs_path=None):
        with open(fs_path) as f:
            return f.read()


class HDFSClient(FS):
    """hadoop-CLI backed FS (fs.py:423). Requires `hadoop` on PATH."""

    def __init__(self, hadoop_home=None, configs=None, time_out=5 * 60 * 1000,
                 sleep_inter=1000):
        self._hadoop = (os.path.join(hadoop_home, "bin", "hadoop")
                        if hadoop_home else "hadoop")
        self._configs = configs or {}
        self._time_out_s = max(time_out / 1000.0, 1.0)  # reference API is ms
        self._sleep_inter = sleep_inter
        self._base = [self._hadoop, "fs"] + \
            [f"-D{k}={v}" for k, v in self._configs.items()]

    def _run(self, argv):
        """argv: list of CLI words; paths are passed as separate argv entries
        (no shell) so spaces/metacharacters in paths are safe."""
        try:
            proc = subprocess.run(self._base + argv, capture_output=True,
                                  text=True, timeout=self._time_out_s)
        except FileNotFoundError as e:
            raise ExecuteError(f"hadoop CLI not available: {e}")
        except subprocess.TimeoutExpired:
            raise FSTimeOut(" ".join(argv))
        if proc.returncode != 0:
            raise ExecuteError(f"{' '.join(argv)}: {proc.stderr}")
        return proc.stdout

    def _injected_run(self, site, argv):
        maybe_inject(site, ExecuteError)
        return self._run(argv)

    def need_upload_download(self):
        return True

    def is_exist(self, fs_path):
        try:
            self._run(["-test", "-e", fs_path])
            return True
        except ExecuteError:
            return False

    def is_dir(self, fs_path):
        try:
            self._run(["-test", "-d", fs_path])
            return True
        except ExecuteError:
            return False

    def is_file(self, fs_path):
        return self.is_exist(fs_path) and not self.is_dir(fs_path)

    def ls_dir(self, fs_path):
        out = self._run(["-ls", fs_path])
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def mkdirs(self, fs_path):
        self._run(["-mkdir", "-p", fs_path])

    def delete(self, fs_path):
        if self.is_exist(fs_path):
            self._run(["-rm", "-r", fs_path])

    def upload(self, local_path, fs_path):
        retry_call(self._injected_run, "fs.upload",
                   ["-put", "-f", local_path, fs_path],
                   retry_on=(ExecuteError, FSTimeOut))

    def download(self, fs_path, local_path):
        retry_call(self._injected_run, "fs.download",
                   ["-get", fs_path, local_path],
                   retry_on=(FSTimeOut,))

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        if overwrite and self.is_exist(fs_dst_path):
            self.delete(fs_dst_path)
        if test_exists:
            if not self.is_exist(fs_src_path):
                raise FSFileNotExistsError(fs_src_path)
            if self.is_exist(fs_dst_path):
                raise FSFileExistsError(fs_dst_path)
        # only timeouts retry: a repeated -mv after a server-side success
        # would fail with "src not found" and mask the real outcome
        retry_call(self._injected_run, "fs.mv",
                   ["-mv", fs_src_path, fs_dst_path],
                   retry_on=(FSTimeOut,))

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(fs_path)
        self._run(["-touchz", fs_path])

    def cat(self, fs_path=None):
        return self._run(["-cat", fs_path])
