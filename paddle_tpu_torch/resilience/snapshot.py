"""Checkpoints committed by manifest, and exact resume (port of the
synchronous path of paddle_tpu/resilience/snapshot.py).

- Manifest commit point: a save stages its files under a per-commit
  ``data-<seq>/`` directory (so it never overwrites a file an earlier
  manifest references), each with a ``.sha256`` sidecar, then commits by
  atomically renaming ``manifest-<seq>.json`` into place; only after the
  commit are the top-level names (``<tag>.pdparams``, ``.pdopt``,
  ``.pdstate``: what ``Model.load`` reads) republished as copies. A torn
  commit leaves the previous checkpoint, manifest and data, untouched.
  Fault sites ``ckpt.snapshot``, ``ckpt.serialize`` and ``ckpt.commit``
  (at every file boundary) let a test kill a commit anywhere.
- Exact resume: :func:`capture_train_state` records torch's default
  generator, numpy's global generator and a resumable DataLoader's
  cursor; :func:`restore_train_state` re-arms them.
- Keep-last-K retention (``FLAGS_ckpt_keep``): :meth:`Checkpointer.gc`
  deletes manifests beyond K and the files only they reference, never the
  newest committed manifest or a file a kept manifest references.
  Removal failures are counted (``ckpt.gc_failures_total``), not raised.

The files are the reference's: the same pickle format
(framework/io_utils.py), layout and manifests, so a checkpoint either
package writes loads in the other (``.pdstate``'s generator state is each
package's own). Not ported yet: the reference's ``AsyncCheckpointer``,
which serialises on a background thread under ``FLAGS_async_checkpoint``
(ROADMAP A11; with that flag set :func:`save_model` raises), the legacy
``.old`` fallback of :func:`load_blob` for the pre-manifest savers' files
(``incubate.CheckpointSaver``), and the retention pins and
single-manifest loader of the serving rollout controller (ROADMAP A12).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time

import numpy as np
import torch

from ..framework.io_utils import _to_serializable, dump
from ..framework.io_utils import load as _load_obj
from ..framework.io_utils import load_numpy_state_dict
from .faults import maybe_inject

__all__ = [
    "Checkpointer", "CheckpointCommitError", "capture_train_state",
    "restore_train_state", "save_model", "checkpointer_for",
    "list_manifests", "read_manifest", "verify_manifest", "load_blob",
    "apply_blob", "serialize_file", "manifest_name",
]

MANIFEST_RE = re.compile(r"^manifest-(\d+)\.json$")
DATA_DIR_RE = re.compile(r"^data-(\d+)$")
_ASYNC_LATER = ("FLAGS_async_checkpoint: the background committer "
                "(AsyncCheckpointer) comes with a later slice of the port "
                "(ROADMAP A11); unset the flag to save synchronously")


def manifest_name(seq):
    """The basename of the commit record for sequence ``seq``."""
    return f"manifest-{int(seq):010d}.json"


def _data_dir(seq):
    return f"data-{seq:010d}"


class CheckpointCommitError(RuntimeError):
    """A snapshot, serialize or commit stage failed, or a manifest does
    not verify."""


def _registry():
    from ..profiler.metrics import get_registry
    return get_registry()


def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def serialize_file(payload, path):
    """Pickle one host-side payload to ``path`` (tmp + ``os.replace``) and
    write its ``.sha256`` sidecar; returns (digest, bytes). Fault site
    ``ckpt.serialize``."""
    maybe_inject("ckpt.serialize", CheckpointCommitError)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        dump(payload, f, protocol=4)
        f.flush()
        os.fsync(f.fileno())
    digest = _sha256_file(tmp)
    nbytes = os.path.getsize(tmp)
    os.replace(tmp, path)
    stmp = f"{path}.sha256.tmp.{os.getpid()}"
    with open(stmp, "w") as f:
        f.write(digest + "\n")
    os.replace(stmp, path + ".sha256")
    return digest, nbytes


def _publish_alias(src, dst):
    """Republish a committed staged file (and its sidecar) under its
    top-level name; runs strictly after the manifest rename."""
    tmp = f"{dst}.tmp.{os.getpid()}"
    shutil.copyfile(src, tmp)
    os.replace(tmp, dst)
    side = src + ".sha256"
    if os.path.exists(side):
        stmp = f"{dst}.sha256.tmp.{os.getpid()}"
        shutil.copyfile(side, stmp)
        os.replace(stmp, dst + ".sha256")


# -- train-state capture (exact resume) ------------------------------------

def capture_train_state(loader=None, extra=None):
    """What exact resume needs beyond the model and optimizer: torch's
    default generator, numpy's global generator and, given a resumable
    DataLoader, its cursor. Host copies only."""
    state = {"rng": torch.get_rng_state().numpy(),
             "numpy_rng": np.random.get_state()}
    if loader is not None and hasattr(loader, "state_dict"):
        state["cursor"] = loader.state_dict()
    if extra:
        state["extra"] = dict(extra)
    return state


def restore_train_state(state, loader=None):
    """Re-arm the generators (and a DataLoader's cursor) from a restored
    train state; returns the cursor dict (or None)."""
    rng = state.get("rng")
    if rng is not None:
        if not isinstance(rng, torch.Tensor):
            rng = torch.from_numpy(np.asarray(rng))
        torch.set_rng_state(rng.to(torch.uint8))
    np_state = state.get("numpy_rng")
    if np_state is not None:
        np.random.set_state(tuple(np_state))
    cursor = state.get("cursor")
    if loader is not None and cursor is not None \
            and hasattr(loader, "set_state_dict"):
        loader.set_state_dict(cursor)
    return cursor


# -- manifests ----------------------------------------------------------------

def list_manifests(root):
    """Committed manifests under ``root`` as [(seq, path)], newest first."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for n in names:
        m = MANIFEST_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(root, n)))
    out.sort(reverse=True)
    return out


def read_manifest(path):
    try:
        with open(path) as f:
            man = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCommitError(f"{path}: unreadable manifest: {e}")
    if not isinstance(man.get("files"), dict):
        raise CheckpointCommitError(f"{path}: manifest has no files map")
    return man


def verify_manifest(path, manifest=None):
    """Check every file the manifest references against its recorded
    digest; returns the manifest, raises :class:`CheckpointCommitError`
    naming the first damaged file."""
    root = os.path.dirname(os.path.abspath(path))
    man = manifest if manifest is not None else read_manifest(path)
    for rel, info in sorted(man["files"].items()):
        fp = os.path.join(root, rel)
        if not os.path.exists(fp):
            raise CheckpointCommitError(
                f"{path}: referenced file missing: {rel}")
        got = _sha256_file(fp)
        want = info.get("sha256")
        if want and got != want:
            raise CheckpointCommitError(
                f"{path}: {rel}: sha256 mismatch "
                f"(got {got[:12]}, recorded {want[:12]})")
    return man


def _blob_from_manifest(mpath, man):
    """A {model, optimizer, train_state, meta} blob from a verified
    manifest's files."""
    root = os.path.dirname(os.path.abspath(mpath))
    blob = {"meta": dict(man.get("meta") or {})}
    blob["meta"].setdefault("step", man.get("step"))
    for rel, info in sorted(man["files"].items()):
        kind = info.get("kind")
        obj = _load_obj(os.path.join(root, rel))
        if kind == "blob" and isinstance(obj, dict):
            meta = blob["meta"]
            blob.update(obj)
            merged = dict(blob.get("meta") or {})
            merged.update(meta)
            blob["meta"] = merged
        elif kind in ("model", "optimizer", "train_state"):
            blob[kind] = obj
    return blob


def load_blob(path, journal=None):
    """Restore by manifest discovery: ``path`` is a checkpoint root (or one
    manifest to start from); committed manifests are tried newest to
    oldest, each verified file by file, and a rejected one is recorded in
    ``journal`` (anything with ``record(kind, **fields)``) before the next
    is tried. Returns ``(blob, manifest_path)``; raises FileNotFoundError
    when no manifest restores."""
    if os.path.isdir(path):
        root, start_seq = path, None
    else:
        root = os.path.dirname(os.path.abspath(path))
        m = MANIFEST_RE.match(os.path.basename(path))
        start_seq = int(m.group(1)) if m else None
    for seq, mp in list_manifests(root):
        if start_seq is not None and seq > start_seq:
            continue
        try:
            man = verify_manifest(mp)
            return _blob_from_manifest(mp, man), mp
        except CheckpointCommitError as e:
            if journal is not None:
                journal.record("corrupt_restore", path=mp, detail=str(e),
                               fallback="next manifest")
    raise FileNotFoundError(f"{root}: no committed manifest restores")


def _kind_of(rel):
    if rel.endswith(".pdparams"):
        return "model"
    if rel.endswith(".pdopt"):
        return "optimizer"
    if rel.endswith(".pdstate"):
        return "train_state"
    return "blob"


# -- the committer ------------------------------------------------------------

class Checkpointer:
    """Manifest-committed checkpoints in one root directory, written
    synchronously: :meth:`save` snapshots, serialises and commits before
    it returns, and raises on failure."""

    def __init__(self, root, keep=None):
        from ..framework.flags import get_flag
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep = int(get_flag("FLAGS_ckpt_keep", 3)
                        if keep is None else keep)
        self._seq = max([s for s, _ in list_manifests(self.root)],
                        default=0)

    def save(self, files, step=None, meta=None):
        """Commit one checkpoint. ``files`` maps a path under the root to a
        payload, ``(payload, kind)`` or ``(payload, kind, info)``; the kind
        defaults from the extension (``.pdparams`` model, ``.pdopt``
        optimizer, ``.pdstate`` train_state) and ``info`` is merged into
        the file's manifest entry. Returns the manifest's path."""
        t0 = time.perf_counter()
        maybe_inject("ckpt.snapshot", CheckpointCommitError)
        job_files = []
        for rel, val in files.items():
            info = None
            if isinstance(val, tuple):
                if len(val) == 3:
                    payload, kind, info = val
                else:
                    payload, kind = val
            else:
                payload, kind = val, _kind_of(rel)
            job_files.append((rel, _to_serializable(payload), kind,
                              dict(info) if info else None))
        self._seq += 1
        man_meta = dict(meta or {})
        from .recovery import current_generation
        gen = current_generation()
        if gen and "generation" not in man_meta:
            man_meta["generation"] = gen
        _registry().observe("ckpt.snapshot_ms",
                            (time.perf_counter() - t0) * 1e3)
        return self._commit(self._seq,
                            int(self._seq if step is None else step),
                            man_meta, job_files)

    def _commit(self, seq, step, meta, job_files):
        """Stage every file under ``data-<seq>/``, then rename the
        manifest into place (the commit point), then republish the
        top-level names. Fault site ``ckpt.commit`` fires before each data
        file and once more before the rename."""
        t0 = time.perf_counter()
        entries = {}
        aliases = []
        for rel, payload, kind, info in job_files:
            maybe_inject("ckpt.commit", CheckpointCommitError)
            prel = f"{_data_dir(seq)}/{rel}"
            digest, nbytes = serialize_file(
                payload, os.path.join(self.root, prel))
            entry = dict(info or {})
            entry.update({"sha256": digest, "bytes": nbytes, "kind": kind})
            entries[prel] = entry
            aliases.append((prel, rel))
        maybe_inject("ckpt.commit", CheckpointCommitError)
        man = {"version": 1, "seq": seq, "step": step, "ts": time.time(),
               "meta": meta, "files": entries}
        mpath = os.path.join(self.root, manifest_name(seq))
        tmp = f"{mpath}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(man, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mpath)
        for prel, rel in aliases:
            _publish_alias(os.path.join(self.root, prel),
                           os.path.join(self.root, rel))
        _registry().observe("ckpt.commit_ms",
                            (time.perf_counter() - t0) * 1e3)
        self.gc()
        return mpath

    def restore(self, model=None, optimizer=None, journal=None):
        """Restore the newest committed manifest that verifies into
        ``model`` and ``optimizer`` and re-arm the train state. Returns
        ``(meta, train_state)``."""
        blob, _ = load_blob(self.root, journal=journal)
        return apply_blob(blob, model, optimizer)

    # -- retention -----------------------------------------------------------
    def gc(self):
        """Keep-last-K retention (module docstring); ``keep <= 0`` keeps
        everything."""
        if self.keep <= 0:
            return
        mans = list_manifests(self.root)
        kept, doomed = mans[:max(1, self.keep)], mans[max(1, self.keep):]
        protected = set()
        kept_aliases = set()
        for _, mp in kept:
            protected.add(mp)
            try:
                man = read_manifest(mp)
            except CheckpointCommitError:
                continue
            for rel in man["files"]:
                p = os.path.join(self.root, rel)
                protected.add(p)
                protected.add(p + ".sha256")
                kept_aliases.add(os.path.basename(rel))
        for s, mp in doomed:
            try:
                files = read_manifest(mp)["files"]
            except CheckpointCommitError:
                files = {}
            for rel in files:
                p = os.path.join(self.root, rel)
                if p in protected:
                    continue
                self._remove(p)
                self._remove(p + ".sha256")
                alias = os.path.basename(rel)
                ap = os.path.join(self.root, alias)
                if alias not in kept_aliases and ap != p:
                    self._remove(ap)
                    self._remove(ap + ".sha256")
            if mp not in protected:
                # the manifest goes last: a gc stopped half way leaves the
                # old checkpoint discoverable, only not yet reclaimed
                self._sweep_dir(os.path.join(self.root, _data_dir(s)))
                self._remove(mp)
        # a torn commit leaves a data-<seq>/ with no manifest: sweep those
        # older than the newest committed seq
        if mans:
            newest = mans[0][0]
            committed = {s for s, _ in mans}
            try:
                names = os.listdir(self.root)
            except OSError:
                names = []
            for n in names:
                m = DATA_DIR_RE.match(n)
                if m and int(m.group(1)) not in committed \
                        and int(m.group(1)) < newest:
                    self._sweep_dir(os.path.join(self.root, n))

    def _sweep_dir(self, d):
        if not os.path.isdir(d):
            return
        try:
            names = os.listdir(d)
        except OSError:
            names = []
        for n in names:
            self._remove(os.path.join(d, n))
        try:
            os.rmdir(d)
        except OSError:
            pass  # a removal failed (already counted): the next gc retries

    def _remove(self, path):
        """Counted-not-raised removal (fault site ``fs.remove``)."""
        try:
            maybe_inject("fs.remove", OSError)
            if os.path.exists(path):
                os.remove(path)
        except OSError:
            _registry().inc_counter("ckpt.gc_failures_total")


def apply_blob(blob, model=None, optimizer=None):
    """Copy a restored blob into a model (in place, every name matching,
    shapes checked) and an optimizer, and re-arm the train state. Returns
    ``(meta, train_state)``."""
    meta = dict(blob.get("meta") or {})
    if model is not None:
        load_numpy_state_dict(model, blob["model"])
        if optimizer is not None and "optimizer" in blob:
            optimizer.set_state_dict(blob["optimizer"])
    train_state = blob.get("train_state")
    if train_state:
        restore_train_state(train_state)
    return meta, train_state


_BY_ROOT = {}


def checkpointer_for(root, keep=None):
    """The process's Checkpointer of ``root`` (saves into one directory
    share it, so that their sequence numbers and retention cooperate)."""
    root = os.path.abspath(root)
    ck = _BY_ROOT.get(root)
    if ck is None:
        ck = _BY_ROOT[root] = Checkpointer(root, keep=keep)
    return ck


def save_model(network, optimizer, path, train_state=None, blocking=None):
    """The hardened save of ``hapi.Model.save`` and ``ModelCheckpoint``:
    writes ``path.pdparams``, ``path.pdopt`` (with an optimizer) and
    ``path.pdstate``, each with a ``.sha256`` sidecar, and commits a
    manifest in ``dirname(path)``. Returns the manifest's path. The
    background commit of ``FLAGS_async_checkpoint`` (or
    ``blocking=False``) raises NotImplementedError (ROADMAP A11)."""
    from ..framework.flags import get_flag
    if blocking is None:
        blocking = not get_flag("FLAGS_async_checkpoint", False)
    if not blocking:
        raise NotImplementedError(_ASYNC_LATER)
    root = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    files = {base + ".pdparams": (network.state_dict(), "model")}
    if optimizer is not None:
        files[base + ".pdopt"] = (optimizer.state_dict(), "optimizer")
    files[base + ".pdstate"] = (
        train_state if train_state is not None else capture_train_state(),
        "train_state")
    return checkpointer_for(root).save(files, meta={"tag": base})
