"""Zero-stall checkpoints: async snapshot -> manifest commit -> exact
resume (port of paddle_tpu/resilience/snapshot.py).

- :class:`AsyncCheckpointer`: the only foreground cost of a save is the
  copy of the state to the host (:func:`host_snapshot`; fault site
  ``ckpt.snapshot``, metric ``ckpt.snapshot_ms``). Serialisation, the
  per-file sha256 sidecars and the manifest rename run on a background
  committer thread (sites ``ckpt.serialize`` and ``ckpt.commit``, metric
  ``ckpt.commit_ms``; the queue depth is the ``ckpt.pending_count``
  gauge), or inline with ``background=False``. Async failures never raise
  into the train loop: they are counted (``ckpt.commit_failures_total``),
  journaled (``ckpt_commit_failed``) and returned by :meth:`flush`.
  :class:`Checkpointer` is the synchronous one: its save commits before it
  returns and raises on failure.
- Manifest commit point: a save stages its files under a per-commit
  ``data-<seq>/`` directory (so it never overwrites a file an earlier
  manifest references), each with a ``.sha256`` sidecar, then commits by
  atomically renaming ``manifest-<seq>.json`` into place; only after the
  commit are the top-level names (``<tag>.pdparams``, ``.pdopt``,
  ``.pdstate``: what ``Model.load`` reads) republished as copies. A torn
  commit leaves the previous checkpoint, manifest and data, untouched.
  ``ckpt.commit`` fires at every file boundary, so a test can kill a
  commit anywhere.
- Exact resume: :func:`capture_train_state` records torch's default
  generator, numpy's global generator and a resumable DataLoader's
  cursor; :func:`restore_train_state` re-arms them.
- Keep-last-K retention (``FLAGS_ckpt_keep``): :meth:`AsyncCheckpointer.gc`
  deletes manifests beyond K and the files only they reference, never the
  newest committed manifest, a manifest a consumer pinned
  (``pins/<consumer>.json``, :func:`write_pin`), a file a kept manifest
  references, or a ``.old`` fallback. Removal failures are counted
  (``ckpt.gc_failures_total``), not raised.

Wiring: ``hapi.Model.save`` and ``ModelCheckpoint`` route through
:func:`save_model` (``FLAGS_async_checkpoint`` picks the background
committer), ``save_hybrid_checkpoint`` through :func:`checkpointer_for`,
the SIGTERM path and ``RecoveryManager.restart`` call :func:`flush_all`
before the emergency save and before the restore, and restores discover
checkpoints through :func:`load_blob` (newest committed manifest first,
then legacy ``.old`` files, journaling a ``corrupt_restore`` per skip).

The files are the reference's: the same pickle format
(framework/io_utils.py), layout, manifests and pins, so a checkpoint
either package writes loads in the other (``.pdstate``'s generator state
is each package's own).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
import weakref
from collections import deque

import numpy as np
import torch

from ..framework.io_utils import _Bf16Words, dump, host_bytes
from ..framework.io_utils import load as _load_obj
from ..framework.io_utils import load_numpy_state_dict
from .faults import maybe_inject

__all__ = [
    "AsyncCheckpointer", "Checkpointer", "CheckpointCommitError",
    "capture_train_state", "restore_train_state", "save_model",
    "checkpointer_for", "flush_all", "host_snapshot", "list_manifests",
    "read_manifest", "verify_manifest", "load_blob", "load_manifest_blob",
    "apply_blob", "protected_files", "serialize_file", "pin_path",
    "write_pin", "clear_pin", "read_pins", "pinned_manifests",
    "manifest_name",
]

MANIFEST_RE = re.compile(r"^manifest-(\d+)\.json$")
DATA_DIR_RE = re.compile(r"^data-(\d+)$")
PINS_DIR = "pins"


def manifest_name(seq):
    """The basename of the commit record for sequence ``seq``."""
    return f"manifest-{int(seq):010d}.json"


def _data_dir(seq):
    return f"data-{seq:010d}"


class CheckpointCommitError(RuntimeError):
    """A snapshot, serialize or commit stage failed, or a manifest does
    not verify. For an async save it is recorded and returned by
    :meth:`AsyncCheckpointer.flush`, never raised into the train loop."""


def _registry():
    from ..profiler.metrics import get_registry
    return get_registry()


def _journal():
    from .recovery import get_journal
    return get_journal()


def _numpy_of(t, words):
    """A tensor's host bytes (``words``, a flat uint8 array) as what a
    checkpoint pickles: its ndarray, or for bf16 its 16-bit words."""
    if t.dtype == torch.bfloat16:
        return _Bf16Words(words.view("<i2").reshape(tuple(t.shape)))
    dtype = torch.empty((), dtype=t.dtype).numpy().dtype
    return words.view(dtype).reshape(tuple(t.shape))


def host_snapshot(obj):
    """Copy a (nested) state structure to the host: every tensor becomes
    its serialisable form, so the committer reads no live training state
    (the train loop may update the parameters while a commit is in
    flight). The card's tensors cross in one copy a device
    (``io_utils.host_bytes``), into pageable host memory: a pinned buffer
    would copy faster, but it would have to live until the commit that
    reads it lands, and its allocation is paid every save."""
    tensors = {}

    def collect(x):
        if isinstance(x, torch.Tensor):
            tensors[id(x)] = x
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)
    collect(obj)
    host = {k: _numpy_of(t, b) for (k, t), b in zip(
        tensors.items(), host_bytes(list(tensors.values()), copy=True))}

    def convert(x):
        if isinstance(x, torch.Tensor):
            return {"__tensor__": True, "data": host[id(x)],
                    "stop_gradient": not x.requires_grad, "name": None}
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(convert(v) for v in x)
        return x
    return convert(obj)


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


def protected_files(root):
    """Absolute paths of every committed manifest under ``root``, every
    file (and sidecar) it references, and the top-level alias of each:
    the never-delete set shared by the retention GCs here and in
    ``incubate.CheckpointSaver``."""
    out = set()
    for _, mp in list_manifests(root):
        out.add(os.path.abspath(mp))
        try:
            man = read_manifest(mp)
        except CheckpointCommitError:
            continue
        for rel in man["files"]:
            for p in (os.path.abspath(os.path.join(root, rel)),
                      os.path.abspath(
                          os.path.join(root, os.path.basename(rel)))):
                out.add(p)
                out.add(p + ".sha256")
    return out


# -- retention pins -----------------------------------------------------------
#
# Keep-K retention alone can delete a manifest a consumer still depends on
# (the serving rollout controller keeps the incumbent and prior versions
# for an instant rollback). A consumer pins manifests by atomically writing
# ``pins/<consumer>.json`` under the checkpoint root; ``gc()`` treats every
# pinned manifest as kept.

def pin_path(root, consumer):
    return os.path.join(os.path.abspath(root), PINS_DIR,
                        f"{consumer}.json")


def write_pin(root, consumer, manifests, meta=None):
    """Atomically pin manifest basenames under ``root`` against keep-K GC
    (``manifests`` may hold paths or basenames; the pin file is replaced
    in one ``os.replace``). Returns the pin's path."""
    path = pin_path(root, consumer)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    names = sorted({os.path.basename(str(m)) for m in manifests if m})
    doc = {"consumer": str(consumer), "manifests": names,
           "ts": time.time()}
    if meta:
        doc.update(meta)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def clear_pin(root, consumer):
    """Drop a consumer's pin (its manifests become ordinary GC fodder)."""
    try:
        os.remove(pin_path(root, consumer))
    except OSError:
        pass


def read_pins(root):
    """All pins under ``root`` as {consumer: [manifest basenames]}. An
    unreadable or foreign file pins nothing (fail-open keeps GC
    working)."""
    d = os.path.join(os.path.abspath(root), PINS_DIR)
    out = {}
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for n in sorted(names):
        if not n.endswith(".json") or ".tmp." in n:
            continue
        try:
            with open(os.path.join(d, n)) as f:
                doc = json.load(f)
            mans = [os.path.basename(str(m))
                    for m in (doc.get("manifests") or [])]
        except (OSError, ValueError, AttributeError, TypeError):
            continue
        out[n[:-len(".json")]] = sorted(set(mans))
    return out


def pinned_manifests(root):
    """The union of every consumer's pinned manifest basenames."""
    out = set()
    for names in read_pins(root).values():
        out.update(names)
    return out


def load_blob(path, journal=None):
    """Restore by manifest discovery: ``path`` is a checkpoint root (or one
    manifest to start from); committed manifests are tried newest to
    oldest, each verified file by file, and a rejected one is recorded in
    ``journal`` (default the process's recovery journal) as a
    ``corrupt_restore`` before the next is tried. When every manifest is
    exhausted, legacy ``*.old`` files in the root are tried, newest first.
    Returns ``(blob, manifest_path)``; raises FileNotFoundError when
    nothing restores."""
    if os.path.isdir(path):
        root, start_seq = path, None
    else:
        root = os.path.dirname(os.path.abspath(path))
        m = MANIFEST_RE.match(os.path.basename(path))
        start_seq = int(m.group(1)) if m else None
    if journal is None:
        try:
            journal = _journal()
        except Exception:
            journal = None

    def _skip(p, err):
        if journal is not None:
            try:
                journal.record("corrupt_restore", path=p, detail=str(err),
                               fallback="next manifest/.old")
            except Exception:
                pass  # journaling is best effort on the failure path

    for seq, mp in list_manifests(root):
        if start_seq is not None and seq > start_seq:
            continue
        try:
            man = verify_manifest(mp)
            return _blob_from_manifest(mp, man), mp
        except CheckpointCommitError as e:
            _skip(mp, e)
    olds = []
    try:
        for n in os.listdir(root):
            p = os.path.join(root, n)
            if n.endswith(".old") and os.path.isfile(p):
                olds.append((os.path.getmtime(p), p))
    except OSError:
        pass
    for _, p in sorted(olds, reverse=True):
        try:
            from ..distributed.checkpoint import _load_verified
            blob = _load_verified(p)
            if isinstance(blob, dict) and "model" in blob:
                blob.setdefault("meta", {})["restored_from_fallback"] = True
                return blob, p
        except Exception as e:
            _skip(p, e)
    raise FileNotFoundError(
        f"{root}: no committed manifest or readable .old fallback")


def load_manifest_blob(path):
    """Verify ONE manifest and assemble its blob, with no fallback to an
    older one: a loader that must load exactly the version it was asked
    for fails typed (:class:`CheckpointCommitError`)."""
    man = verify_manifest(path)
    return _blob_from_manifest(path, man)


def _kind_of(rel):
    if rel.endswith(".pdparams"):
        return "model"
    if rel.endswith(".pdopt"):
        return "optimizer"
    if rel.endswith(".pdstate"):
        return "train_state"
    return "blob"


# -- the committer ------------------------------------------------------------

_LIVE = weakref.WeakSet()


class AsyncCheckpointer:
    """Background-committed, manifest-atomic checkpoints in one root
    directory.

    :meth:`save` does the only foreground work, the copy to the host, and
    queues a commit job. The committer (a daemon thread with
    ``background=True``, inline otherwise) serialises each payload with a
    sha256 sidecar and then commits by atomically renaming
    ``manifest-<seq>.json`` into place; a torn commit leaves the previous
    manifest untouched. Async commit failures never raise into the train
    loop: they are counted (``ckpt.commit_failures_total``), journaled
    (``ckpt_commit_failed``) and returned by :meth:`flush`.
    """

    def __init__(self, root, keep=None, background=True, journal=None):
        from ..framework.flags import get_flag
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.keep = int(get_flag("FLAGS_ckpt_keep", 3)
                        if keep is None else keep)
        self.background = bool(background)
        self._journal_obj = journal
        self._cv = threading.Condition()
        self._queue = deque()  # guarded-by: _cv
        self._inflight = 0     # guarded-by: _cv
        self._errors = []      # guarded-by: _cv
        self._staging = set()  # guarded-by: _cv (seqs mid-commit: the
        #                        orphan sweep skips them)
        self._closed = False   # guarded-by: _cv
        self._thread = None    # guarded-by: _cv
        self._seq = max([s for s, _ in list_manifests(self.root)],
                        default=0)  # guarded-by: _cv
        _LIVE.add(self)

    # -- foreground --------------------------------------------------------
    def save(self, files, step=None, meta=None, blocking=False):
        """Snapshot and queue one checkpoint.

        ``files`` maps a path under the root to a payload, ``(payload,
        kind)`` or ``(payload, kind, info)``; the kind defaults from the
        extension (``.pdparams`` model, ``.pdopt`` optimizer, ``.pdstate``
        train_state) and ``info`` (JSON-serialisable) is merged into the
        file's manifest entry, whose ``sha256``/``bytes``/``kind`` stay
        authoritative. The copy to the host happens here (fault site
        ``ckpt.snapshot``, metric ``ckpt.snapshot_ms``); with
        ``blocking=True`` the commit also runs inline and raises on
        failure. Returns the manifest path this save commits (present
        once the commit lands)."""
        with self._cv:
            closed = self._closed
        if closed:
            raise CheckpointCommitError(f"{self.root}: checkpointer closed")
        t0 = time.perf_counter()
        maybe_inject("ckpt.snapshot", CheckpointCommitError)
        rels, payloads, kinds, infos = [], [], [], []
        for rel, val in files.items():
            info = None
            if isinstance(val, tuple):
                if len(val) == 3:
                    payload, kind, info = val
                else:
                    payload, kind = val
            else:
                payload, kind = val, _kind_of(rel)
            rels.append(rel)
            payloads.append(payload)
            kinds.append(kind)
            infos.append(dict(info) if info else None)
        job_files = list(zip(rels, host_snapshot(payloads), kinds, infos))
        with self._cv:
            self._seq += 1
            seq = self._seq
        man_meta = dict(meta or {})
        from .recovery import current_generation
        gen = current_generation()
        if gen and "generation" not in man_meta:
            man_meta["generation"] = gen
        job = {"seq": seq, "step": int(seq if step is None else step),
               "meta": man_meta, "files": job_files}
        _registry().observe("ckpt.snapshot_ms",
                            (time.perf_counter() - t0) * 1e3)
        if blocking or not self.background:
            with self._cv:
                self._inflight += 1
            self._set_pending()
            try:
                if blocking:
                    return self._commit(job)
                try:  # inline with async semantics: record, don't raise
                    return self._commit(job)
                except Exception as e:  # noqa: BLE001
                    self._note_failure(job, e)
                    return self._manifest_path(seq)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
                self._set_pending()
        with self._cv:
            self._queue.append(job)
            self._ensure_committer()
            self._cv.notify_all()
        self._set_pending()
        return self._manifest_path(seq)

    # -- background committer ----------------------------------------------
    def _ensure_committer(self):  # requires-lock: _cv
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="ckpt-committer", daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                job = self._queue.popleft()
                self._inflight += 1
            self._set_pending()
            try:
                self._commit(job)
            except Exception as e:  # noqa: BLE001: must not kill the thread
                self._note_failure(job, e)
            finally:
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()
                self._set_pending()

    def _commit(self, job):
        """Stage every data file under ``data-<seq>/``, then rename the
        manifest into place (the commit point), then republish the
        top-level names. Fault site ``ckpt.commit`` fires before each data
        file and once more before the rename."""
        t0 = time.perf_counter()
        seq = job["seq"]
        with self._cv:
            self._staging.add(seq)
        try:
            entries = {}
            aliases = []
            for rel, payload, kind, info in job["files"]:
                maybe_inject("ckpt.commit", CheckpointCommitError)
                prel = f"{_data_dir(seq)}/{rel}"
                digest, nbytes = serialize_file(
                    payload, os.path.join(self.root, prel))
                entry = dict(info or {})
                entry.update({"sha256": digest, "bytes": nbytes,
                              "kind": kind})
                entries[prel] = entry
                aliases.append((prel, rel))
            maybe_inject("ckpt.commit", CheckpointCommitError)
            man = {"version": 1, "seq": seq, "step": job["step"],
                   "ts": time.time(), "meta": job["meta"], "files": entries}
            mpath = self._manifest_path(seq)
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
        finally:
            with self._cv:
                self._staging.discard(seq)
        self.gc()
        return mpath

    def _note_failure(self, job, exc):
        with self._cv:
            self._errors.append((self._manifest_path(job["seq"]), exc))
        _registry().inc_counter("ckpt.commit_failures_total")
        try:
            j = self._journal_obj if self._journal_obj is not None \
                else _journal()
            j.record("ckpt_commit_failed", root=self.root, seq=job["seq"],
                     step=job["step"], detail=str(exc))
        except Exception:
            pass  # journaling is best effort on the failure path

    def _manifest_path(self, seq):
        return os.path.join(self.root, manifest_name(seq))

    def _set_pending(self):
        with self._cv:
            pending = len(self._queue) + self._inflight
        _registry().set_gauge("ckpt.pending_count", float(pending))

    # -- waiting and lifecycle ---------------------------------------------
    @property
    def pending(self):
        with self._cv:
            return len(self._queue) + self._inflight

    def flush(self, timeout=None):
        """Wait until every queued commit has landed or failed (bounded by
        ``timeout`` seconds). Returns the [(manifest_path, exception)]
        failures since the last flush: async errors surface here."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._queue or self._inflight:
                rem = None if deadline is None \
                    else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    break
                self._cv.wait(timeout=rem)
            errs, self._errors = self._errors, []
        return errs

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:  # join outside _cv: the committer needs it
            t.join(timeout=5.0)

    # -- discovery and restore ---------------------------------------------
    def latest_manifest(self):
        mans = list_manifests(self.root)
        return mans[0][1] if mans else None

    def restore(self, model=None, optimizer=None, journal=None):
        """Restore the newest committed manifest that verifies (falling
        back as :func:`load_blob` does) into ``model`` and ``optimizer``
        and re-arm the train state. Returns ``(meta, train_state)``."""
        blob, _ = load_blob(self.root, journal=journal or self._journal_obj)
        return apply_blob(blob, model, optimizer)

    def as_restore_hook(self, model, optimizer=None):
        """A ``RecoveryManager(restore=...)`` hook: flush the pending
        commits, then restore the newest committed manifest."""
        def _restore(gen):
            self.flush()
            meta, _ = self.restore(model, optimizer)
            return meta
        return _restore

    # -- retention -----------------------------------------------------------
    def gc(self):
        """Keep-last-K retention (module docstring); ``keep <= 0`` keeps
        everything."""
        if self.keep <= 0:
            return
        mans = list_manifests(self.root)
        kept, doomed = mans[:max(1, self.keep)], mans[max(1, self.keep):]
        pinned = pinned_manifests(self.root)
        if pinned:
            kept = kept + [(s, mp) for s, mp in doomed
                           if os.path.basename(mp) in pinned]
            doomed = [(s, mp) for s, mp in doomed
                      if os.path.basename(mp) not in pinned]
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
                if p in protected or p.endswith(".old"):
                    continue
                self._remove(p)
                self._remove(p + ".sha256")
                alias = os.path.basename(rel)
                ap = os.path.join(self.root, alias)
                if alias not in kept_aliases and ap != p \
                        and not alias.endswith(".old"):
                    self._remove(ap)
                    self._remove(ap + ".sha256")
            if mp not in protected:
                # the manifest goes last: a gc stopped half way leaves the
                # old checkpoint discoverable, only not yet reclaimed
                self._sweep_dir(os.path.join(self.root, _data_dir(s)))
                self._remove(mp)
        # a torn commit leaves a data-<seq>/ with no manifest: sweep those
        # older than the newest committed seq (not one still mid-commit)
        if mans:
            newest = mans[0][0]
            committed = {s for s, _ in mans}
            with self._cv:
                staging = set(self._staging)
            try:
                names = os.listdir(self.root)
            except OSError:
                names = []
            for n in names:
                m = DATA_DIR_RE.match(n)
                if not m:
                    continue
                s = int(m.group(1))
                if s in committed or s in staging or s >= newest:
                    continue
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


class Checkpointer(AsyncCheckpointer):
    """The synchronous committer: :meth:`save` snapshots, serialises and
    commits before it returns, and raises on failure."""

    def __init__(self, root, keep=None, journal=None):
        super().__init__(root, keep=keep, background=False, journal=journal)

    def save(self, files, step=None, meta=None, blocking=True):
        return super().save(files, step=step, meta=meta, blocking=blocking)


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


def checkpointer_for(root, background=None, keep=None):
    """The process's AsyncCheckpointer of ``root`` (saves into one
    directory share it, so that their sequence numbers and retention
    cooperate). ``background`` defaults to ``FLAGS_async_checkpoint``; a
    request for the other mode replaces the shared one."""
    from ..framework.flags import get_flag
    if background is None:
        background = bool(get_flag("FLAGS_async_checkpoint", False))
    root = os.path.abspath(root)
    ck = _BY_ROOT.get(root)
    if ck is None or ck._closed or ck.background != bool(background):
        ck = AsyncCheckpointer(root, keep=keep, background=background)
        _BY_ROOT[root] = ck
    return ck


def flush_all(timeout=None):
    """Flush every live AsyncCheckpointer. The preempt path calls this
    before the emergency save and ``RecoveryManager.restart`` before the
    restore, so neither races a commit of its own in flight. Returns the
    combined [(manifest_path, exception)] failures."""
    errs = []
    for ck in list(_LIVE):
        try:
            errs.extend(ck.flush(timeout=timeout))
        except Exception:
            pass  # a wedged committer must not block the exit path
    return errs


def save_model(network, optimizer, path, train_state=None, blocking=None):
    """The hardened save of ``hapi.Model.save`` and ``ModelCheckpoint``:
    writes ``path.pdparams``, ``path.pdopt`` (with an optimizer) and
    ``path.pdstate``, each with a ``.sha256`` sidecar, and commits a
    generation-stamped manifest in ``dirname(path)``. Under
    ``FLAGS_async_checkpoint`` (or ``blocking=False``) the serialisation
    and the commit run on the background committer; ``blocking=True``
    forces the synchronous commit. Returns the manifest's path."""
    from ..framework.flags import get_flag
    if blocking is None:
        blocking = not get_flag("FLAGS_async_checkpoint", False)
    root = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path)
    ck = checkpointer_for(root, background=not blocking)
    files = {base + ".pdparams": (network.state_dict(), "model")}
    if optimizer is not None:
        files[base + ".pdopt"] = (optimizer.state_dict(), "optimizer")
    files[base + ".pdstate"] = (
        train_state if train_state is not None else capture_train_state(),
        "train_state")
    return ck.save(files, meta={"tag": base}, blocking=blocking)
