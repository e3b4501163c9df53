"""Hybrid-parallel checkpoints with resharding (port of
paddle_tpu/distributed/checkpoint.py).

The reference's single controller gathers every sharded array to the
host and saves one canonical file; loading re-places each parameter on
the current mesh. The port runs one process per rank, so every rank takes
part in the save and the load:

- ``save_hybrid_checkpoint(path, model, optimizer, meta)``: the model's
  state in the reference's full names and layouts (tensor-parallel shards
  gathered over their model group, qkv by heads, through
  ``full_state_dict``; a pipeline's stages under their global names,
  ``run_function.{i}``; a shared parameter once), parameters first in the
  whole model's order, then buffers, as the reference's ``state_dict()``
  lists them; the optimizer's state gathered by owner (each ZeRO-1 rank's
  partition, each stage's accumulators, shards gathered like their
  parameters) under the reference's keys (``param_{i}__{accumulator}``,
  i the parameter's index in the whole model). Rank 0 receives the parts
  and writes one file with ``framework.io_utils.save``: the reference's
  blob ``{"model", "optimizer", "meta"}`` of numpy arrays, with a sha256
  sidecar; a file already there is kept as ``.old`` with its sidecar.
  Every rank then meets the others at a barrier.
- ``load_hybrid_checkpoint(path, model, optimizer)``: every rank reads the
  file (verified against its sidecar; a damaged file falls back to
  ``.old``, whose meta then says ``restored_from_fallback``; without one
  it raises ``CorruptCheckpointError``) and takes its shard for the
  current layout (``load_numpy_state_dict``), and its optimizer state the
  same way. A directory or a manifest restores through
  ``resilience.snapshot.load_blob``. Shapes are checked as the reference
  checks them. The reference re-places a parameter whose split does not
  tile the new mesh as a replicated array and warns; a tensor-parallel
  layer of the port holds its shard and cannot hold the whole, so the
  port raises ``ValueError`` naming the parameter (ROADMAP C-ref-23).
- ``reshard_model(model, full_state=None)``: the model's full state (its
  own, gathered, by default) re-applied to its current layout in place:
  each rank its shards, each stage the first stage's shared parameters.

A ZeRO-3 model (distributed/spec_layout.py) saves and loads the same way:
its shards are gathered like tensor-parallel ones (``param_split``), its
optimizer state too, and a load gives each rank its fsdp shard, so a
checkpoint written at one sharding degree loads at another, or into the
serial model.

``meta`` is stamped with the collective generation where it is not 0.
A load that falls back to ``.old`` journals a ``corrupt_restore`` entry
(``resilience.recovery.get_journal``), as the reference does.
``FLAGS_async_checkpoint`` raises (the background committer is ROADMAP
A11's).
"""
from __future__ import annotations

import hashlib
import os
import queue
import threading

import numpy as np
import torch

from ..framework.io_utils import (_numpy_from_tensor, _shard,
                                  full_state_dict, load_numpy_state_dict,
                                  local_state_dict, param_split,
                                  tensor_from_numpy, unshard)

__all__ = ["save_hybrid_checkpoint", "load_hybrid_checkpoint",
           "reshard_model", "gather_hybrid_state", "CorruptCheckpointError"]


class CorruptCheckpointError(RuntimeError):
    """A checkpoint file fails its sha256 sidecar or cannot be unpickled."""


class _Stage(threading.Thread):
    """One stage of the save's pipeline: ``fn`` applied to each chunk put
    on its queue, on a thread of its own (a file's write and hashlib's
    update release the GIL on large buffers)."""

    def __init__(self, fn):
        super().__init__(daemon=True)
        self.fn = fn
        self.q = queue.Queue(maxsize=8)
        self.error = None
        self.start()

    def run(self):
        while True:
            chunk = self.q.get()
            if chunk is None:
                return
            if self.error is None:
                try:
                    self.fn(chunk)
                except BaseException as e:  # noqa: BLE001 - re-raised by close
                    self.error = e

    def close(self):
        self.q.put(None)
        self.join()
        if self.error is not None:
            raise self.error


class _HashingWriter:
    """The save's write(): pickle's copies, the file's writes and the
    sha256 overlap, each on its thread (pickle hands write() a new bytes
    object each time, which the stages share)."""

    def __init__(self, f):
        self.sha = hashlib.sha256()
        self.stages = (_Stage(f.write), _Stage(self.sha.update))

    def write(self, b):
        b = b if isinstance(b, bytes) else bytes(b)
        for st in self.stages:
            st.q.put(b)
        return len(b)

    def close(self):
        for st in self.stages:
            st.close()
        return self.sha.hexdigest()


def _save_hashed(obj, path):
    """``framework.io_utils.save`` of ``obj``; returns the file's sha256,
    computed as the bytes are written."""
    from ..framework.io_utils import _to_serializable, dump
    with open(path, "wb") as f:
        w = _HashingWriter(f)
        try:
            dump(_to_serializable(obj), w)
        finally:
            digest = w.close()
    return digest


def _load_verified(path):
    """Load one checkpoint file, verifying it against its ``.sha256``
    sidecar first when one exists (checkpoints predating the sidecar load
    unverified); the file is read once, for the digest and the unpickling.
    Any damage — digest mismatch, torn pickle — surfaces as
    :class:`CorruptCheckpointError` so the caller can fall back."""
    from ..framework.io_utils import _from_serializable, loads
    want = None
    try:
        with open(path + ".sha256") as f:
            want = f.read().strip() or None
    except OSError:
        pass
    with open(path, "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest() if want is not None else None
    if got != want:
        raise CorruptCheckpointError(
            f"{path}: sha256 mismatch on restore "
            f"(got {got[:12]}, recorded {want[:12]})")
    try:
        return _from_serializable(loads(data))
    except Exception as e:
        raise CorruptCheckpointError(
            f"{path}: unreadable checkpoint: {e}") from e


def _unwrap_model(model):
    # fleet's wrappers hold the model as ``_layers``
    return getattr(model, "_layers", model)


def _unwrap_optimizer(optimizer):
    """(the base optimizer, the ZeRO-1 wrapper or None) under fleet's
    wrappers."""
    from .fleet.sharding_optimizer import ShardingOptimizerWrapper
    zero, opt = None, optimizer
    while hasattr(opt, "_inner"):
        if isinstance(opt, ShardingOptimizerWrapper):
            zero = opt
        opt = opt._inner
    return opt, zero


def _coord(axis):
    from .mesh import get_mesh
    mesh = get_mesh()
    return max(mesh.group(axis).rank, 0) if axis in mesh.axis_names else 0


def _pipeline_index(name):
    """A pipeline layer's global index from its state's name, or -1."""
    parts = name.split(".")
    if len(parts) > 1 and parts[0] == "run_function" and parts[1].isdigit():
        return int(parts[1])
    return -1


def _local_part(inner, base):
    """This rank's part of the checkpoint: its stage's full-layout state
    (shards gathered), its parameters' names in order, and the optimizer
    state of the parameters it owns, by parameter name. Every member of
    each model group calls it, in one order."""
    # a later stage's copy of a shared parameter equals the first stage's
    skip = {n for n, p in inner.named_parameters()
            if getattr(p, "pp_shared_copy", False)}
    full = {k: v for k, v in full_state_dict(inner).items()
            if k not in skip}
    params = {n: p for n, p in inner.named_parameters() if n not in skip}
    names = list(params)
    part = {"stage": getattr(inner, "stage_id", None) or 0,
            "params": names,
            "named": {n: p.name for n, p in params.items()
                      if getattr(p, "name", None)},
            "model": {k: _numpy_from_tensor(v) for k, v in full.items()},
            "optimizer": {}}
    if base is None:
        return part
    name_of = {id(p): n for n, p in params.items()}
    for p in base._parameter_list or ():
        name = name_of.get(id(p))
        if name is None:
            continue
        for acc_name in sorted(base._accumulators):
            t = base._accumulators[acc_name].get(id(p))
            if t is None:
                continue
            split = param_split(p)
            if split is not None and tuple(t.shape) == tuple(p.shape):
                t = unshard(t, split)
            part["optimizer"].setdefault(name, {})[acc_name] = \
                _numpy_from_tensor(t)
    return part


def _merge(parts, inner):
    """The parts of every stage and ZeRO rank as the reference's blob:
    the model's parameters in the whole model's order, then its buffers;
    the optimizer's state under ``param_{i}__{accumulator}``."""
    order = []
    seen = set()
    for part in sorted(parts, key=lambda p: p["stage"]):
        for n in part["params"]:
            if n not in seen:
                seen.add(n)
                order.append(n)
    if getattr(inner, "stage_id", None) is not None:
        order.sort(key=_pipeline_index)   # stable: in-layer order stays
    arrays = {}
    for part in parts:
        for k, v in part["model"].items():
            arrays.setdefault(k, v)
    model = {n: arrays[n] for n in order}
    model.update((k, v) for k, v in arrays.items() if k not in model)
    optimizer = {}
    for i, n in enumerate(order):
        for part in parts:
            key = part["named"].get(n) or f"param_{i}"
            for acc, v in part["optimizer"].get(n, {}).items():
                optimizer.setdefault(f"{key}__{acc}", v)
    return model, optimizer


def _gather_parts(part, replicas):
    """Rank 0's list of the parts of every rank whose coordinates on the
    ``replicas`` axes are 0 (each stage, each ZeRO-1 rank); None
    elsewhere."""
    import torch.distributed as dist

    from .env import get_rank, get_world_size
    from .mesh import get_mesh
    if get_world_size() == 1 or not (dist.is_available()
                                     and dist.is_initialized()):
        return [part]
    mesh = get_mesh()
    keep = [a for a in replicas if a in mesh.axis_names]
    ranks = np.moveaxis(mesh.ranks, [mesh.axis_names.index(a) for a in keep],
                        list(range(len(keep))))[(0,) * len(keep)].reshape(-1)
    senders = sorted(int(r) for r in ranks)
    me = get_rank()
    if me == 0:
        parts = [part] if 0 in senders else []
        for r in senders:
            if r != 0:
                box = [None]
                dist.recv_object_list(box, src=r)
                parts.append(box[0])
        return parts
    if me in senders:
        dist.send_object_list([part], dst=0)
    return None


def gather_hybrid_state(model, optimizer=None):
    """The whole model's and optimizer's state, as the checkpoint holds
    them (module docstring), on rank 0: ({name: array}, {key: array}); None
    on every other rank. Every rank calls it."""
    from .env import get_rank
    inner = _unwrap_model(model)
    base = _unwrap_optimizer(optimizer)[0] if optimizer is not None \
        else None
    part = _local_part(inner, base)
    # the ranks whose part another rank sends: its data and model peers,
    # and its sharding peers unless ZeRO-1 split the optimizer's state
    # (ZeRO-3's shards were gathered whole into every part)
    zero1 = optimizer is not None and _unwrap_optimizer(optimizer)[1] \
        is not None and not _unwrap_optimizer(optimizer)[1].shards_params
    replicas = ("data", "model") if zero1 else ("data", "model", "sharding")
    if any(_coord(a) for a in replicas):
        part = None     # a replica of what another rank sends
    parts = _gather_parts(part, replicas)
    if get_rank() != 0:
        return None
    model_arrays, opt_arrays = _merge(parts, inner)
    if base is not None:
        sched = base.state_dict().get("LR_Scheduler")
        if sched is not None:
            opt_arrays["LR_Scheduler"] = sched
    return model_arrays, opt_arrays


def save_hybrid_checkpoint(path, model, optimizer=None, meta=None):
    """Gather the whole state to rank 0 and save one artifact (module
    docstring). Every rank calls it; returns ``path``."""
    from ..framework.flags import get_flag
    from ..resilience.recovery import current_generation
    from ..resilience.snapshot import _ASYNC_LATER
    from .collective import barrier
    if get_flag("FLAGS_async_checkpoint", False):
        raise NotImplementedError(_ASYNC_LATER)
    state = gather_hybrid_state(model, optimizer)
    if state is not None:
        meta = dict(meta or {})
        gen = current_generation()
        if gen and "generation" not in meta:
            meta["generation"] = gen
        blob = {"model": state[0], "meta": meta}
        if optimizer is not None:
            blob["optimizer"] = state[1]
        if os.path.exists(path):
            if os.path.exists(path + ".sha256"):
                os.replace(path + ".sha256", path + ".old.sha256")
            os.replace(path, path + ".old")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        digest = _save_hashed(blob, path)
        tmp = f"{path}.sha256.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(digest + "\n")
        os.replace(tmp, path + ".sha256")
    barrier()
    return path


def _check_layout(inner, saved):
    """The reference's checks: every key present, every shape the
    model's; a distributed parameter's axis must tile its ranks
    (C-ref-23)."""
    own = local_state_dict(inner)
    missing = set(own) - set(saved)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    splits = {n: param_split(p) for n, p in inner.named_parameters()
              if param_split(p) is not None}
    for k, t in own.items():
        shape = tuple(saved[k].shape)
        want = list(t.shape)
        split = splits.get(k)
        if split is not None:
            if len(shape) == len(want) and \
                    shape[split.axis] % (split.blocks * split.nranks):
                raise ValueError(
                    f"checkpoint param '{k}' of shape {shape} does not tile "
                    f"the {split.nranks} model ranks on axis {split.axis} "
                    f"(ROADMAP C-ref-23: a tensor-parallel layer holds its "
                    f"shard and cannot be replicated instead)")
            want[split.axis] *= split.nranks
        if shape != tuple(want):
            raise ValueError(
                f"checkpoint param '{k}' has shape {shape}, model expects "
                f"{tuple(want)}")


def _apply_optimizer(blob, inner, optimizer):
    """Each local parameter's accumulators from the blob's
    ``param_{i}__*`` (i its index in the saved model's order, parameters
    first), this rank's shard of a distributed one; under ZeRO-1 only the
    parameters this rank owns."""
    base = _unwrap_optimizer(optimizer)[0]
    saved = blob["optimizer"]
    index = {n: i for i, n in enumerate(blob["model"])}
    params = dict(inner.named_parameters())
    name_of = {id(p): n for n, p in params.items()}
    local_names = dict(zip((id(p) for p in base._parameter_list or ()),
                           base._param_names()))
    owned = base._owned_ids
    by_prefix = {}
    for key, val in saved.items():
        if "__" in key:
            pname, acc = key.rsplit("__", 1)
            by_prefix.setdefault(pname, []).append((acc, val))
    out = {}
    for p in base._parameter_list or ():
        name = name_of.get(id(p))
        if name is None or (owned is not None and id(p) not in owned):
            continue
        pname = getattr(p, "name", None) or f"param_{index[name]}"
        split = param_split(p)
        for acc, val in by_prefix.get(pname, ()):
            t = val if isinstance(val, torch.Tensor) else \
                tensor_from_numpy(np.asarray(val))
            if split is not None and t.dim() == p.dim() and \
                    tuple(t.shape) != tuple(p.shape):
                t = _shard(t, split)
            out[f"{local_names[id(p)]}__{acc}"] = t
    if "LR_Scheduler" in saved:
        out["LR_Scheduler"] = saved["LR_Scheduler"]
    base.set_state_dict(out)


def _apply_blob(blob, model, optimizer=None):
    """A restored blob ({model, optimizer?, meta?}) into this rank's part
    of the model and optimizer; returns the blob's meta."""
    inner = _unwrap_model(model)
    saved = blob["model"]
    _check_layout(inner, saved)
    load_numpy_state_dict(inner, {k: saved[k]
                                  for k in local_state_dict(inner)})
    if optimizer is not None and "optimizer" in blob:
        _apply_optimizer(blob, inner, optimizer)
    return blob.get("meta", {})


def reshard_model(model, full_state=None):
    """Re-apply ``full_state`` ({name: full array}; the model's own,
    gathered over its groups, by default) to the model's current layout,
    in place: each rank its shards, each stage holding a shared parameter
    the first stage's copy. Every rank calls it."""
    inner = _unwrap_model(model)
    if full_state is None:
        full_state = full_state_dict(inner)
    _check_layout(inner, full_state)
    load_numpy_state_dict(inner, {k: full_state[k]
                                  for k in local_state_dict(inner)})
    engine = getattr(model, "_engine", None)
    if engine is not None:
        engine._sync_shared_params()
    return model


def load_hybrid_checkpoint(path, model, optimizer=None):
    """Load a checkpoint saved at any layout into this rank's part of the
    model (and optimizer) at the current one (module docstring); returns
    its meta.

    ``path`` may be a checkpoint root directory (or one manifest file):
    the newest committed manifest that verifies restores
    (``resilience.snapshot.load_blob``). A plain file is verified against
    its sha256 sidecar; a mismatch, a torn pickle or a file lost between
    the save's two renames falls back to the retained ``.old`` (itself
    verified), and the meta then carries ``restored_from_fallback``."""
    from ..resilience import snapshot as _snapshot
    if os.path.isdir(path) or \
            _snapshot.MANIFEST_RE.match(os.path.basename(path)):
        blob, src = _snapshot.load_blob(path)
        meta = _apply_blob(blob, model, optimizer)
        ts = blob.get("train_state")
        if ts:
            _snapshot.restore_train_state(ts)
        meta.setdefault("restored_from", src)
        return meta
    try:
        blob = _load_verified(path)
    except (CorruptCheckpointError, FileNotFoundError) as e:
        old = path + ".old"
        if not os.path.exists(old):
            raise
        try:
            from ..resilience.recovery import get_journal
            get_journal().record("corrupt_restore", path=path,
                                 detail=str(e), fallback=old)
        except Exception:
            pass  # journaling is best effort on the failure path
        blob = _load_verified(old)
        blob.setdefault("meta", {})["restored_from_fallback"] = True
    return _apply_blob(blob, model, optimizer)
