"""Silent-data-corruption defence: checksum consensus and step replay
(port of paddle_tpu/resilience/integrity.py).

A card that flips a bit does not crash: it trains a slightly wrong model,
silently. The one cheap invariant a data-parallel group has is that the
post-update parameters are bitwise identical on every replica (same
init, same data, same deterministic update). This module turns that
invariant into a detector:

- :func:`checksum_state`: one sha256 over the flattened state dict(s),
  bitwise (key path, dtype, shape and raw bytes per leaf, in the
  reference's order and spelling), so one flipped bit on one replica
  changes its digest and nobody else's, and state carried into either
  package hashes to the same digest in both. A bf16 tensor hashes as
  dtype ``"bfloat16"`` and its 16-bit words. The card's tensors of one
  check come to the host in one copy: their bytes are packed into one
  buffer on the card first. The ``device.bitflip`` injection site
  perturbs the digest as a real flipped parameter bit would.
- :class:`ConsensusChecker`: every ``FLAGS_integrity_check_interval``
  steps, publish the digest to the elastic store and majority-vote across
  the group. The minority rank(s) are named in a typed
  :class:`IntegrityError` (kind ``"sdc"``), which ``RecoveryManager``
  journals and recovers from: the culprit marks ``quarantined.<rank>`` and
  the survivors re-rendezvous scaled-in without it.
- :class:`StepReplayBuffer`: a bounded ring of (step, rng state, input
  checksum, raw inputs) on the host. When a rank is accused the ring is
  dumped (``step_replay_rank<N>.json`` + ``.npz``, the reference's files,
  which ``tools/replay_step.py`` reads) and :meth:`StepReplayBuffer.replay`
  re-executes the flagged step on the CPU: a CPU digest equal to the
  majority's means the device computed garbage (hardware SDC), one equal
  to the accused rank's means the divergence is deterministic (a software
  bug), neither is ``"inconclusive"`` (a bf16 step of the card replayed on
  the host rounds elsewhere and lands here).

Consensus is store-mediated (no collective on the failure path: a corrupt
rank may not be able to agree collectively that it is corrupt) and the
clock and sleep are injectable, so tests drive the whole accuse ->
quarantine -> re-rendezvous cycle with no real sleeps.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..framework.flags import get_flag
from ..framework.io_utils import host_bytes
from .faults import maybe_inject, should_inject
from .watchdog import DistributedError

__all__ = ["IntegrityError", "checksum_state", "ConsensusChecker",
           "StepReplayBuffer", "run_step_on_cpu", "classify_replay"]


def _flag(name, default):
    v = get_flag(name, default)
    return default if v is None else v


def _process_rank():
    from ..distributed.env import get_rank
    return get_rank()


class IntegrityError(DistributedError):
    """A hardware-health invariant failed.

    ``kind`` is the journaled cause name (``"sdc"``, ``"preflight"``,
    ``"straggler"``, ``"replay"``): ``RecoveryManager`` journals ``kind``,
    not the class name. ``culprits`` are the accused ranks; a rank that
    finds itself among them quarantines itself.
    """

    def __init__(self, message, culprits=(), step=None, kind="sdc",
                 digests=None):
        super().__init__(message)
        self.culprits = sorted(int(r) for r in culprits)
        self.step = step
        self.kind = kind
        self.digests = dict(digests or {})


# -- bitwise state checksum -------------------------------------------------

_NP_DTYPE = {torch.bfloat16: "bfloat16", torch.bool: "bool"}


def _tensor_meta(t):
    """(dtype string, shape string) of a tensor in numpy's spelling, as the
    reference hashes the same array."""
    name = _NP_DTYPE.get(t.dtype)
    if name is None:
        name = _NP_DTYPE[t.dtype] = str(
            torch.empty((), dtype=t.dtype).numpy().dtype)
    return name, str(tuple(t.shape))


def _flatten(key, value, out):
    """The reference's ``_hash_tree`` walk, collecting ``(key, leaf)`` in
    hashing order (dicts by ``str`` of their keys, sequences by index)."""
    if isinstance(value, dict):
        for k in sorted(value, key=str):
            _flatten(f"{key}/{k}", value[k], out)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _flatten(f"{key}[{i}]", v, out)
    else:
        out.append((key, value))
    return out


def _hash_leaves(h, leaves):
    index = [i for i, (_, v) in enumerate(leaves)
             if isinstance(v, torch.Tensor)]
    host = dict(zip(index, host_bytes([leaves[i][1] for i in index])))
    for i, (key, value) in enumerate(leaves):
        if value is None:
            h.update(f"{key}=None".encode())
        elif i in host:
            dtype, shape = _tensor_meta(value)
            h.update(key.encode())
            h.update(dtype.encode())
            h.update(shape.encode())
            h.update(host[i])
        else:
            try:
                arr = np.asarray(value)
                h.update(key.encode())
                h.update(str(arr.dtype).encode())
                h.update(str(arr.shape).encode())
                h.update(np.ascontiguousarray(arr).tobytes())
            except Exception:
                h.update(f"{key}={value!r}".encode())


def state_bytes(objs):
    """Bytes :func:`checksum_state` hashes for ``objs`` (the tensors' and
    arrays' raw bytes)."""
    if not isinstance(objs, (list, tuple)):
        objs = [objs]
    n = 0
    for i, obj in enumerate(objs):
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
        for _, v in _flatten(f"#{i}", sd, []):
            if isinstance(v, torch.Tensor):
                n += v.numel() * v.element_size()
            elif v is not None:
                try:
                    n += np.asarray(v).nbytes
                except Exception:
                    pass
    return n


def checksum_state(objs):
    """sha256 digest over the state dict(s) of ``objs`` (anything with
    ``state_dict()``, or raw dicts, tensors and arrays). Bitwise: replicas
    holding identical state produce identical digests; one flipped bit
    anywhere produces a different one.

    ``device.bitflip`` is the corruption-style injection site: instead of
    raising, an armed rule flips one nibble of the digest, as a real
    flipped bit in this replica's memory would, which is what the
    consensus must catch.
    """
    maybe_inject("integrity.checksum")
    if not isinstance(objs, (list, tuple)):
        objs = [objs]
    leaves = []
    for i, obj in enumerate(objs):
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj
        _flatten(f"#{i}", sd, leaves)
    h = hashlib.sha256()
    _hash_leaves(h, leaves)
    digest = h.hexdigest()
    corrupted_at = should_inject("device.bitflip")
    if corrupted_at:
        from .recorder import get_recorder
        digest = format(int(digest[0], 16) ^ 0x1, "x") + digest[1:]
        # the evaluation that was corrupted (seq: the registry's count for
        # the site), so a post-mortem lines the flip up with the schedule
        note = get_recorder().start("device.bitflip", seq=int(corrupted_at))
        get_recorder().finish(note, status="corrupted")
    return digest


# -- deterministic step replay ----------------------------------------------

def _host_array(a):
    """A host numpy copy of an input (a bf16 tensor widens to float32,
    exactly: numpy has no bfloat16)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()
    return np.array(a, copy=True)


def _arrays_digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        arr = np.asarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def run_step_on_cpu(step_fn, entry):
    """Run ``step_fn(entry)`` with the host as the default device (torch's
    and the port's) and return the resulting digest. ``entry`` is a
    replay-ring record (``step``, ``rng_key``, ``inputs``,
    ``input_checksum``); ``step_fn`` may return a digest string, or state
    objects, checksummed with the :func:`checksum_state` the consensus
    used."""
    from ..core import device as _device
    prev = _device._current
    _device.set_device("cpu")
    try:
        with torch.device("cpu"):
            out = step_fn(entry)
    finally:
        _device._current = prev
    if isinstance(out, str):
        return out
    return checksum_state(out if isinstance(out, (list, tuple)) else [out])


def classify_replay(cpu_digest, expected_digest=None, observed_digest=None):
    """Name the failure mode from a CPU re-execution of the flagged step:
    the majority's (``expected``) digest reproduced -> ``"hardware_sdc"``;
    the accused rank's (``observed``) -> ``"software_bug"``; neither ->
    ``"inconclusive"``; nothing to compare -> ``"unverified"``."""
    if expected_digest is None and observed_digest is None:
        return "unverified"
    if expected_digest is not None and cpu_digest == expected_digest:
        return "hardware_sdc"
    if observed_digest is not None and cpu_digest == observed_digest:
        return "software_bug"
    return "inconclusive"


class StepReplayBuffer:
    """Bounded ring of the last K steps' replay material: the step, the
    rng state, host copies of the raw input batch and a checksum of those
    inputs (so the ring can prove its own copy was not what got
    corrupted). ``dump()`` writes ``step_replay_rank<N>.json`` + ``.npz``
    into the artifacts dir."""

    def __init__(self, size=None, rank=None):
        size = int(_flag("FLAGS_replay_buffer_size", 8)
                   if size is None else size)
        self._ring = collections.deque(maxlen=max(1, size))
        self.rank = _process_rank() if rank is None else int(rank)

    def __len__(self):
        return len(self._ring)

    def steps(self):
        return [e["step"] for e in self._ring]

    def get(self, step):
        for e in self._ring:
            if e["step"] == int(step):
                return e
        return None

    def record(self, step, rng_key=None, inputs=None):
        """Host-copy one step's inputs into the ring (the device buffers
        may be overwritten by the time anyone wants to replay)."""
        arrays = [_host_array(a) for a in (inputs or ())]
        entry = {
            "step": int(step),
            "rng_key": None if rng_key is None else _host_array(rng_key),
            "inputs": arrays,
            "input_checksum": _arrays_digest(arrays),
        }
        self._ring.append(entry)
        return entry

    def dump(self, dir=None, reason=""):
        """Atomically write the ring as a json (metadata) + npz (arrays)
        pair; returns the json path. Called on accusation, best effort."""
        from .recorder import artifacts_dir
        from .recovery import current_generation
        base = dir or artifacts_dir()
        os.makedirs(base, exist_ok=True)
        jpath = os.path.join(base, f"step_replay_rank{self.rank}.json")
        npath = os.path.join(base, f"step_replay_rank{self.rank}.npz")
        arrays, entries = {}, []
        for e in self._ring:
            names = []
            for i, a in enumerate(e["inputs"]):
                name = f"s{e['step']}_in{i}"
                arrays[name] = a
                names.append(name)
            rng_name = None
            if e["rng_key"] is not None:
                rng_name = f"s{e['step']}_rng"
                arrays[rng_name] = e["rng_key"]
            entries.append({"step": e["step"], "inputs": names,
                            "rng_key": rng_name,
                            "input_checksum": e["input_checksum"]})
        tmp = f"{npath}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, npath)
        meta = {"version": 1, "rank": self.rank, "reason": reason,
                "generation": current_generation(),
                "arrays": os.path.basename(npath), "entries": entries}
        tmp = f"{jpath}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, jpath)
        return jpath

    def replay(self, step, step_fn, expected_digest=None,
               observed_digest=None):
        """Re-execute one recorded step on the CPU and classify the
        divergence (:func:`classify_replay`). The entry's own input
        checksum is verified first: a corrupted ring cannot testify."""
        maybe_inject("integrity.replay")
        entry = self.get(step)
        if entry is None:
            raise KeyError(
                f"step {step} not in replay ring (have {self.steps()})")
        if _arrays_digest(entry["inputs"]) != entry["input_checksum"]:
            raise IntegrityError(
                f"replay ring entry for step {step} fails its own input "
                "checksum: the recorded batch is itself corrupt",
                step=step, kind="replay")
        digest = run_step_on_cpu(step_fn, entry)
        return {"step": int(step), "digest": digest,
                "classification": classify_replay(
                    digest, expected_digest, observed_digest)}


# -- cross-replica consensus ------------------------------------------------

class ConsensusChecker:
    """Periodic cross-replica state-checksum consensus.

    Call :meth:`after_step` once per training step; every ``interval``
    steps it publishes this rank's digest of the objects registered at
    construction under ``<job>/integrity.<generation>.<step>/rank.<rank>``
    (the reference's keys, so ranks of both packages vote together) and
    majority-votes across whatever the group published. Divergence raises
    :class:`IntegrityError` (kind ``"sdc"``) on every rank; the culprit
    also quarantines itself and dumps its replay ring, so the whole group
    funnels into ``RecoveryManager``'s re-rendezvous, which the culprit is
    kept out of.

    The warm-path cost is one sha256 over the state on the host and one
    store round trip per interval, accumulated in ``counters["seconds"]``
    and emitted as the ``integrity.check_ms`` profiler counter.
    """

    def __init__(self, elastic, objs, interval=None, timeout=None,
                 clock=None, sleep=None, recorder=None, replay=None,
                 poll_interval=0.05):
        self.elastic = elastic
        self.objs = list(objs) if isinstance(objs, (list, tuple)) else [objs]
        self.interval = int(_flag("FLAGS_integrity_check_interval", 100)
                            if interval is None else interval)
        self.timeout = float(_flag("FLAGS_integrity_consensus_timeout", 30.0)
                             if timeout is None else timeout)
        self._clock = clock
        self._sleep = sleep or time.sleep
        self.recorder = recorder
        self.replay = replay
        self.poll_interval = poll_interval
        self.counters = {"checks": 0, "divergences": 0, "seconds": 0.0}

    def _now(self):
        return self._clock() if self._clock is not None else time.monotonic()

    def _prefix(self, step):
        from .recovery import current_generation
        return (f"{self.elastic.job_id}/integrity."
                f"{current_generation()}.{int(step)}/")

    def after_step(self, step, inputs=None, rng_key=None):
        """Per-step hook: feed the replay ring, and on an interval
        boundary run the consensus check. Returns this rank's digest on
        check steps, None otherwise."""
        from ..profiler import record_counter
        from ..profiler.steptimer import get_steptimer
        t0 = time.perf_counter()
        digest = None
        try:
            with get_steptimer().phase("step/integrity"):
                if self.replay is not None:
                    self.replay.record(step, rng_key=rng_key, inputs=inputs)
                if self.interval > 0 and \
                        (int(step) + 1) % self.interval == 0:
                    digest = self.check(step)
        finally:
            dt = time.perf_counter() - t0
            self.counters["seconds"] += dt
            if digest is not None:
                record_counter("integrity.check_ms", dt * 1e3)
        return digest

    def check(self, step):
        """One consensus round at ``step``: publish, gather (bounded by
        ``timeout``: a dead peer must not hang the check), vote."""
        self.counters["checks"] += 1
        digest = checksum_state(self.objs)
        rank = self.elastic.rank
        prefix = self._prefix(step)
        self.elastic.store.put(prefix + f"rank.{rank}",
                               {"rank": rank, "digest": digest,
                                "step": int(step)})
        expected = None
        start = self._now()
        while True:
            reports = self.elastic.store.alive_values(prefix)
            # every rank of the largest group reported: no need to count
            # the live ones (the warm path's common case on the last
            # rank to arrive)
            if len(reports) >= getattr(self.elastic, "np_max", 0) > 0:
                break
            if expected is None:
                expected = max(self.elastic.np(), 1)
            if len(reports) >= expected:
                break
            if self._now() - start >= self.timeout:
                break
            self._sleep(self.poll_interval)
        by_rank = {int(r["rank"]): r["digest"] for r in reports}
        if len(by_rank) < 2:
            return digest  # nobody showed up to vote with
        tally = {}
        for r, d in by_rank.items():
            tally.setdefault(d, []).append(r)
        # deterministic across ranks: all vote on the same store contents,
        # ties broken by the digest string (a 1:1 split is unattributable
        # by counting; the replay classification decides)
        majority_digest = max(tally, key=lambda d: (len(tally[d]), d))
        culprits = sorted(r for d, ranks in tally.items()
                          if d != majority_digest for r in ranks)
        if not culprits:
            return digest
        self.counters["divergences"] += 1
        # int() before the ring entry opens: nothing between start and
        # finish may raise and leave it "started"
        step_i = int(step)
        if self.recorder is not None:
            entry = self.recorder.start("integrity.consensus")
            entry["culprits"] = culprits
            entry["step"] = step_i
            self.recorder.finish(entry, status="divergent")
        if rank in culprits:
            # the accused marks itself (kept out of the next generation's
            # rendezvous) and leaves its replay ring behind as evidence
            try:
                self.elastic.mark_quarantined(
                    reason=f"sdc: checksum minority at step {step}",
                    info={"step": int(step)})
            except Exception:
                pass
            if self.replay is not None:
                try:
                    self.replay.dump(reason=f"sdc accusation at step {step}")
                except Exception:
                    pass
        raise IntegrityError(
            f"parameter checksum divergence at step {step}: rank(s) "
            f"{culprits} disagree with the majority "
            f"({len(tally[majority_digest])}/{len(by_rank)} agree)",
            culprits=culprits, step=step, kind="sdc", digests=by_rank)
