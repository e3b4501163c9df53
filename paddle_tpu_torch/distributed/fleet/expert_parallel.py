"""Elastic expert-parallel MoE engine (port of
paddle_tpu/distributed/fleet/expert_parallel.py).

Experts, unlike data-parallel or ZeRO replicas, live on exactly one rank,
so a dead expert-parallel rank loses model state outright unless the
system can (a) prove which experts were orphaned and (b) re-adopt them
from durable storage into a placement rebuilt over the survivors:

- an :class:`ExpertPlacement` map (expert id -> owning rank, round-robin
  over the sorted rank set, rebuilt on every resize);
- generation-fenced dispatch/combine exchanges (chaos sites
  ``moe.dispatch`` and ``moe.combine``) that ride the port's
  ``collective.alltoall``: frames are stamped with the recovery
  generation at routing time, and a frame of a previous incarnation of
  the group fails typed with
  :class:`~paddle_tpu_torch.resilience.watchdog.StaleGeneration`;
- capacity-factor routing with token-drop accounting
  (``moe.tokens_dropped_total`` counter, ``moe.capacity_utilization_ratio``
  and ``moe.aux_loss_ratio`` gauges): a drop fraction past the budget
  raises :class:`TokenDropOverflow`;
- expert-sharded checkpoints: each rank's slab is one
  ``kind="expert_shard"`` file of an ``AsyncCheckpointer`` manifest, with
  its expert ids and the expert-parallel degree in the file's entry, so a
  manifest committed at one degree restores into a placement at another;
- a journaled resize protocol (chaos site ``moe.resize``):
  ``moe_resize_started`` before any state moves, then
  ``moe_resize_completed`` or ``moe_resize_aborted``; a death in between
  leaves a started record that :meth:`ExpertParallelEngine.
  replay_pending_resizes` re-runs on restart.

The engine's arithmetic is the reference's plain numpy (a frozen seeded
gate, linear experts, manual MSE gradients), so its ``state_digest``
equals the reference engine's bit for bit on the same seeded batches:
faults may rewind training to the last committed manifest, never change
what it computes. The exchange rides the eager ``alltoall`` in both
modes: the reference's ``compiled`` single-controller seam (one
identity program over the frame counts) has no counterpart in a CUDA
graph, so ``compiled`` is accepted for the reference's signature only. The
MoE layer for real models is ``paddle_tpu_torch.incubate.MoELayer``.
"""
from __future__ import annotations

import os
import time

import numpy as np

from ...framework.errors import (
    EnforceNotMet, NotFoundError, PreconditionNotMetError,
    ResourceExhaustedError,
)
from ...resilience.faults import maybe_inject
from ...resilience.watchdog import StaleGeneration

__all__ = ["ExpertPlacement", "ExpertParallelEngine",
           "ExpertPlacementError", "TokenDropOverflow"]


class ExpertPlacementError(EnforceNotMet):
    """The expert → rank placement is invalid or experts were lost: an
    expert has no owning rank, is owned twice, or could not be re-adopted
    from any committed expert-sharded manifest after a resize."""


class TokenDropOverflow(ResourceExhaustedError):
    """Capacity routing dropped more than the configured budget of token
    assignments in one step. Raised (never swallowed): persistent overflow
    means the capacity factor is mis-sized for the workload and silently
    passing tokens through as residuals would hide a quality regression."""


def _registry():
    from ...profiler.metrics import get_registry
    return get_registry()


def _current_generation():
    from ...resilience.recovery import current_generation
    return current_generation()


class ExpertPlacement:
    """Deterministic expert → rank map: expert ``e`` lives on
    ``ranks[e % len(ranks)]`` over the *sorted* rank set, so every rank can
    rebuild the identical map from the membership alone (no coordination
    round) and a resize is a pure function of the survivor set."""

    def __init__(self, num_experts, ranks):
        ranks = tuple(sorted({int(r) for r in ranks}))
        if not ranks:
            raise ExpertPlacementError(
                "expert placement needs at least one rank")
        if int(num_experts) < 1:
            raise ExpertPlacementError(
                f"expert placement needs >=1 expert, got {num_experts}")
        self.num_experts = int(num_experts)
        self.ranks = ranks

    def rank_of(self, expert_id):
        e = int(expert_id)
        if not 0 <= e < self.num_experts:
            raise ExpertPlacementError(
                f"expert {e} out of range [0, {self.num_experts})")
        return self.ranks[e % len(self.ranks)]

    def experts_on(self, rank):
        return tuple(e for e in range(self.num_experts)
                     if self.rank_of(e) == int(rank))

    def as_dict(self):
        return {e: self.rank_of(e) for e in range(self.num_experts)}

    def __eq__(self, other):
        return (isinstance(other, ExpertPlacement)
                and self.num_experts == other.num_experts
                and self.ranks == other.ranks)

    def __repr__(self):
        return (f"ExpertPlacement(num_experts={self.num_experts}, "
                f"ranks={self.ranks})")


class ExpertParallelEngine:
    """Single-controller expert-parallel training engine with elastic
    resize. Holds one parameter slab per ep rank ({expert_id: {"w", "b"}}),
    routes every batch through capacity-bounded top-k dispatch/combine, and
    checkpoints/restores slabs as ``expert_shard`` manifest files.

    All state transitions are deterministic per (seed, batch stream):
    expert parameters are initialized per *expert id* (placement
    independent), the gate is frozen at init, and routing depends only on
    the inputs — so a restore + replay reproduces the golden loss curve
    bitwise regardless of how many resizes happened in between.
    """

    def __init__(self, num_experts, d_model, ranks, *, top_k=2,
                 capacity_factor=1.25, seed=0, lr=0.05,
                 max_drop_fraction=1.0, checkpointer=None, journal=None,
                 compiled=None):
        """``compiled`` is accepted for the reference's signature; the
        exchange rides the eager ``alltoall`` either way (module
        docstring)."""
        self.num_experts = int(num_experts)
        self.d_model = int(d_model)
        self.top_k = min(int(top_k), self.num_experts)
        self.capacity_factor = float(capacity_factor)
        self.seed = int(seed)
        self.lr = float(lr)
        self.max_drop_fraction = float(max_drop_fraction)
        self._ckpt = checkpointer
        self._journal = journal
        self._placement = ExpertPlacement(self.num_experts, ranks)
        gate_rng = np.random.RandomState(self.seed * 7919 + 11)
        self._gate_w = gate_rng.randn(
            self.d_model, self.num_experts).astype(np.float64)
        self._slabs = {r: {} for r in self._placement.ranks}
        for e in range(self.num_experts):
            self._slabs[self._placement.rank_of(e)][e] = \
                self._init_expert(e)
        self._resize_seq = 0
        self.tokens_dropped_total = 0
        self.aux_loss = 0.0
        self.last_stats = {}

    # -- deterministic parameter init ------------------------------------
    def _init_expert(self, expert_id):
        rng = np.random.RandomState(self.seed * 1000003 + int(expert_id))
        return {"w": (rng.randn(self.d_model, self.d_model)
                      * 0.1).astype(np.float64),
                "b": np.zeros(self.d_model, np.float64)}

    # -- introspection ----------------------------------------------------
    @property
    def placement(self):
        return self._placement

    @property
    def ep_degree(self):
        return len(self._placement.ranks)

    def owned_experts(self):
        """{rank: sorted expert ids} for the live slabs (audit surface:
        every expert exactly once or the placement is corrupt)."""
        return {r: tuple(sorted(slab)) for r, slab in self._slabs.items()}

    def _check_no_expert_lost(self):
        seen = {}
        for r, slab in self._slabs.items():
            for e in slab:
                if e in seen:
                    raise ExpertPlacementError(
                        f"expert {e} owned by both rank {seen[e]} and "
                        f"rank {r}")
                seen[e] = r
        missing = set(range(self.num_experts)) - set(seen)
        if missing:
            raise ExpertPlacementError(
                f"experts lost (no owning rank): {sorted(missing)}")

    # -- generation-fenced exchange ---------------------------------------
    def _stamp(self):
        return _current_generation()

    def _exchange(self, frames, section):
        """Validate every frame's generation stamp against the live
        recovery generation — the fence `wire.recv_frame` applies to p2p
        traffic, applied to the in-process alltoall frames. Gen 0 means
        unfenced (no re-rendezvous has happened yet)."""
        cur = _current_generation()
        for f in frames:
            fg = int(f.get("generation", 0))
            if fg and cur and fg != cur:
                raise StaleGeneration(fg, cur, section=section)
        return frames

    def _ride_alltoall(self, frames):
        """Ride one tiny real collective per exchange (the frames' token
        counts), so the ``collective.alltoall`` injection site, the
        StepTimer's collective_wait attribution and, over ranks, the
        fenced wire all see the MoE traffic."""
        import torch

        from .. import collective
        counts = np.asarray(
            [float(len(f.get("tokens", ()))) for f in frames], np.float32)
        collective.alltoall(torch.from_numpy(counts))

    # -- routing -----------------------------------------------------------
    def _gate_probs(self, x):
        logits = x @ self._gate_w
        z = logits - logits.max(axis=1, keepdims=True)
        ez = np.exp(z)
        return ez / ez.sum(axis=1, keepdims=True)

    def _route(self, probs, capacity):
        """Per-k capacity assignment (GShard order: token index order
        within each expert's queue). Returns (assignments, dropped,
        kept_slots) where assignments is [(k, expert_id, token_idx array,
        gate_w array)]."""
        n, E = probs.shape
        order = np.argsort(-probs, axis=1, kind="stable")[:, :self.top_k]
        assignments, dropped, kept = [], 0, 0
        for k in range(self.top_k):
            idx_k = order[:, k]
            for e in range(E):
                toks = np.nonzero(idx_k == e)[0]
                keep_t, drop_t = toks[:capacity], toks[capacity:]
                dropped += int(drop_t.size)
                kept += int(keep_t.size)
                if keep_t.size:
                    assignments.append(
                        (k, e, keep_t, probs[keep_t, e]))
        return assignments, dropped, kept

    def dispatch(self, x, probs=None, capacity=None):
        """Route a batch to per-rank token frames (chaos site
        ``moe.dispatch``). Returns (frames, route_info); each frame is
        stamped with the live recovery generation and carries the tokens
        destined for one ep rank's experts."""
        maybe_inject("moe.dispatch")
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        if probs is None:
            probs = self._gate_probs(x)
        if capacity is None:
            capacity = max(1, int(self.top_k * n / self.num_experts
                                  * self.capacity_factor))
        assignments, dropped, kept = self._route(probs, capacity)
        gen = self._stamp()
        frames = []
        for r in self._placement.ranks:
            tokens = [(k, e, toks, gw, x[toks])
                      for (k, e, toks, gw) in assignments
                      if self._placement.rank_of(e) == r]
            frames.append({"generation": gen, "rank": r, "tokens": tokens})
        t0 = time.perf_counter()
        from ...profiler.steptimer import get_steptimer
        with get_steptimer().phase("step/collective_wait"):
            self._ride_alltoall(frames)
            self._exchange(frames, section="moe.dispatch")
        _registry().observe("moe.dispatch_wait_ms",
                            (time.perf_counter() - t0) * 1e3)
        route_info = {"n_tokens": n, "capacity": capacity,
                      "dropped": dropped, "kept": kept, "probs": probs,
                      "assignments": assignments}
        return frames, route_info

    def compute(self, frames):
        """Run each frame's tokens through the owning rank's experts.
        Returns output frames (same generation stamp as the inputs)."""
        out_frames = []
        for f in frames:
            slab = self._slabs.get(f["rank"], {})
            outs = []
            for (k, e, toks, gw, xt) in f["tokens"]:
                if e not in slab:
                    raise ExpertPlacementError(
                        f"rank {f['rank']} routed expert {e} it does not "
                        f"own (placement map out of date?)")
                p = slab[e]
                outs.append((k, e, toks, gw, xt, xt @ p["w"] + p["b"]))
            out_frames.append({"generation": f["generation"],
                               "rank": f["rank"], "tokens": outs})
        return out_frames

    def combine(self, out_frames, route_info):
        """Gather expert outputs back into token order (chaos site
        ``moe.combine``), apply gate weights and the Switch residual for
        dropped gate mass. Returns the (n, d_model) output batch."""
        maybe_inject("moe.combine")
        t0 = time.perf_counter()
        from ...profiler.steptimer import get_steptimer
        with get_steptimer().phase("step/collective_wait"):
            self._ride_alltoall(out_frames)
            self._exchange(out_frames, section="moe.combine")
        _registry().observe("moe.combine_wait_ms",
                            (time.perf_counter() - t0) * 1e3)
        n = route_info["n_tokens"]
        out = np.zeros((n, self.d_model), np.float64)
        kept_w = np.zeros(n, np.float64)
        for f in out_frames:
            for (k, e, toks, gw, xt, yt) in f["tokens"]:
                out[toks] += gw[:, None] * yt
                kept_w[toks] += gw
        return out, kept_w

    # -- one training step -------------------------------------------------
    def step(self, x, target, train=True):
        """One deterministic MoE step: gate → capacity routing → fenced
        dispatch/compute/combine → MSE loss (→ manual SGD on the routed
        experts). Updates the moe.* metrics and raises
        :class:`TokenDropOverflow` when the drop fraction exceeds
        ``max_drop_fraction``. Returns the scalar loss."""
        x = np.asarray(x, np.float64)
        target = np.asarray(target, np.float64)
        probs = self._gate_probs(x)
        E = self.num_experts
        me = probs.mean(axis=0)
        ce = np.bincount(probs.argmax(axis=1),
                         minlength=E) / float(x.shape[0])
        self.aux_loss = float(E * np.sum(me * ce))

        frames, info = self.dispatch(x, probs=probs)
        out_frames = self.compute(frames)
        out, kept_w = self.combine(out_frames, info)
        residual = np.clip(1.0 - kept_w, 0.0, 1.0)[:, None] * x
        y = out + residual
        loss = float(np.mean((y - target) ** 2))

        n_assign = info["n_tokens"] * self.top_k
        drop_frac = info["dropped"] / float(max(1, n_assign))
        util = info["kept"] / float(
            max(1, self.num_experts * info["capacity"] * self.top_k))
        self.tokens_dropped_total += info["dropped"]
        self.last_stats = {"loss": loss, "dropped": info["dropped"],
                           "drop_fraction": drop_frac,
                           "capacity": info["capacity"],
                           "capacity_utilization": util,
                           "aux_loss": self.aux_loss}
        reg = _registry()
        if info["dropped"]:
            reg.inc_counter("moe.tokens_dropped_total", info["dropped"])
        reg.set_gauge("moe.capacity_utilization_ratio", util)
        reg.set_gauge("moe.aux_loss_ratio", self.aux_loss)
        if drop_frac > self.max_drop_fraction:
            raise TokenDropOverflow(
                f"dropped {info['dropped']}/{n_assign} token assignments "
                f"({drop_frac:.1%} > budget "
                f"{self.max_drop_fraction:.1%}) at capacity "
                f"{info['capacity']} — raise capacity_factor")

        if train:
            g = 2.0 * (y - target) / y.size
            for f in out_frames:
                slab = self._slabs[f["rank"]]
                for (k, e, toks, gw, xt, yt) in f["tokens"]:
                    ge = g[toks] * gw[:, None]
                    slab[e]["w"] -= self.lr * (xt.T @ ge)
                    slab[e]["b"] -= self.lr * ge.sum(axis=0)
        return loss

    # -- expert-sharded checkpointing --------------------------------------
    def save(self, step=None, blocking=True):
        """Commit one expert-sharded checkpoint: one ``expert_shard`` file
        per ep rank, with that rank's expert ids and the ep degree recorded
        in the manifest entry (what restore-across-resize reads)."""
        if self._ckpt is None:
            raise PreconditionNotMetError(
                "ExpertParallelEngine.save needs a checkpointer")
        R = self.ep_degree
        files = {}
        for r in self._placement.ranks:
            eids = sorted(self._slabs[r])
            payload = {int(e): {"w": self._slabs[r][e]["w"],
                                "b": self._slabs[r][e]["b"]}
                       for e in eids}
            files[f"moe_expert_rank{r:03d}.pdexpert"] = (
                payload, "expert_shard",
                {"expert_ids": [int(e) for e in eids],
                 "ep_degree": R, "ep_rank": int(r)})
        return self._ckpt.save(
            files, step=step,
            meta={"ep_degree": R, "num_experts": self.num_experts},
            blocking=blocking)

    def _expert_manifests(self):
        """Committed manifests that reference expert_shard files, newest
        first, each verified before use (corrupt ones are skipped — same
        walk discipline as ``snapshot.load_blob``)."""
        from ...resilience.snapshot import (
            CheckpointCommitError, list_manifests, verify_manifest,
        )
        if self._ckpt is None:
            return
        root = self._ckpt.root
        for _, mp in sorted(list_manifests(root), reverse=True):
            try:
                man = verify_manifest(mp)
            except CheckpointCommitError:
                continue
            if any(i.get("kind") == "expert_shard"
                   for i in man["files"].values()):
                yield mp, man

    def _adopt_from_manifests(self, expert_ids):
        """Load the named experts from the newest committed expert-sharded
        manifests (the per-file ``expert_ids`` index tells us which files
        to read — works across ep-degree change because the files are
        keyed by expert id, not rank count)."""
        from ...framework.io_utils import load as load_obj
        need = set(int(e) for e in expert_ids)
        found = {}
        for mp, man in self._expert_manifests():
            if not need - set(found):
                break
            mroot = os.path.dirname(os.path.abspath(mp))
            for rel, fi in sorted(man["files"].items()):
                if fi.get("kind") != "expert_shard":
                    continue
                ids = {int(i) for i in (fi.get("expert_ids") or ())}
                want = (need - set(found)) & ids
                if not want:
                    continue
                payload = load_obj(os.path.join(mroot, rel))
                for e in want:
                    p = payload[e]
                    found[e] = {"w": np.asarray(p["w"], np.float64),
                                "b": np.asarray(p["b"], np.float64)}
        missing = need - set(found)
        if missing:
            raise ExpertPlacementError(
                f"experts {sorted(missing)} not restorable from any "
                f"committed expert-sharded manifest under "
                f"{getattr(self._ckpt, 'root', None)!r} — zero-experts-"
                f"lost contract violated")
        return found

    # -- elastic resize -----------------------------------------------------
    def resize(self, new_ranks, _resize_id=None):
        """Rebuild the placement over ``new_ranks`` (chaos site
        ``moe.resize``): surviving ranks hand their slabs over in-process;
        experts owned by departed ranks are re-adopted from the newest
        committed expert-sharded manifest. Journaled as
        ``moe_resize_started`` → ``moe_resize_completed`` /
        ``moe_resize_aborted``; a hard death in between leaves the started
        record for :meth:`replay_pending_resizes`. Returns the sorted list
        of adopted (orphaned) expert ids."""
        new = ExpertPlacement(self.num_experts, new_ranks)
        old = self._placement
        live = {}
        for slab in self._slabs.values():
            live.update(slab)
        orphaned = sorted(set(range(self.num_experts)) - set(live))
        if _resize_id is None:
            self._resize_seq += 1
            rid = f"resize-{self._resize_seq}"
            replay = False
        else:
            rid = _resize_id
            replay = True
        gen = _current_generation()
        self._journal_record("moe_resize_started", resize=rid,
                     from_ranks=list(old.ranks), to_ranks=list(new.ranks),
                     orphaned=orphaned, generation=gen, replay=replay)
        try:
            maybe_inject("moe.resize")
            adopted = self._adopt_from_manifests(orphaned) if orphaned \
                else {}
            slabs = {r: {} for r in new.ranks}
            for e in range(self.num_experts):
                params = live.get(e) or adopted.get(e)
                if params is None:
                    raise ExpertPlacementError(
                        f"expert {e} neither live nor adoptable")
                slabs[new.rank_of(e)][e] = params
            self._slabs = slabs
            self._placement = new
            self._check_no_expert_lost()
        except Exception as e:
            self._journal_record("moe_resize_aborted", resize=rid,
                         detail=str(e)[:200], generation=gen)
            raise
        self._journal_record("moe_resize_completed", resize=rid,
                     to_ranks=list(new.ranks), adopted=orphaned,
                     generation=gen)
        reg = _registry()
        reg.inc_counter("moe.resizes_total")
        if orphaned:
            reg.inc_counter("moe.experts_adopted_total", len(orphaned))
        return orphaned

    def drop_rank(self, rank):
        """Simulate/observe one ep rank's death: its slab is forgotten
        (the process is gone); the experts it owned become orphans until
        the next :meth:`resize` re-adopts them from the manifest."""
        self._slabs.pop(int(rank), None)

    def restore(self):
        """Full-state rewind: reload *every* expert from the newest
        committed expert-sharded manifest into the current placement and
        return that manifest's step (the caller rewinds its loop there and
        replays — the loss-parity contract). Raises NotFoundError when no
        expert manifest is committed."""
        for mp, man in self._expert_manifests():
            adopted = self._adopt_from_manifests(range(self.num_experts))
            slabs = {r: {} for r in self._placement.ranks}
            for e in range(self.num_experts):
                slabs[self._placement.rank_of(e)][e] = adopted[e]
            self._slabs = slabs
            self._check_no_expert_lost()
            return int(man.get("step") or 0)
        raise NotFoundError(
            f"no committed expert-sharded manifest under "
            f"{getattr(self._ckpt, 'root', None)!r}")

    # -- journal ------------------------------------------------------------
    def _journal_record(self, event, **fields):
        if self._journal is None:
            return
        try:
            self._journal.record(event, **fields)
        except Exception:
            pass  # journaling is best-effort on the failure path

    def replay_pending_resizes(self):
        """Re-run every journaled ``moe_resize_started`` that never reached
        a terminal record (the mid-resize-death contract): on restart the
        journal is the authority on which placement change was in flight.
        Returns the replayed resize ids."""
        if self._journal is None:
            return []
        started, terminal = {}, set()
        for e in self._journal.entries():
            ev = e.get("event", "")
            if ev == "moe_resize_started":
                started[e.get("resize")] = e
            elif ev in ("moe_resize_completed", "moe_resize_aborted"):
                terminal.add(e.get("resize"))
        replayed = []
        for rid, rec in sorted(started.items(), key=lambda kv: str(kv[0])):
            if rid in terminal:
                continue
            self.resize(rec.get("to_ranks") or self._placement.ranks,
                        _resize_id=rid)
            replayed.append(rid)
        return replayed

    # -- state digest (parity checks) ---------------------------------------
    def state_digest(self):
        """Order-independent digest of every expert's parameters — equal
        digests mean equal model state regardless of placement."""
        import hashlib
        h = hashlib.sha256()
        live = {}
        for slab in self._slabs.values():
            live.update(slab)
        for e in sorted(live):
            h.update(str(e).encode())
            h.update(np.ascontiguousarray(live[e]["w"]).tobytes())
            h.update(np.ascontiguousarray(live[e]["b"]).tobytes())
        return h.hexdigest()
