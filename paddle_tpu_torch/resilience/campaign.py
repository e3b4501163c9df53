"""Unified chaos-campaign engine (port of paddle_tpu/resilience/campaign.py).

Every subsystem ships its own hand-wired chaos soak; this module exercises
the *composition*. A campaign is a sequence of episodes. Each episode:

1. samples a seeded multi-site fault **schedule** over the full
   injection-site manifest (the port's copy in :mod:`.injection_sites`,
   read through :func:`known_sites`; its names equal the reference's),
   composing
   rate rules, ``#N`` / ``#N+`` index rules, and windowed ``#N-M`` bursts
   across many sites at once;
2. drives an end-to-end **scenario** on a fake clock with zero real
   sleeps — ``training`` (RecoveryManager + AsyncCheckpointer + integrity
   consensus) or ``serving`` (InferenceServer + decode + disagg KV
   migration + mid-traffic rollout) — arming the schedule only after
   setup, exactly like the per-subsystem soaks;
3. asserts **global invariants**: every accepted request/stream terminates
   or fails typed (refusals carry a retry hint), zero leaked KV blocks,
   journal consistency (every ``migration_export`` / ``rollout_started``
   reaches a terminal record), bounded fake-clock progress (no deadlock),
   loss/state parity vs an uninjected golden run for training, and
   metrics/journal cross-agreement;
4. on violation, delta-debugs the schedule to a minimal repro (greedily
   drop rules while the failure reproduces under the same seed) and emits
   an artifact bundle (spec, seed, scenario, journal tail, flight-recorder
   dump) under ``PADDLE_TPU_ARTIFACTS_DIR``.

The campaign also reports per-site coverage: manifest sites no scenario
ever *evaluated* (their registry counters stayed at zero) are named in the
report — dead injection points become findings, not silent gaps.

Determinism: the same ``(seed, episodes)`` pair produces byte-identical
schedules and identical episode outcomes. Schedule sampling uses
string-seeded :class:`random.Random` streams (stable across processes),
the fault registry draws from its own per-site streams, and every clocked
component takes the episode's fake clock. The same seed draws the same
schedules as the reference's engine.

The scenarios' models and serving stack are the port's: the training
scenario's Linear and the serving scenario's decode backends are built
on the current device (``set_device``), the card unless a caller chose
the host.

CLI: ``python -m paddle_tpu_torch.resilience.campaign`` (a campaign, or
``--spec`` to replay one episode, which is what a repro bundle names).
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import socket
import sys
import tempfile

import numpy as np

from ..framework.errors import EnforceNotMet, PreconditionNotMetError
from . import faults, injection_sites
from .faults import FaultInjected
from .recorder import artifacts_dir, get_recorder

__all__ = ["known_sites", "Schedule", "ScheduleSampler", "Scenario",
           "TrainingScenario", "ServingScenario", "CampaignEngine",
           "run_campaign", "INVARIANTS"]

# invariant names, in the order they are checked
INVARIANTS = ("typed-termination", "kv-leak", "journal-consistency",
              "bounded-progress", "training-parity",
              "metrics-journal-agreement")

def _site_manifest_module():
    """The manifest module (:mod:`.injection_sites`). SITES is re-read on
    every known_sites() call, so a manifest edit propagates to a live
    sampler."""
    return injection_sites


def known_sites():
    """The full injection-site manifest (tuple of site-name strings)."""
    return tuple(_site_manifest_module().known_sites())


# -- schedules ----------------------------------------------------------------

class Schedule:
    """An immutable multi-site fault schedule: a tuple of (site, rule)
    pairs in the grammar of resilience/faults.py."""

    def __init__(self, rules):
        self.rules = tuple((str(s), str(r)) for s, r in rules)

    def spec(self):
        return ",".join(f"{s}:{r}" for s, r in self.rules)

    def without(self, i):
        return Schedule(self.rules[:i] + self.rules[i + 1:])

    def __len__(self):
        return len(self.rules)

    def __eq__(self, other):
        return isinstance(other, Schedule) and self.rules == other.rules

    def __hash__(self):
        return hash(self.rules)

    def __repr__(self):
        return f"Schedule({self.spec()!r})"


class ScheduleSampler:
    """Samples schedules over the injection-site manifest.

    ``sites=None`` (the default) reads :func:`known_sites` at every sample,
    so the manifest in :mod:`.injection_sites` is the single source of
    truth and edits propagate without re-constructing the sampler."""

    def __init__(self, sites=None, max_rules=4):
        self._sites = tuple(sites) if sites is not None else None
        self.max_rules = int(max_rules)
        if self.max_rules < 1:
            raise PreconditionNotMetError("max_rules must be >= 1")

    def sites(self):
        return self._sites if self._sites is not None else known_sites()

    def sample(self, rng):
        """One schedule from a seeded random.Random. Rates stay modest
        (<= 0.2) and windows short, mirroring the hand-tuned per-subsystem
        soaks: the goal is many overlapping partial outages, not a blackout
        nothing could be expected to survive."""
        pool = sorted(self.sites())
        if not pool:
            raise PreconditionNotMetError("injection-site manifest is empty")
        n = rng.randint(1, min(self.max_rules, len(pool)))
        rules = []
        for site in rng.sample(pool, n):
            kind = rng.random()
            if kind < 0.45:
                raw = f"{round(rng.uniform(0.02, 0.2), 3)}"
            elif kind < 0.70:
                raw = f"#{rng.randint(1, 6)}"
            elif kind < 0.88:
                lo = rng.randint(1, 5)
                raw = f"#{lo}-{lo + rng.randint(1, 3)}"
            else:
                raw = f"#{rng.randint(4, 12)}+"
            rules.append((site, raw))
        return Schedule(rules)


# -- episode plumbing ---------------------------------------------------------

class FakeClock:
    """The campaign's shared fake clock: __call__ reads, advance() moves.
    Passing ``advance`` as the injected sleep makes every wait a pure
    clock jump — zero real sleeps anywhere in an episode."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _typed_exceptions():
    """The closed set of exception families an episode may terminate work
    with. Anything else escaping a scenario is a typed-termination
    violation. RolloutError and FaultInjected subclass RuntimeError for
    compatibility, so they are listed explicitly rather than by base."""
    from ..serving.rollout import RolloutError
    from .snapshot import CheckpointCommitError
    from .watchdog import DistributedError
    return (EnforceNotMet, DistributedError, FaultInjected, RolloutError,
            CheckpointCommitError, ConnectionError, TimeoutError, OSError)


def _exercise(fn, typed_log, label):
    """Run one ancillary coverage op; injected (typed) faults are logged
    and swallowed — ancillary ops must never abort an episode. Quarantined
    is SystemExit-based (a real rank would exit 117) and counts as typed
    here: the campaign simulates every rank in-process. ExecuteError is
    accepted only here, not in ``_typed_exceptions``: these coverage ops
    call raw store/fs primitives without the ``retry_call`` wrapper that
    production paths use to convert transient ExecuteError into a typed
    DistributedError — a raw ExecuteError escaping the *main* loop is
    still a typed-termination violation (a missing retry wrapper)."""
    from ..distributed.fleet.fs import ExecuteError
    from .health import Quarantined
    try:
        fn()
    except _typed_exceptions() + (ExecuteError,) as e:
        typed_log.append(f"{label}:{type(e).__name__}")
    except Quarantined:
        typed_log.append(f"{label}:Quarantined")


class Scenario:
    """Base: a scenario builds a fresh component stack per episode, calls
    ``arm()`` once setup is done, runs chaos, disarms (capturing
    ``fault_stats``), drains, and returns an info dict the engine checks
    invariants over."""

    name = "scenario"

    def run(self, workdir, arm):
        raise PreconditionNotMetError(
            f"scenario {self.name!r} does not implement run()")

    @staticmethod
    def _disarm(info):
        """Capture the registry's evaluation counters, then disarm so the
        drain phase runs fault-free."""
        info["fault_stats"] = faults.stats()
        faults.reset()


class TrainingScenario(Scenario):
    """Two-replica deterministic SGD under consensus + checkpoints +
    recovery. Completed episodes must reach bitwise state parity with the
    uninjected golden run: faults may rewind training to the last
    committed checkpoint, never change what it computes."""

    name = "training"

    def __init__(self, steps=8, ckpt_every=3, consensus_every=2,
                 model_seed=1234):
        self.steps = int(steps)
        self.ckpt_every = int(ckpt_every)
        self.consensus_every = int(consensus_every)
        self.model_seed = int(model_seed)

    # deterministic model/step helpers (mirrors the recovery test-suite's
    # replay discipline: data depends only on the step index)
    def _make_model(self):
        import paddle_tpu_torch as paddle
        import paddle_tpu_torch.nn as nn
        paddle.seed(self.model_seed)
        model = nn.Linear(4, 4)
        opt = paddle.optimizer.SGD(learning_rate=0.1,
                                   parameters=model.parameters())
        return model, opt

    @staticmethod
    def _sgd_step(model, opt, step):
        import paddle_tpu_torch as paddle
        import paddle_tpu_torch.nn.functional as F
        rng = np.random.RandomState(1000 + int(step))
        device = model.weight.device
        x = paddle.to_tensor(rng.randn(8, 4).astype(np.float32),
                             place=device)
        y = paddle.to_tensor(rng.randn(8, 4).astype(np.float32),
                             place=device)
        loss = F.mse_loss(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return float(loss.detach())

    def _ancillary(self, clock, store, mgrs, typed_log, workdir):
        """Touch the manifest sites the training loop proper doesn't:
        preflight KAT, every collective (world size 1 evaluates the site
        then short-circuits), the wire framing, LocalFS ops, the metrics
        exporter's atomic write, and store housekeeping."""
        import paddle_tpu_torch as paddle
        from ..distributed import collective, p2p, wire
        from ..distributed.fleet.fs import LocalFS
        from ..distributed.launch_utils import find_free_ports
        from ..profiler.metrics import _atomic_write
        from .health import preflight_kat

        _exercise(lambda: preflight_kat(seed=0, size=8), typed_log,
                  "integrity.preflight")
        t = paddle.to_tensor(np.ones(4, np.float32))
        _exercise(lambda: collective.all_reduce(t), typed_log, "all_reduce")
        _exercise(lambda: collective.all_gather([], t), typed_log,
                  "all_gather")
        _exercise(lambda: collective.broadcast(t, 0), typed_log, "broadcast")
        _exercise(lambda: collective.scatter(t, [t], 0), typed_log,
                  "scatter")
        _exercise(lambda: collective.reduce_scatter(t, [t]), typed_log,
                  "reduce_scatter")
        _exercise(lambda: collective.alltoall([t], [t]), typed_log,
                  "alltoall")
        _exercise(lambda: collective.send(t, 0), typed_log, "send")
        _exercise(lambda: collective.recv(t, 0), typed_log, "recv")
        _exercise(lambda: collective.barrier(), typed_log, "barrier")
        _exercise(lambda: collective.reduce(t, 0), typed_log, "reduce")

        def _wire_roundtrip():
            a, b = socket.socketpair()
            try:
                a.settimeout(1.0)
                b.settimeout(1.0)
                wire.send_frame(a, {"ping": 1}, timeout=1.0)
                wire.recv_frame(b, timeout=1.0)
            finally:
                a.close()
                b.close()
        _exercise(_wire_roundtrip, typed_log, "wire")

        # single-process p2p: world size 1, loopback channel on a fresh
        # port — send-to-self, a matching recv, and a one-rank barrier
        # evaluate the p2p.* sites without a peer process. An inbound
        # socket from an earlier episode's channel can still hold the port
        # find_free_ports hands back (channel close() leaves reader-side
        # sockets to their threads), so the bind is retried on a new port —
        # EADDRINUSE here is harness port recycling, not an injected fault.
        # The bind happens in p2p._channel() (no fault site), so retrying
        # it never re-evaluates p2p.send — the fault stream and coverage
        # counts stay identical whether or not a port had to be recycled.
        def _p2p_open():
            import errno
            for attempt in range(5):
                os.environ["PADDLE_TPU_P2P_BASE_PORT"] = str(
                    find_free_ports(1)[0])
                try:
                    p2p._channel()
                    return
                except OSError as e:
                    if (getattr(e, "errno", None) == errno.EADDRINUSE
                            and attempt < 4):
                        p2p.shutdown()
                        continue
                    raise
        _exercise(_p2p_open, typed_log, "p2p.open")
        _exercise(lambda: p2p.send_obj(np.ones(2, np.float32), 0),
                  typed_log, "p2p.send")
        _exercise(lambda: p2p.recv_obj(0, timeout=0.5), typed_log,
                  "p2p.recv")
        _exercise(lambda: p2p.group_barrier([0]), typed_log, "p2p.barrier")
        _exercise(p2p.shutdown, typed_log, "p2p.shutdown")

        def _fs_ops():
            fs = LocalFS()
            src = os.path.join(workdir, "blob.src")
            with open(src, "w") as f:
                f.write("x")
            fs.upload(src, os.path.join(workdir, "blob.up"))
            fs.download(os.path.join(workdir, "blob.up"),
                        os.path.join(workdir, "blob.down"))
            fs.mv(os.path.join(workdir, "blob.down"),
                  os.path.join(workdir, "blob.moved"))
        _exercise(_fs_ops, typed_log, "fs")
        _exercise(lambda: _atomic_write(
            os.path.join(workdir, "metrics.json"), "{}"), typed_log,
            "fs.write")
        _exercise(store.gc_tmp, typed_log, "store.gc")
        for m in mgrs:
            _exercise(m.heartbeat, typed_log, "store.heartbeat")

    def _moe(self, journal, typed_log, workdir):
        """Expert-parallel episode segment: a tiny ExpertParallelEngine
        runs fenced dispatch/combine steps, commits an expert-sharded
        checkpoint, then loses a rank and resizes — evaluating
        moe.dispatch / moe.combine / moe.resize while the schedule is
        armed. Returns the engine so the post-disarm drain can replay any
        resize the chaos killed mid-flight (the journal-consistency
        invariant requires every moe_resize_started to reach a terminal
        record)."""
        from ..distributed.fleet.expert_parallel import ExpertParallelEngine
        from .snapshot import AsyncCheckpointer

        ck = AsyncCheckpointer(os.path.join(workdir, "moe_ckpt"),
                               background=False, journal=journal)
        eng = ExpertParallelEngine(4, 4, (0, 1), top_k=2, seed=7,
                                   checkpointer=ck, journal=journal)
        rng = np.random.RandomState(77)
        x = rng.randn(12, 4).astype(np.float64)
        t = rng.randn(12, 4).astype(np.float64)
        _exercise(lambda: eng.step(x, t), typed_log, "moe.step")
        _exercise(lambda: eng.save(step=1) and None, typed_log, "moe.save")
        _exercise(lambda: (eng.drop_rank(1), eng.resize((0,))) and None,
                  typed_log, "moe.resize")
        _exercise(lambda: eng.step(x, t), typed_log, "moe.step")
        return eng, ck

    def run(self, workdir, arm):
        from ..distributed.fleet.elastic import ElasticManager, FileStore
        from .health import Quarantined
        from .integrity import ConsensusChecker, StepReplayBuffer
        from .recovery import (
            RecoveryExhausted, RecoveryJournal, RecoveryManager,
        )
        from .snapshot import AsyncCheckpointer

        typed_exc = _typed_exceptions()
        clock = FakeClock()
        sleep = clock.advance
        job = "campaign-train"
        store = FileStore(os.path.join(workdir, "store"), ttl=1e6)
        ranks = (0, 1)
        mgrs = {r: ElasticManager(store, job, np_min=1, np_max=len(ranks),
                                  rank=r, endpoint=f"h{r}:1",
                                  heartbeat_interval=0.01, clock=clock,
                                  sleep=sleep)
                for r in ranks}
        for m in mgrs.values():
            m.register()
        models, opts = {}, {}
        for r in ranks:
            models[r], opts[r] = self._make_model()
        journal = RecoveryJournal(job_id=job,
                                  dir=os.path.join(workdir, "journal"),
                                  clock=clock)
        ckpt = AsyncCheckpointer(os.path.join(workdir, "ckpt"), keep=2,
                                 background=False, journal=journal)

        def _save(step):
            ckpt.save({"model.pdparams": (models[0].state_dict(), "model"),
                       "opt.pdopt": (opts[0].state_dict(), "opt")},
                      step=step, meta={"step": int(step)}, blocking=True)

        scratch_restore = {"on": False}

        def _restore(gen):
            ckpt.flush()
            if scratch_restore["on"]:
                # coverage-only restart at episode end: restore into
                # throwaway replicas so the parity digest (already the real
                # models' final state) is not rewound
                sm, so = self._make_model()
                ckpt.restore(sm, so)
                return None
            meta = None
            for r in sorted(active):
                meta, _ = ckpt.restore(models[r], opts[r])
            return meta

        _save(0)  # pre-chaos baseline: restore always has a manifest
        mgr = RecoveryManager(mgrs[0], restore=_restore, max_restarts=4,
                              rendezvous_timeout=0.3, backoff_base=0.0,
                              restart_reset_steps=0, clock=clock,
                              sleep=sleep, journal=journal)
        replay = {r: StepReplayBuffer(size=4, rank=r) for r in ranks}
        checkers = {r: ConsensusChecker(mgrs[r], [models[r], opts[r]],
                                        interval=self.consensus_every,
                                        timeout=0.2, clock=clock,
                                        sleep=sleep,
                                        recorder=get_recorder(),
                                        replay=replay[r])
                    for r in ranks}

        info = {"scenario": self.name, "typed": [], "untyped": [],
                "requests": [], "journal": [], "deadlock": False}
        typed_log = info["typed"]
        active = set(ranks)
        arm()
        self._ancillary(clock, store, mgrs.values(), typed_log, workdir)
        moe_eng, moe_ck = self._moe(journal, typed_log, workdir)

        step, losses = 0, []
        restart_failures = 0
        outcome = None
        budget = 40 * self.steps
        while step < self.steps:
            budget -= 1
            if budget <= 0:
                info["deadlock"] = True
                outcome = "progress-budget-exhausted"
                break
            try:
                loss = None
                for r in sorted(active):
                    l = self._sgd_step(models[r], opts[r], step)
                    if r == min(active):
                        loss = l
                for r in sorted(active):
                    checkers[r].after_step(
                        step, inputs=[np.float32(step)])
                if (step + 1) % self.ckpt_every == 0 and 0 in active:
                    _save(step + 1)
                del losses[step:]
                losses.append(loss)
                step += 1
                clock.advance(0.01)
            except Quarantined:
                outcome = "self-quarantined"
                break
            except typed_exc as e:
                typed_log.append(f"step{step}:{type(e).__name__}")
                culprits = {int(c) for c in
                            (getattr(e, "culprits", ()) or ())}
                active -= culprits
                if 0 not in active:
                    outcome = "leader-quarantined"
                    break
                try:
                    meta = mgr.restart(cause=e)
                    step = int((meta or {}).get("step", 0))
                except RecoveryExhausted:
                    outcome = "recovery-exhausted"
                    break
                except Quarantined:
                    outcome = "self-quarantined"
                    break
                except typed_exc as e2:
                    typed_log.append(f"restart:{type(e2).__name__}")
                    restart_failures += 1
                    if restart_failures > 6:
                        outcome = "recovery-failed"
                        break
        else:
            outcome = "completed"
        # integrity.replay coverage: re-run the newest recorded step
        # through the CPU replay path (a digest-returning step_fn keeps it
        # cheap; the call still evaluates the injection site)
        if replay[0].steps():
            _exercise(lambda: replay[0].replay(
                replay[0].steps()[-1],
                step_fn=lambda entry: entry["input_checksum"]),
                typed_log, "integrity.replay")
        # controlled restart, still armed: evaluates recovery.restart +
        # recovery.rendezvous every episode without depending on a fault
        # having fired (scratch restore keeps the final state intact)
        scratch_restore["on"] = True
        _exercise(lambda: mgr.restart(cause=None), typed_log,
                  "controlled-restart")

        self._disarm(info)
        # fault-free drain of the MoE segment: a resize the chaos killed
        # mid-flight is replayed from its moe_resize_started journal
        # record (the restart contract) so every resize reaches a
        # terminal record before the journal-consistency check
        _exercise(lambda: moe_eng.replay_pending_resizes() and None,
                  typed_log, "moe.replay")
        moe_ck.close()
        from .integrity import checksum_state
        info["outcome"] = outcome
        info["final_digest"] = checksum_state([models[0], opts[0]]) \
            if outcome == "completed" else None
        info["losses"] = losses if outcome == "completed" else None
        info["journal"] = list(journal.entries())
        info["restarts"] = mgr.restarts
        ckpt.close()
        return info


class ServingScenario(Scenario):
    """One InferenceServer in fake-clock pump mode with disaggregated
    prefill/decode attached, plus a mid-traffic checkpoint commit the
    rollout controller picks up — inference requests, generation streams,
    KV handoffs, canary/roll, and autoscaler resizes all overlap while the
    schedule fires."""

    name = "serving"

    def __init__(self, rounds=36, gen_tokens=3):
        self.rounds = int(rounds)
        self.gen_tokens = int(gen_tokens)

    def run(self, workdir, arm):
        from .. import serving
        from ..serving.batcher import ServerOverloaded
        from ..serving.decode.kv_cache import KVCacheExhausted
        from ..serving.disagg import DisaggConfig
        from .recovery import RecoveryJournal
        from .snapshot import AsyncCheckpointer, load_manifest_blob

        typed_exc = _typed_exceptions()
        clock = FakeClock()
        launch_scale = 2.0

        class _Pred:
            # output = input * scale: the reply proves which weights served
            def __init__(self, scale):
                self.scale = scale

            def run(self, arrays):
                clock.advance(0.002)
                return [np.asarray(arrays[0]) * self.scale]

        def loader(path, idx):
            return _Pred(load_manifest_blob(path)["model"]["scale"])

        scfg = serving.ServingConfig(max_batch_size=4, replicas=2,
                                     max_queue=16, default_deadline=None)
        srv = serving.InferenceServer(lambda i: _Pred(launch_scale), scfg,
                                      clock=clock)
        root = os.path.join(workdir, "ckpt")
        ckpt = AsyncCheckpointer(root, keep=3, background=False)
        journal = RecoveryJournal(job_id="campaign-serve",
                                  dir=os.path.join(workdir, "journal"),
                                  clock=clock)
        rc = srv.attach_rollout(
            root, loader, goldens=[[np.ones((1, 4), np.float32)]],
            config=serving.RolloutConfig(poll_interval=0.05,
                                         golden_max_drift=10.0,
                                         drain_timeout=5.0),
            journal=journal)
        ctl = srv.attach_disagg(
            config=DisaggConfig(prefill_replicas=1,
                                        decode_replicas=2,
                                        prefill_token_s=0.001,
                                        max_new_tokens=self.gen_tokens,
                                        max_running=4, retry_after=0.05),
            journal=journal)
        asc = srv.attach_autoscaler()
        # colocated decode alongside disagg: drives decode.join/prefill/
        # step deterministically (disagg streams adopt prefilled KV, so the
        # decode-side prefill path otherwise only runs on fallbacks), and a
        # deliberately unmeetable deadline exercises decode.evict
        from ..serving.decode.compiled_decode import CompiledDecodeBackend
        from ..serving.decode.engine import DecodeConfig
        from ..serving.decode.specdecode import MirrorDraft
        # prefix sharing + speculation run hot here: the repeated [5, 6]
        # prompt exercises prefix.lookup/share (warm joins) every round,
        # the draft drives spec.draft/verify every tick, and the
        # corrupt_every draft forces the rejection/truncate path too
        deng = srv.attach_decode(
            CompiledDecodeBackend(max_running=4),
            DecodeConfig(max_running=4, max_new_tokens=self.gen_tokens,
                         prefix_sharing=True, spec_k=2,
                         draft=MirrorDraft(corrupt_every=5)))

        info = {"scenario": self.name, "typed": [], "untyped": [],
                "requests": [], "journal": [], "deadlock": False}
        typed_log = info["typed"]
        arm()

        accepted, handoffs = [], []
        hintless = []

        def _check_hint(e):
            # the hint contract covers the product's genuine refusal path;
            # maybe_inject builds exc_type(msg) directly, bypassing the
            # admission controller that attaches retry_after, so the
            # injector's synthetic refusal is exempt
            if (getattr(e, "retry_after", None) is None
                    and "injected fault at '" not in str(e)):
                hintless.append(str(e))

        x = np.ones((1, 4), np.float32)
        for i in range(self.rounds):
            try:
                accepted.append(srv.submit([x]))
            except (ServerOverloaded, KVCacheExhausted) as e:
                typed_log.append(f"submit:{type(e).__name__}")
                _check_hint(e)
            except typed_exc as e:
                typed_log.append(f"submit:{type(e).__name__}")
            if i % 2 == 0:
                try:
                    handoffs.append(ctl.submit(
                        [1, 2, 3], max_new_tokens=self.gen_tokens,
                        timeout=30.0))
                except (ServerOverloaded, KVCacheExhausted) as e:
                    typed_log.append(f"generate:{type(e).__name__}")
                    _check_hint(e)
                except typed_exc as e:
                    typed_log.append(f"generate:{type(e).__name__}")
            if i % 5 == 1:
                try:
                    # one stream gets a deadline it cannot meet: its
                    # eviction is the decode.evict coverage
                    timeout = 0.005 if i == 1 else 30.0
                    handoffs.append(srv.submit_generate(
                        [5, 6], max_new_tokens=self.gen_tokens,
                        timeout=timeout))
                except (ServerOverloaded, KVCacheExhausted) as e:
                    typed_log.append(f"decode:{type(e).__name__}")
                    _check_hint(e)
                except typed_exc as e:
                    typed_log.append(f"decode:{type(e).__name__}")
            if i == self.rounds - 3:
                # a drain right after an admit guarantees a live stream is
                # evicted while the schedule is armed: decode.evict coverage
                _exercise(lambda: srv.submit_generate(
                    [8], max_new_tokens=self.gen_tokens, timeout=30.0)
                    and None, typed_log, "evict-seed")
                _exercise(deng.drain, typed_log, "evict-drain")
            if i == self.rounds // 2:
                _exercise(lambda: ckpt.save(
                    {"model.pdparams": ({"scale": 3.0}, "model")},
                    blocking=True), typed_log, "commit")
            if i == self.rounds // 3:
                _exercise(asc.scale_up, typed_log, "scale_up")
            if i == 2 * self.rounds // 3:
                _exercise(asc.scale_down, typed_log, "scale_down")
            srv.pump(2)
            clock.advance(0.01)

        self._disarm(info)
        # fault-free drain: every accepted request and stream must reach a
        # terminal state within a bounded number of pump rounds
        drained = False
        for _ in range(4000):
            srv.pump(4)
            clock.advance(0.01)
            if all(r.done() for r in accepted) \
                    and all(h.done for h in handoffs) \
                    and not rc.active() \
                    and not ctl.pending() and not ctl.running():
                drained = True
                break
        if not drained:
            info["deadlock"] = True
        typed_names = tuple(t.__name__ for t in typed_exc)
        for r in accepted:
            err = r.error
            info["requests"].append({
                "id": r.id, "kind": "infer", "done": bool(r.done()),
                "error": type(err).__name__ if err is not None else None,
                "typed": err is None
                or isinstance(err, typed_exc)
                or type(err).__name__ in typed_names})
        for h in handoffs:
            err = h.error
            info["requests"].append({
                "id": h.id, "kind": "generate", "done": bool(h.done),
                "error": type(err).__name__ if err is not None else None,
                "typed": err is None
                or isinstance(err, typed_exc)
                or type(err).__name__ in typed_names})
        info["refusals_without_hint"] = len(hintless)
        # disagg's accounting covers its own prefill/decode pools; the
        # colocated engine's pool must be audited separately or a leak in
        # the decode-side eviction path would be invisible here. Blocks the
        # prefix cache retains after streams finish are warm state, not a
        # leak — kv_leaked() subtracts them (and drain clears them).
        colocated_leak = deng.kv_leaked() if deng.running() == 0 else 0
        info["leaked_blocks"] = ctl.leaked_blocks() + colocated_leak
        info["journal"] = list(journal.entries())
        info["stats"] = {k: v for k, v in ctl.stats().items()
                         if isinstance(v, (int, float, str))}
        info["outcome"] = "completed" if drained else "stalled"
        srv.stop()
        return info


# -- invariants ---------------------------------------------------------------

_MIGRATION_TERMINAL = {"migration_release", "migration_aborted",
                       "migration_refused"}
_ROLLOUT_TERMINAL = {"rollout_completed", "rollout_rolled_back"}
_MOE_RESIZE_TERMINAL = {"moe_resize_completed", "moe_resize_aborted"}


def check_invariants(info, golden=None):
    """Evaluate the global invariants over one episode's info dict.
    Returns a list of violation dicts ({"invariant", "detail"})."""
    v = []

    def _fail(name, detail):
        v.append({"invariant": name, "detail": detail})

    for item in info.get("untyped", ()):
        _fail("typed-termination", f"untyped error escaped: {item}")
    for r in info.get("requests", ()):
        if not r["done"]:
            _fail("typed-termination",
                  f"{r['kind']} {r['id']} never terminated")
        elif r.get("error") and not r.get("typed"):
            _fail("typed-termination",
                  f"{r['kind']} {r['id']} failed untyped: {r['error']}")
    if info.get("refusals_without_hint"):
        _fail("typed-termination",
              f"{info['refusals_without_hint']} refusal(s) without a "
              "retry_after hint")

    if info.get("leaked_blocks"):
        _fail("kv-leak", f"{info['leaked_blocks']} KV block(s) leaked "
              "after drain")

    journal = info.get("journal", ())
    exports, terminal = set(), set()
    rollout_started = rollout_terminal = 0
    moe_started, moe_terminal = set(), set()
    for e in journal:
        ev = e.get("event", "")
        if ev == "migration_export":
            exports.add(e.get("stream"))
        elif ev in _MIGRATION_TERMINAL:
            terminal.add(e.get("stream"))
        elif ev in ("rollout_started", "rollout_resumed"):
            rollout_started += 1
        elif ev in _ROLLOUT_TERMINAL:
            rollout_terminal += 1
        elif ev == "moe_resize_started":
            moe_started.add(e.get("resize"))
        elif ev in _MOE_RESIZE_TERMINAL:
            moe_terminal.add(e.get("resize"))
    for sid in sorted(exports - terminal, key=str):
        _fail("journal-consistency",
              f"migration_export for stream {sid} has no terminal record")
    if rollout_started > rollout_terminal:
        _fail("journal-consistency",
              f"{rollout_started - rollout_terminal} rollout_started "
              "record(s) never reached a terminal record")
    for rid in sorted(moe_started - moe_terminal, key=str):
        _fail("journal-consistency",
              f"moe_resize_started {rid} never reached a terminal record "
              "(completed/aborted) — a mid-resize death must be replayed "
              "on restart")

    if info.get("deadlock"):
        _fail("bounded-progress",
              "episode exhausted its fake-clock progress budget "
              f"(outcome={info.get('outcome')})")

    if golden is not None and info.get("outcome") == "completed":
        if info.get("final_digest") != golden.get("final_digest"):
            _fail("training-parity",
                  "final state digest diverged from the uninjected "
                  "golden run")
        if info.get("losses") != golden.get("losses"):
            _fail("training-parity",
                  "loss trajectory diverged from the uninjected golden run")

    stats = info.get("stats")
    if stats is not None:
        aborted = sum(1 for e in journal
                      if e.get("event") == "migration_aborted")
        if int(stats.get("migration_aborts", 0)) != aborted:
            _fail("metrics-journal-agreement",
                  f"controller counts {stats.get('migration_aborts')} "
                  f"migration aborts but the journal records {aborted}")
    return v


# -- the engine ---------------------------------------------------------------

def _reset_globals():
    """Per-episode process-global hygiene, mirroring the chaos test
    fixtures: a campaign must be replayable in-process."""
    from ..distributed import p2p
    from . import recorder as recorder_mod
    from . import recovery, watchdog
    faults.reset()
    recorder_mod.reset()
    watchdog.reset()
    recovery.reset_generation()
    recovery.reset_journal()
    p2p.shutdown()
    # RecoveryManager.restart publishes the rendezvous survivors to
    # PADDLE_TRAINER_ENDPOINTS; left in place it would pin the NEXT
    # episode's p2p channel to a fixed derived port (endpoints() prefers
    # it over PADDLE_TPU_P2P_BASE_PORT) and collide with lingering
    # sockets from this one
    for var in ("PADDLE_TRAINER_ENDPOINTS", "PADDLE_TPU_P2P_ENDPOINTS",
                "PADDLE_TPU_P2P_BASE_PORT"):
        os.environ.pop(var, None)


class CampaignEngine:
    """Runs ``episodes`` alternating scenarios, checks invariants, shrinks
    failing schedules, and accumulates per-site coverage."""

    def __init__(self, episodes=25, seed=0, scenarios=None, sites=None,
                 max_rules=4, shrink=True, max_shrink_runs=24,
                 keep_workdirs=False):
        self.episodes = int(episodes)
        self.seed = int(seed)
        self.scenarios = list(scenarios) if scenarios is not None else \
            [TrainingScenario(), ServingScenario()]
        if not self.scenarios:
            raise PreconditionNotMetError("need at least one scenario")
        self.sampler = ScheduleSampler(sites=sites, max_rules=max_rules)
        self.shrink = bool(shrink)
        self.max_shrink_runs = int(max_shrink_runs)
        self.keep_workdirs = bool(keep_workdirs)
        self._golden = {}

    # -- single-episode machinery -----------------------------------------
    def episode_seed(self, index):
        return self.seed * 100003 + int(index) + 1

    def schedule_for(self, index):
        rng = random.Random(f"campaign:{self.seed}:{index}:schedule")
        return self.sampler.sample(rng)

    def golden_for(self, scenario):
        """The uninjected reference run, cached per scenario name (the
        model/init seeds are scenario-fixed, so one golden serves every
        episode of that scenario)."""
        if scenario.name not in self._golden:
            self._golden[scenario.name] = self._run_scenario(
                scenario, schedule=None, fault_seed=0)
        return self._golden[scenario.name]

    def _run_scenario(self, scenario, schedule, fault_seed):
        _reset_globals()
        workdir = tempfile.mkdtemp(prefix=f"campaign-{scenario.name}-")
        if schedule is None or not len(schedule):
            arm = lambda: None  # noqa: E731 - golden runs stay unarmed
        else:
            arm = lambda: faults.configure(  # noqa: E731
                schedule.spec(), seed=fault_seed)
        from .health import Quarantined
        try:
            info = scenario.run(workdir, arm)
        except (_typed_exceptions() + (Quarantined,)) as e:
            info = {"scenario": scenario.name, "outcome": "aborted-typed",
                    "typed": [type(e).__name__], "untyped": [],
                    "fault_stats": faults.stats(), "deadlock": False}
        except Exception as e:  # the typed-termination invariant's catch
            info = {"scenario": scenario.name, "outcome": "escaped",
                    "typed": [],
                    "untyped": [f"{type(e).__name__}: {e}"],
                    "fault_stats": faults.stats(), "deadlock": False}
        finally:
            faults.reset()
            if not self.keep_workdirs:
                shutil.rmtree(workdir, ignore_errors=True)
        info.setdefault("fault_stats", {})
        return info

    def run_episode(self, scenario, schedule, fault_seed):
        golden = self.golden_for(scenario) \
            if isinstance(scenario, TrainingScenario) else None
        info = self._run_scenario(scenario, schedule, fault_seed)
        violations = check_invariants(info, golden=golden)
        return info, violations

    # -- shrinking --------------------------------------------------------
    def shrink_schedule(self, scenario, schedule, fault_seed, violations):
        """Greedy delta-debugging: repeatedly drop single rules while the
        failure still reproduces under the same seed. Returns (minimal
        schedule, reruns). Reproduction means any violation of an
        invariant the original episode violated."""
        target = {v["invariant"] for v in violations}
        current = schedule
        runs = 0
        progress = True
        while progress and runs < self.max_shrink_runs:
            progress = False
            for i in range(len(current)):
                candidate = current.without(i)
                runs += 1
                _, cand_v = self.run_episode(scenario, candidate,
                                             fault_seed)
                if {v["invariant"] for v in cand_v} & target:
                    current = candidate
                    progress = True
                    break
                if runs >= self.max_shrink_runs:
                    break
        return current, runs

    def _emit_bundle(self, scenario, index, schedule, shrunk, fault_seed,
                     info, violations, shrink_runs):
        base = os.path.join(artifacts_dir(),
                            f"campaign-{scenario.name}-ep{index}")
        os.makedirs(base, exist_ok=True)
        repro = {
            "scenario": scenario.name,
            "episode": index,
            "campaign_seed": self.seed,
            "fault_seed": fault_seed,
            "spec": schedule.spec(),
            "minimal_spec": shrunk.spec() if shrunk is not None else None,
            "shrink_runs": shrink_runs,
            "violations": violations,
            "outcome": info.get("outcome"),
            "replay": ("python -m paddle_tpu_torch.resilience.campaign "
                       f"--scenario {scenario.name} "
                       f"--spec '{(shrunk or schedule).spec()}' "
                       f"--fault-seed {fault_seed}"),
        }
        with open(os.path.join(base, "repro.json"), "w") as f:
            json.dump(repro, f, indent=1, sort_keys=True)
        with open(os.path.join(base, "journal_tail.jsonl"), "w") as f:
            for e in (info.get("journal") or [])[-50:]:
                f.write(json.dumps(e, default=str) + "\n")
        try:
            get_recorder().dump(
                reason=f"campaign violation ep{index}", dir=base)
        except OSError:
            pass  # the bundle is best-effort beyond repro.json
        return base

    # -- the campaign loop ------------------------------------------------
    def run(self):
        from ..profiler.metrics import get_registry
        manifest = self.sampler.sites()
        episodes = []
        coverage = {s: 0 for s in manifest}
        total_violations = 0
        bundles = []
        for i in range(self.episodes):
            scenario = self.scenarios[i % len(self.scenarios)]
            schedule = self.schedule_for(i)
            fault_seed = self.episode_seed(i)
            info, violations = self.run_episode(scenario, schedule,
                                                fault_seed)
            for site, st in info.get("fault_stats", {}).items():
                if site in coverage:
                    coverage[site] += int(st.get("evaluations", 0))
            shrunk, shrink_runs = None, 0
            if violations and self.shrink and len(schedule) > 1:
                shrunk, shrink_runs = self.shrink_schedule(
                    scenario, schedule, fault_seed, violations)
            if violations:
                bundles.append(self._emit_bundle(
                    scenario, i, schedule, shrunk, fault_seed, info,
                    violations, shrink_runs))
            total_violations += len(violations)
            get_registry().inc_counter("campaign.episodes_total")
            if violations:
                get_registry().inc_counter("campaign.violations_total",
                                           len(violations))
            episodes.append({
                "episode": i,
                "scenario": scenario.name,
                "spec": schedule.spec(),
                "fault_seed": fault_seed,
                "outcome": info.get("outcome"),
                "typed_faults": len(info.get("typed", ())),
                "violations": violations,
                "minimal_spec": shrunk.spec() if shrunk is not None
                else None,
            })
        _reset_globals()
        covered = sorted(s for s, n in coverage.items() if n > 0)
        uncovered = sorted(s for s, n in coverage.items() if n == 0)
        get_registry().set_gauge("campaign.sites_covered_count",
                                 len(covered))
        return {
            "campaign_seed": self.seed,
            "episodes_run": self.episodes,
            "episodes": episodes,
            "violations_total": total_violations,
            "coverage": {
                "manifest_sites": len(manifest),
                "covered": len(covered),
                "ratio": (len(covered) / len(manifest)) if manifest
                else 0.0,
                "uncovered_sites": uncovered,
            },
            "artifact_bundles": bundles,
        }


def run_campaign(episodes=25, seed=0, **kw):
    """Convenience wrapper: build an engine and run it."""
    return CampaignEngine(episodes=episodes, seed=seed, **kw).run()


def _parse_spec(spec):
    rules = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, _, raw = entry.partition(":")
        if not raw:
            raise SystemExit(f"bad spec entry {entry!r}: want 'site:rule'")
        rules.append((site.strip(), raw.strip()))
    return rules


def main(argv=None):
    """The campaign's command line: a campaign of ``--episodes`` from
    ``--seed``, or with ``--spec`` one exact (scenario, spec, fault seed)
    episode replayed, which is what a repro bundle names. Prints the
    report as JSON; exits 1 on an invariant violation."""
    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenario", choices=["training", "serving", "mix"],
                    default="mix")
    ap.add_argument("--spec", default=None)
    ap.add_argument("--fault-seed", type=int, default=1)
    args = ap.parse_args(argv)
    scenarios = {"training": [TrainingScenario()],
                 "serving": [ServingScenario()]}.get(args.scenario)
    if args.spec is not None:
        if scenarios is None:
            raise SystemExit("--spec replay needs --scenario "
                             "training|serving (not mix)")
        engine = CampaignEngine(episodes=1, seed=args.seed,
                                scenarios=scenarios)
        schedule = Schedule(_parse_spec(args.spec))
        info, violations = engine.run_episode(scenarios[0], schedule,
                                              args.fault_seed)
        print(json.dumps({"scenario": scenarios[0].name,
                          "spec": schedule.spec(),
                          "fault_seed": args.fault_seed,
                          "outcome": info.get("outcome"),
                          "typed_faults": len(info.get("typed", ())),
                          "violations": violations},
                         indent=1, sort_keys=True, default=str))
        return 1 if violations else 0
    report = CampaignEngine(episodes=args.episodes, seed=args.seed,
                            scenarios=scenarios).run()
    print(json.dumps(report, indent=1, sort_keys=True, default=str))
    return 1 if report["violations_total"] else 0


if __name__ == "__main__":
    sys.exit(main())
