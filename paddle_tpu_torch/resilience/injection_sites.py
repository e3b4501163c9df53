"""The port's fault-injection manifest.

The port's own copy of the reference's site manifest: the same site names
(``SITES``, which the chaos campaign's sampler draws schedules from through
:func:`known_sites`) and the same entry points (``REQUIRED``), with the
port's paths. Each ``REQUIRED`` entry names a file, a scope ("module" for
its top-level functions, "class:<Name>" for that class's methods) and the
functions in it that must call one of ``HOOK_CALLS``; a name is required
only where the scope defines it. The port imports nothing of the
reference, so it does not read the reference's manifest; its tests hold
the two lists equal.
"""
from __future__ import annotations

__all__ = ["REQUIRED", "SITES", "HOOK_CALLS", "known_sites"]

REQUIRED = [
    ("paddle_tpu_torch/distributed/fleet/fs.py", "class:LocalFS",
     ["upload", "download", "mv"]),
    ("paddle_tpu_torch/distributed/fleet/fs.py", "class:HDFSClient",
     ["upload", "download", "mv"]),
    ("paddle_tpu_torch/distributed/collective.py", "module",
     ["all_reduce", "all_gather", "broadcast", "scatter", "reduce_scatter",
      "alltoall", "send", "recv", "barrier", "reduce"]),
    ("paddle_tpu_torch/distributed/fleet/elastic.py", "class:FileStore",
     ["put", "refresh", "gc_tmp"]),
    ("paddle_tpu_torch/distributed/fleet/elastic.py", "class:ElasticManager",
     ["rendezvous"]),
    ("paddle_tpu_torch/resilience/recovery.py", "class:RecoveryManager",
     ["restart"]),
    ("paddle_tpu_torch/incubate/checkpoint.py", "class:CheckpointSaver",
     ["save_checkpoint", "clean_redundant_epochs"]),
    ("paddle_tpu_torch/distributed/p2p.py", "module",
     ["send_obj", "recv_obj", "group_barrier"]),
    ("paddle_tpu_torch/distributed/wire.py", "module",
     ["send_frame", "recv_frame"]),
    ("paddle_tpu_torch/serving/batcher.py", "class:BatchQueue", ["put"]),
    ("paddle_tpu_torch/serving/scheduler.py", "class:Scheduler",
     ["dispatch", "_hedge_site"]),
    ("paddle_tpu_torch/serving/server.py", "class:InferenceServer",
     ["_reply"]),
    ("paddle_tpu_torch/serving/autoscaler.py", "class:Autoscaler",
     ["scale_up", "scale_down"]),
    ("paddle_tpu_torch/resilience/health.py", "module", ["preflight_kat"]),
    ("paddle_tpu_torch/resilience/integrity.py", "module",
     ["checksum_state"]),
    ("paddle_tpu_torch/resilience/integrity.py", "class:StepReplayBuffer",
     ["replay"]),
    ("paddle_tpu_torch/resilience/snapshot.py", "class:AsyncCheckpointer",
     ["save", "_commit", "_remove"]),
    ("paddle_tpu_torch/resilience/snapshot.py", "module",
     ["serialize_file"]),
    ("paddle_tpu_torch/serving/rollout.py", "class:ManifestWatcher",
     ["poll"]),
    ("paddle_tpu_torch/serving/rollout.py", "class:RolloutController",
     ["_load", "_swap_one", "_verify_canary"]),
    ("paddle_tpu_torch/serving/decode/engine.py", "class:DecodeEngine",
     ["join", "_prefill", "step", "_evict", "_spec_round"]),
    ("paddle_tpu_torch/serving/decode/prefix.py", "class:PrefixCache",
     ["lookup", "share", "evict", "clear"]),
    ("paddle_tpu_torch/serving/decode/specdecode.py", "class:SpecDecoder",
     ["propose"]),
    ("paddle_tpu_torch/serving/decode/kv_migrate.py", "class:KVMigrator",
     ["export", "transfer", "adopt"]),
    ("paddle_tpu_torch/serving/disagg.py", "class:DisaggController",
     ["route"]),
    ("paddle_tpu_torch/distributed/fleet/expert_parallel.py",
     "class:ExpertParallelEngine", ["dispatch", "combine", "resize"]),
    ("paddle_tpu_torch/distributed/reducer.py", "class:Reducer", ["_flush"]),
]

# every injection-site name in the port, grouped as the reference groups
# them; the campaign's sampler draws from this list
SITES = [
    # storage
    "fs.upload", "fs.download", "fs.mv", "fs.write", "fs.remove",
    # collectives
    "collective.all_reduce", "collective.all_gather", "collective.broadcast",
    "collective.scatter", "collective.reduce_scatter", "collective.alltoall",
    "collective.send", "collective.recv", "collective.barrier",
    "collective.reduce",
    # elastic store / transport
    "store.put", "store.heartbeat", "store.gc",
    "p2p.send", "p2p.recv", "p2p.barrier",
    "wire.send_frame", "wire.recv_frame",
    # recovery / integrity
    "recovery.rendezvous", "recovery.restart",
    "integrity.preflight", "integrity.checksum", "integrity.replay",
    "device.bitflip",
    # checkpointing
    "ckpt.snapshot", "ckpt.serialize", "ckpt.commit",
    # serving front door
    "serving.enqueue", "serving.dispatch", "serving.replica_run",
    "serving.reply", "serving.hedge", "serving.scale",
    # rollout
    "rollout.watch", "rollout.load", "rollout.swap", "rollout.verify",
    # continuous-batching decode
    "decode.join", "decode.prefill", "decode.step", "decode.evict",
    # disaggregated serving
    "kv.export", "kv.transfer", "kv.adopt", "disagg.route",
    # prefix sharing + speculative decoding
    "prefix.lookup", "prefix.share", "prefix.evict",
    "spec.draft", "spec.verify",
    # elastic expert parallelism
    "moe.dispatch", "moe.combine", "moe.resize",
    # bucketed async allreduce
    "reducer.flush",
]

# calls that count as a hook: _injected_run is HDFSClient's hook-carrying
# chokepoint, _attempt is Scheduler.dispatch's (the primary and the hedged
# attempt both funnel through it), should_inject the non-raising hook of
# corruption-style faults (device.bitflip)
HOOK_CALLS = {"maybe_inject", "fault_point", "_injected_run", "_attempt",
              "should_inject"}


def known_sites():
    """The full injection-site manifest, read at call time so a ``SITES``
    edit propagates to every consumer (the campaign's sampler)."""
    return tuple(SITES)
