"""Global flags: paddle.set_flags / paddle.get_flags.

Port of paddle_tpu/framework/flags.py, with only the flags the port reads,
at the reference's defaults:

- ``FLAGS_compiled_step`` (default on): ``jit.to_static`` and
  ``jit.compiled_step.CompiledTrainStep`` capture a step as a CUDA graph;
  0 runs every call eagerly, the debug and parity oracle.
- ``FLAGS_compiled_step_max_retraces`` (8): distinct input signatures one
  compiled step (or one decode step cache) may build before the
  retrace-storm guard warns; 0 disables the guard.
- ``FLAGS_max_cached_programs`` (64): programs one ``to_static`` function
  keeps, evicted oldest first.
- The training API (``hapi``): ``FLAGS_check_nan_inf`` (off: on, fit
  guards every step with ``resilience.guard.StepGuard``) and
  ``FLAGS_guard_max_bad_steps`` (3), ``FLAGS_input_prefetch`` (on),
  ``FLAGS_async_checkpoint`` (off; on, ``Model.save``, ``ModelCheckpoint``
  and ``save_hybrid_checkpoint`` commit on the background committer of
  ``resilience.snapshot``), ``FLAGS_ckpt_keep`` (3),
  ``FLAGS_ckpt_flush_timeout`` (60 s: the wait for pending commits at a
  preemption or a recovery's restore), ``FLAGS_steptimer`` (on) and
  ``FLAGS_steptimer_sync_interval`` (16).
- Resilience and observability: ``FLAGS_fault_injection`` and its seed
  (setting either reconfigures ``resilience.faults``), the watchdog's
  ``FLAGS_collective_timeout`` and ``FLAGS_watchdog_interval``, the flight
  recorder's size, ``FLAGS_preflight_checks``, the metrics exporter's
  interval and the request tracer's switches; the retry policy
  (``FLAGS_retry_*``), in-job recovery (``FLAGS_recovery_*``: the restart
  budget, the rendezvous wait, the backoff and the budget's refill),
  ``FLAGS_quarantine_ttl`` and the recovery journal's rotation
  (``FLAGS_journal_max_bytes``); silent-data-corruption defence
  (``FLAGS_integrity_check_interval``, 100 steps between consensus checks,
  0 off; ``FLAGS_integrity_consensus_timeout``, 30 s;
  ``FLAGS_replay_buffer_size``, 8 steps) and straggler detection
  (``FLAGS_straggler_window``, 50 steps; ``FLAGS_straggler_threshold``, 3 x
  the group median; ``FLAGS_straggler_quarantine``, off).
- The kernel tier (``ops/autotune.py``): ``FLAGS_fusion_policy``
  (``auto``, ``always`` or ``never``; default ``auto``: each fused op and
  flash attention run the form that this card's measured table names for
  the call's op, dtype and direction) and ``FLAGS_autotune`` (on: flash
  attention's tiles are searched on the card; off, or on the CPU, a fixed
  tile answers).
- Data parallelism (``distributed/``): ``FLAGS_reducer_bucket_mb`` (25),
  the size cap of one fused gradient bucket of ``DataParallel``'s
  Reducer.
- Serving (``serving/``) and continuous-batching decode
  (``serving/decode/``): ``FLAGS_serving_*`` and ``FLAGS_decode_*``.
  ``FLAGS_decode_quantize`` is accepted, but a set value raises in
  ``DecodeEngine``: weight-only quantization (``slim.ptq``) is not ported.

``FLAGS_donate_state_buffers`` is not ported: it donates a jitted
program's state buffers so XLA may write the new state over them, and a
CUDA graph already updates its state in place. A flag named in the
environment at import sets its initial value, as gflags does. Unknown
flags are stored as given, as the reference stores them.
"""
from __future__ import annotations

import os
from typing import Any

__all__ = ["get_flag", "get_flags", "set_flags"]

_FLAGS: dict[str, Any] = {
    "FLAGS_compiled_step": True,
    "FLAGS_compiled_step_max_retraces": 8,
    "FLAGS_max_cached_programs": 64,
    # the kernel tier (ops/autotune.py): the measured fusion policy
    # (auto|always|never) and the switch of the timed tile search
    "FLAGS_fusion_policy": "auto",
    "FLAGS_autotune": True,
    # size cap (MB) of one fused gradient bucket of DataParallel's Reducer
    "FLAGS_reducer_bucket_mb": 25,
    # the training API (hapi/): the step guard of Model.fit, which skips
    # a non-finite step and rolls back after this many in a row; the
    # fit loop's input prefetch thread; the background checkpoint
    # committer, keep-last-K retention, and the bound on waiting for
    # pending commits at a preemption or a recovery's restore (seconds)
    "FLAGS_check_nan_inf": False,
    "FLAGS_guard_max_bad_steps": 3,
    "FLAGS_input_prefetch": True,
    "FLAGS_async_checkpoint": False,
    "FLAGS_ckpt_keep": 3,
    "FLAGS_ckpt_flush_timeout": 60.0,
    # step-phase attribution (profiler/steptimer.py), and how often it
    # waits for the card's work to time a step
    "FLAGS_steptimer": True,
    "FLAGS_steptimer_sync_interval": 16,
    # resilience (resilience/): fault-injection spec and seed
    "FLAGS_fault_injection": "",
    "FLAGS_fault_injection_seed": 0,
    # retry policy of FS transfers, the elastic heartbeat and staging
    "FLAGS_retry_max_attempts": 3,
    "FLAGS_retry_backoff_base": 0.5,
    # watchdog deadline of one blocking section, and how often its
    # monitor thread checks the deadlines
    "FLAGS_collective_timeout": 300.0,
    "FLAGS_watchdog_interval": 5.0,
    # flight-recorder ring size (entries)
    "FLAGS_flight_recorder_size": 1024,
    # the known-answer test a restarted serving replica must pass
    "FLAGS_preflight_checks": True,
    # in-job recovery (resilience/recovery.py): the restart budget, how
    # long a re-rendezvous waits for replacements, the backoff base
    # (doubling a restart), and the healthy steps that refill the budget
    # (0: a budget for the job's lifetime)
    "FLAGS_recovery_max_restarts": 3,
    "FLAGS_recovery_rendezvous_timeout": 300.0,
    "FLAGS_recovery_backoff_base": 1.0,
    "FLAGS_recovery_restart_reset_steps": 100,
    # how long a quarantined.<rank> marker keeps a rank out (seconds)
    "FLAGS_quarantine_ttl": 3600.0,
    # silent-data-corruption defence (resilience/integrity.py): steps
    # between checksum consensus rounds (0 disables), how long one round
    # waits for the peers' digests, and the steps the replay ring keeps
    "FLAGS_integrity_check_interval": 100,
    "FLAGS_integrity_consensus_timeout": 30.0,
    "FLAGS_replay_buffer_size": 8,
    # straggler detection (resilience/health.py): rolling window (steps),
    # the threshold as a multiple of the group median, and the opt-in
    # quarantine of a rank that finds itself straggling
    "FLAGS_straggler_window": 50,
    "FLAGS_straggler_threshold": 3.0,
    "FLAGS_straggler_quarantine": False,
    # rotate the recovery journal past this size (two segments; 0: never)
    "FLAGS_journal_max_bytes": 1 << 20,
    # observability (profiler/): seconds between metrics snapshots written
    # to the artifacts dir (0 disables the exporter), and request tracing
    "FLAGS_metrics_export_interval": 60.0,
    "FLAGS_request_tracing": True,
    "FLAGS_trace_slow_ms": 1000.0,
    "FLAGS_trace_head_sample": 100,
    "FLAGS_trace_ring": 4096,
    # serving (serving/): watchdog deadline of one dispatched batch
    "FLAGS_serving_step_timeout": 60.0,
    # bounded request queue; admission sheds (ServerOverloaded) beyond it
    "FLAGS_serving_max_queue": 256,
    # AIMD admission target latency, and the base retry_after hint (s)
    "FLAGS_serving_admission_target_ms": 100.0,
    "FLAGS_serving_retry_after": 0.1,
    # circuit breaker: failures within the rolling window that open a
    # replica's breaker, and the cooldown before its half-open probe
    "FLAGS_serving_breaker_failures": 5,
    "FLAGS_serving_breaker_window": 30.0,
    "FLAGS_serving_breaker_cooldown": 10.0,
    # hedged dispatch: share of dispatches allowed a second attempt, and
    # the floor of the p99-derived hedge delay; budget 0 disables hedging
    "FLAGS_serving_hedge_budget": 0.05,
    "FLAGS_serving_hedge_min_ms": 10.0,
    # continuous-batching decode (serving/decode/): KV pool geometry
    "FLAGS_decode_block_size": 16,
    "FLAGS_decode_kv_blocks": 256,
    # prefill ration: prompt tokens absorbed per engine step
    "FLAGS_decode_prefill_chunk": 64,
    "FLAGS_decode_max_new_tokens": 64,
    # weight-only quantization of decode replicas: not ported, "" only
    "FLAGS_decode_quantize": "",
    "FLAGS_decode_prefix_sharing": False,
    "FLAGS_decode_spec_k": 0,
}


def _coerce(cur, val):
    if isinstance(cur, bool):
        if isinstance(val, str):
            return val.lower() in ("1", "true", "yes")
        return bool(val)
    if isinstance(cur, int):
        return int(val)
    if isinstance(cur, float):
        return float(val)
    return val


for _k in list(_FLAGS):
    if _k in os.environ:
        _FLAGS[_k] = _coerce(_FLAGS[_k], os.environ[_k])


def set_flags(flags: dict):
    for k, v in flags.items():
        _FLAGS[k] = _coerce(_FLAGS[k], v) if k in _FLAGS else v
    if "FLAGS_fault_injection" in flags or \
            "FLAGS_fault_injection_seed" in flags:
        from ..resilience import faults
        faults.reconfigure_from_flags()


def get_flags(flags=None):
    if flags is None:
        return dict(_FLAGS)
    if isinstance(flags, str):
        flags = [flags]
    return {k: _FLAGS.get(k) for k in flags}


def get_flag(name, default=None):
    return _FLAGS.get(name, default)
