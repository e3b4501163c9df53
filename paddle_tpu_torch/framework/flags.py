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
  ``FLAGS_async_checkpoint`` (off; a set value raises in
  ``resilience.snapshot.save_model``: the background committer is ROADMAP
  A11), ``FLAGS_ckpt_keep`` (3), ``FLAGS_steptimer`` (on) and
  ``FLAGS_steptimer_sync_interval`` (16).
- Resilience and observability: ``FLAGS_fault_injection`` and its seed
  (setting either reconfigures ``resilience.faults``), the watchdog's
  ``FLAGS_collective_timeout`` and ``FLAGS_watchdog_interval``, the flight
  recorder's size, ``FLAGS_preflight_checks``, the metrics exporter's
  interval and the request tracer's switches.
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
    # committer (not ported: a set value raises in save_model)
    "FLAGS_check_nan_inf": False,
    "FLAGS_guard_max_bad_steps": 3,
    "FLAGS_input_prefetch": True,
    "FLAGS_async_checkpoint": False,
    "FLAGS_ckpt_keep": 3,
    # step-phase attribution (profiler/steptimer.py), and how often it
    # waits for the card's work to time a step
    "FLAGS_steptimer": True,
    "FLAGS_steptimer_sync_interval": 16,
    # resilience (resilience/): fault-injection spec and seed
    "FLAGS_fault_injection": "",
    "FLAGS_fault_injection_seed": 0,
    # watchdog deadline of one blocking section, and how often its
    # monitor thread checks the deadlines
    "FLAGS_collective_timeout": 300.0,
    "FLAGS_watchdog_interval": 5.0,
    # flight-recorder ring size (entries)
    "FLAGS_flight_recorder_size": 1024,
    # the known-answer test a restarted serving replica must pass
    "FLAGS_preflight_checks": True,
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
