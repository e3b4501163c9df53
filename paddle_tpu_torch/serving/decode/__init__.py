"""Continuous-batching autoregressive decode serving (port of
paddle_tpu/serving/decode/).

Layered under :class:`paddle_tpu_torch.serving.server.InferenceServer`:

- :mod:`.kv_cache` — paged KV-cache allocator (fixed block pool,
  per-stream block tables, OOM-safe admission);
- :mod:`.engine` — the continuous-batching scheduler (per-step
  join/leave, rationed chunked prefill, deadline/priority admission,
  replica-death replay);
- :mod:`.compiled_decode` — decode programs, one per (bucket, signature):
  a CUDA graph each on the card;
- :mod:`.prefix` — prefix-sharing KV cache: content-addressed radix
  index over the pool with refcounts, copy-on-write forks, and
  refcount-then-LRU eviction (warm prompts skip prefill);
- :mod:`.specdecode` — speculative decoding: draft-K proposals verified
  in one batched target step, token-identical to greedy decode;
- :mod:`.kv_migrate` — the two-phase prefill→decode KV handoff of
  disaggregated serving (``serving/disagg.py``), over the wire codec.

The reference's ``load_decode_model`` (weight-only int8 decode replicas)
needs ``slim.ptq`` and is not ported (ROADMAP A12).
"""
from __future__ import annotations

from .compiled_decode import CompiledDecodeBackend, CompiledDecodeStep
from .engine import DecodeConfig, DecodeEngine, DecodeStream
from .kv_cache import BlockTable, KVBlockPool, KVCacheExhausted
from .prefix import PrefixCache, PrefixHit
from .specdecode import DraftModel, MirrorDraft, NGramDraft, SpecDecoder

__all__ = [
    "BlockTable",
    "CompiledDecodeBackend",
    "CompiledDecodeStep",
    "DecodeConfig",
    "DecodeEngine",
    "DecodeStream",
    "DraftModel",
    "KVBlockPool",
    "KVCacheExhausted",
    "MirrorDraft",
    "NGramDraft",
    "PrefixCache",
    "PrefixHit",
    "SpecDecoder",
]
