"""Inference serving: dynamic batching, bucketed program cache,
multi-replica dispatch, continuous-batching decode (port of
paddle_tpu/serving/).

The layer on top of ``paddle_tpu_torch.inference``. Prior art: Clipper
(NSDI'17) adaptive batching + SLO-aware admission; ORCA (OSDI'22)
scheduler-level batching for accelerator inference. Every new input shape
costs the predictor a program (a CUDA graph on the card), so batches are
padded to a fixed bucket set and the program cache is bounded and counted.

Quickstart::

    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch import serving

    cfg = infer.Config(); cfg.set_layer(model)
    server = serving.InferenceServer(
        cfg, serving.ServingConfig(max_batch_size=8, replicas=2))
    server.start()                       # threaded batching loop
    out = server.infer([x], timeout=0.2)  # sheds with ServerOverloaded
    server.stop()

Not ported yet (ROADMAP A12): the socket frontend and its client
(``SocketFrontend``, ``client.py``, ``distributed/wire.py``), KV
migration, disaggregated prefill/decode, live rollout and the autoscaler.
"""
from .batcher import (  # noqa: F401
    Batch, BatchQueue, BucketedExecutor, DeadlineExceeded, Request,
    ServerOverloaded, bucket_for, pow2_buckets, signature_of,
)
from .metrics import ServingMetrics  # noqa: F401
from .overload import AdmissionController, CircuitBreaker  # noqa: F401
from .scheduler import (  # noqa: F401
    Replica, ReplicaDead, ReplicaRetired, Scheduler,
)
from .decode import (  # noqa: F401
    CompiledDecodeBackend, CompiledDecodeStep, DecodeConfig, DecodeEngine,
    DecodeStream, KVBlockPool, KVCacheExhausted,
)
from .server import InferenceServer, ServingConfig  # noqa: F401

__all__ = [
    "InferenceServer", "ServingConfig",
    "ServingMetrics", "ServerOverloaded", "DeadlineExceeded", "Request",
    "Batch", "BatchQueue", "BucketedExecutor", "Scheduler", "Replica",
    "ReplicaDead", "ReplicaRetired",
    "AdmissionController", "CircuitBreaker",
    "DecodeEngine", "DecodeConfig", "DecodeStream", "KVBlockPool",
    "KVCacheExhausted", "CompiledDecodeStep", "CompiledDecodeBackend",
    "bucket_for", "pow2_buckets", "signature_of",
]
