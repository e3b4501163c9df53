"""One CUDA graph of an inference call over static buffers.

The serving programs of the port: ``inference.Predictor`` keeps one per
input signature (the reference keeps one ``jax.jit`` per signature) and the
serving decode step one per (bucket, signature) (the reference's donated
jitted step). ``InferenceGraph(fn, example)`` copies ``example`` into
static input buffers on its device, runs ``fn`` once eagerly on a side
stream (what a call creates once: the kernel libraries, cuBLAS's handles
and workspaces), then captures ``fn`` on that stream under
``torch.inference_mode``, in a memory pool of its own, so dropping the
object frees the graph and its pool. ``capture_error_mode="thread_local"``
lets other threads launch work (another graph's replay, a host copy) while
one thread captures. The side stream is the capturing thread's own, one a
device, reused by every graph that thread builds: cuBLAS keeps a
workspace for each stream it runs on for the life of the process, so a
stream a graph would leave one behind for every graph a server ever built
(a replica added by a rollout or an autoscaler builds one a bucket).

``run(inputs)`` copies the inputs into the static buffers (casting to
their dtypes: a float32 host array into a bfloat16 buffer is the per-call
cast), replays, and returns host copies of the outputs, all under the
graph's lock: replicas that share a graph replay it one at a time, and no
caller ever holds a buffer that the next replay overwrites. A capture that
fails raises, naming the call; nothing falls back to eager.
"""
from __future__ import annotations

import threading

import torch

from .to_static import _flatten_tensors

__all__ = ["InferenceGraph"]

_THREAD = threading.local()


def _side_stream(device):
    """This thread's capture stream on ``device`` (made on first use)."""
    streams = getattr(_THREAD, "streams", None)
    if streams is None:
        streams = _THREAD.streams = {}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in streams:
        streams[index] = torch.cuda.Stream(device)
    return streams[index]


class InferenceGraph:
    def __init__(self, fn, example, name="inference"):
        device = example[0].device
        self.name = name
        self.lock = threading.Lock()
        with torch.no_grad():
            self.static_in = [torch.empty(t.shape, dtype=t.dtype,
                                          device=device) for t in example]
            for dst, src in zip(self.static_in, example):
                dst.copy_(src)
        side = _side_stream(device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(device), torch.inference_mode():
                with torch.cuda.stream(side):
                    fn(*self.static_in)
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = fn(*self.static_in)
        except Exception as err:
            raise RuntimeError(
                f"{name}: capturing the call as a CUDA graph failed; an "
                f"inference program may not sync with the host or copy "
                f"from it ({type(err).__name__}: {err})") from err
        current.wait_stream(side)
        self.graph = graph
        self.out_tree = out   # the call's output structure
        self.static_out = _flatten_tensors(out, [])

    def run(self, inputs):
        """Replay on ``inputs`` (tensors on any device, one per static
        buffer); the outputs as CPU tensors, flattened in ``out_tree``'s
        order."""
        with self.lock, torch.no_grad():
            for dst, src in zip(self.static_in, inputs):
                dst.copy_(src)
            self.graph.replay()
            return [t.cpu() for t in self.static_out]
