"""DataParallel (port of paddle_tpu/distributed/parallel.py).

Wraps a layer for data-parallel training. At world size > 1 it attaches
the bucketed ``Reducer`` (``reducer.py``) to the layer's parameters: each
rank runs the forward and backward of its shard of the batch, and the
backward's hooks average the gradients over the group, bucket by bucket,
while the backward runs; the optimizer step then sees the averaged
gradients on every rank. The reference does the same on its eager
multi-process path (inside its compiled SPMD program XLA inserts the
reductions instead). At world size 1 the wrapper only forwards.

A step with the Reducer runs eagerly: its collectives go through the
process group (gloo stages them through the host), which a CUDA graph
cannot hold, so ``to_static`` and ``Model.fit`` run such a step without
capturing it (``captures``).
"""
from __future__ import annotations

import contextlib

from ..nn.layer.layers import Layer
from .collective import ReduceOp, all_reduce
from .env import get_world_size, is_initialized

__all__ = ["DataParallel"]


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=None,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self.group = group
        self.find_unused_parameters = find_unused_parameters
        self._reducer = None
        if get_world_size() > 1:
            if not is_initialized():
                raise RuntimeError(
                    f"DataParallel at world size {get_world_size()}: call "
                    f"paddle.distributed.init_parallel_env() first, or the "
                    f"replicas would train unsynchronised")
            # a module wrapped again must not stack reducers
            old = getattr(layers, "_pt_dp_reducer", None)
            if old is not None:
                old.detach()
            from .reducer import Reducer, reducer_bucket_bytes
            if comm_buffer_size is None:
                comm_buffer_size = reducer_bucket_bytes() >> 20
            self._reducer = Reducer(
                list(layers.parameters()),
                comm_buffer_size=comm_buffer_size,
                last_comm_buffer_size=last_comm_buffer_size, group=group)
            layers._pt_dp_reducer = self._reducer

    @property
    def captures(self):
        """Whether a step of this model may be captured in a CUDA graph:
        not while the Reducer communicates."""
        return self._reducer is None

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        # the Reducer averages the gradients; the loss stays as it is
        return loss

    @contextlib.contextmanager
    def no_sync(self):
        """Gradients accumulate locally inside (micro-batches); the next
        backward outside reduces the sum."""
        if self._reducer is not None:
            self._reducer.pause()
        try:
            yield
        finally:
            if self._reducer is not None:
                self._reducer.resume()

    def apply_collective_grads(self):
        """Average the gradients now (the Reducer does it at each
        backward's end already; an explicit call is idempotent)."""
        if get_world_size() <= 1:
            return
        if self._reducer is not None:
            self._reducer.finalize()
            return
        for p in self._layers.parameters():
            if p.grad is not None:
                all_reduce(p.grad, op=ReduceOp.AVG, group=self.group)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def load_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)

    def parameters(self, *args, **kwargs):
        return self._layers.parameters(*args, **kwargs)

    def named_parameters(self, *args, **kwargs):
        return self._layers.named_parameters(*args, **kwargs)
