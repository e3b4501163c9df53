"""Spawned DataLoader worker processes (port of paddle_tpu/io/worker.py).

Workers are spawned, not forked: the parent may hold a CUDA context,
which a forked child cannot use. They start with ``CUDA_VISIBLE_DEVICES``
empty (io/__init__.py's ``_WORKER_ENV``), so a dataset that calls into
torch there stays on the host, and they run torch and the BLAS libraries
on one thread each, so that a few workers do not oversubscribe the
host's cores. Samples return
as numpy: arrays of at least ``SHM_MIN_BYTES`` through POSIX shared memory
(``multiprocessing.shared_memory``, the reference's mmap tensors), smaller
objects through the result queue. A sample's exception travels back as
its traceback and is raised in the consumer.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np

SHM_MIN_BYTES = 1 << 16  # below this, pickling through the queue is cheaper


# -- sample transport -----------------------------------------------------

def _encode(obj, shms, use_shm):
    """Samples as queue-safe payloads: large arrays go to shared memory
    (an ``"__shm__"`` tag), the rest pass through."""
    if isinstance(obj, np.ndarray) and use_shm and obj.nbytes >= SHM_MIN_BYTES:
        from multiprocessing import resource_tracker, shared_memory
        shm = shared_memory.SharedMemory(create=True, size=obj.nbytes)
        # the parent owns the segment from here (it unlinks after copying
        # out): keep this worker's resource tracker out of its lifetime
        try:
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:
            pass
        dst = np.ndarray(obj.shape, dtype=obj.dtype, buffer=shm.buf)
        dst[...] = obj
        shms.append(shm)
        return ("__shm__", shm.name, obj.dtype.str, obj.shape)
    if isinstance(obj, tuple):
        return tuple(_encode(x, shms, use_shm) for x in obj)
    if isinstance(obj, list):
        return [_encode(x, shms, use_shm) for x in obj]
    if isinstance(obj, dict):
        return {k: _encode(v, shms, use_shm) for k, v in obj.items()}
    return obj


def decode(obj):
    """In the parent: copy shared-memory arrays out, then unlink them."""
    if isinstance(obj, tuple):
        if len(obj) == 4 and obj[0] == "__shm__":
            from multiprocessing import shared_memory
            _, name, dtype, shape = obj
            shm = shared_memory.SharedMemory(name=name)
            try:
                arr = np.array(np.ndarray(shape, dtype=np.dtype(dtype),
                                          buffer=shm.buf))
            finally:
                shm.close()
                shm.unlink()
            return arr
        return tuple(decode(x) for x in obj)
    if isinstance(obj, list):
        return [decode(x) for x in obj]
    if isinstance(obj, dict):
        return {k: decode(v) for k, v in obj.items()}
    return obj


def discard(obj):
    """Unlink the shared-memory segments of a payload that will not be
    decoded (an iterator closed early)."""
    if isinstance(obj, tuple) and len(obj) == 4 and obj[0] == "__shm__":
        from multiprocessing import shared_memory
        try:
            shm = shared_memory.SharedMemory(name=obj[1])
            shm.close()
            shm.unlink()
        except FileNotFoundError:
            pass
        return
    if isinstance(obj, (tuple, list)):
        for x in obj:
            discard(x)
    elif isinstance(obj, dict):
        for v in obj.values():
            discard(v)


def _to_numpy(s):
    """Tensors cross the process boundary as numpy arrays (a bf16 one as
    its 16-bit words, ``io_utils._Bf16Words``)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(s, torch.Tensor):
        from ..framework.io_utils import _numpy_from_tensor
        return _numpy_from_tensor(s)
    if isinstance(s, (tuple, list)):
        out = [_to_numpy(x) for x in s]
        return tuple(out) if isinstance(s, tuple) else out
    if isinstance(s, dict):
        return {k: _to_numpy(v) for k, v in s.items()}
    return s


def worker_loop(dataset, index_queue, result_queue, worker_id, num_workers,
                worker_init_fn, use_shared_memory):
    """One spawned worker: take ``(batch_idx, indices)``, put back
    ``(batch_idx, "ok", samples, meta)`` or ``(batch_idx, "err",
    traceback, None)``. Runs until it takes None."""
    torch = sys.modules.get("torch")
    if torch is not None:
        torch.set_num_threads(1)
    from .. import io as pio
    pio._worker_info = pio._WorkerInfo(
        id=worker_id, num_workers=num_workers, dataset=dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            return
        bidx, indices = item
        shms = []
        try:
            t0 = time.perf_counter()
            samples = [_to_numpy(dataset[i]) for i in indices]
            payload = _encode(samples, shms, use_shared_memory)
            # the parent folds fetch_ms into the io.worker_fetch_ms
            # histogram
            meta = {"fetch_ms": (time.perf_counter() - t0) * 1e3,
                    "worker_id": worker_id}
            result_queue.put((bidx, "ok", payload, meta))
            for shm in shms:
                shm.close()  # the parent unlinks after copying out
        except Exception:
            # nothing was queued: these segments have no owner left (they
            # were unregistered from the tracker), so unlink them here
            for shm in shms:
                try:
                    shm.close()
                    shm.unlink()
                except Exception:
                    pass
            result_queue.put((bidx, "err", traceback.format_exc(), None))
