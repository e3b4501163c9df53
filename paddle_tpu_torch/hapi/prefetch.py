"""Double-buffered host→device input prefetch for the fit loop (port of
paddle_tpu/hapi/prefetch.py).

A worker thread pulls batches from the loader ahead of training, splits
them into (inputs, labels) and stages every leaf on the network's device,
so step N+1's batch is in flight while step N runs. The queue holds at
most ``depth`` batches (2: double buffering).

On the card a batch is staged by copying it from pinned host memory with
``non_blocking=True`` on a side CUDA stream, after which the thread
records an event. ``get()`` makes the consumer's current stream wait on
that event and records the staged tensors on that stream for the caching
allocator, so the step's first reads (a captured step's ``copy_`` into its
static inputs among them) are ordered after the copy. A network on the
host gets its batches as the loader made them. A batch never reaches a
card network on the host.

The thread's CUDA work (pinning, allocation, the copy) may overlap the
capture of a step's CUDA graph on the main thread: the port captures in
``thread_local`` mode (jit/to_static.py), which leaves other threads free.

Two contracts of the reference hold:

- exact resume (resilience/snapshot.py): the worker iterates
  ``loader.iter_uncounted()`` and the fit loop advances the cursor with
  ``loader.note_consumed(k)`` after a group of steps has run, so a
  mid-epoch save never skips a batch the restored run still needs;
- a worker's exception (the loader's, or a spawned worker's) is raised
  by ``get()``, at the step that would have trained on the batch.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..framework.io_utils import tensor_from_numpy

__all__ = ["InputPrefetcher"]

_POLL_S = 0.2  # put/get poll, so that close() can interrupt a wait


def _as_host_tensor(v):
    """A leaf as a tensor: tensors pass, numeric arrays and scalars become
    CPU tensors, anything else (strings, objects) is None."""
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if arr.dtype == object or arr.dtype.kind in "USV":
        return None
    return tensor_from_numpy(arr)


class InputPrefetcher:
    """Background staging of (inputs, labels) batches from a DataLoader.

    ``get()`` returns the next staged ``(ins, labs)`` pair (lists of
    tensors on ``device``), ``DONE`` at the end of the epoch, or raises
    the worker's exception.
    """

    DONE = object()

    def __init__(self, loader, split_fn, device=None, depth=2):
        self._loader = loader
        self._split = split_fn
        self._device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda \
            else None
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._staged = 0  # guarded-by: _lock (batches staged so far)
        self._thread = threading.Thread(
            target=self._run, name="fit-input-prefetch", daemon=True)
        self._thread.start()

    def _stage(self, v):   # hot-path: overlapped h2d staging
        """Start the host→device copy of one leaf (on the side stream when
        the target is the card). Values that are not numeric pass through
        unchanged."""
        t = _as_host_tensor(v)
        if t is None:
            return v
        if not self._cuda or t.device == self._device:
            return t
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(self._device, non_blocking=True)

    def _stage_batch(self, ins, labs):
        """(staged inputs, staged labels, the event that marks their copy
        done or None)."""
        if not self._cuda:
            return ([self._stage(v) for v in ins],
                    [self._stage(v) for v in labs], None)
        with torch.cuda.device(self._device), \
                torch.cuda.stream(self._stream):
            item = ([self._stage(v) for v in ins],
                    [self._stage(v) for v in labs])
            event = torch.cuda.Event()
            event.record(self._stream)
        return (*item, event)

    def _run(self):
        from ..profiler import steptimer as _steptimer
        timer = _steptimer.get_steptimer()
        try:
            src = (self._loader.iter_uncounted()
                   if hasattr(self._loader, "iter_uncounted")
                   else iter(self._loader))
            for batch in src:
                if self._stop.is_set():
                    return
                ins, labs = self._split(batch)
                # staging time lands in the io histogram: the overlapped
                # copy no longer shows in step/h2d
                t0 = timer._clock()
                item = self._stage_batch(ins, labs)
                timer._registry.observe(
                    "io.prefetch_stage_ms", (timer._clock() - t0) * 1e3)
                with self._lock:
                    self._staged += 1
                self._put(("ok", item))
            self._put(("done", None))
        except BaseException as e:  # raised by get()
            self._put(("err", e))

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def get(self):
        """The next staged batch (see the module docstring)."""
        while True:
            try:
                kind, payload = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise RuntimeError(
                        "the input prefetch thread ended without posting "
                        "a result")
                continue
            if kind == "done":
                return self.DONE
            if kind == "err":
                raise payload
            ins, labs, event = payload
            if event is not None:
                current = torch.cuda.current_stream(self._device)
                current.wait_event(event)
                for t in (*ins, *labs):
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        t.record_stream(current)
            return ins, labs

    def staged(self):
        """Batches staged by the worker so far."""
        with self._lock:
            return self._staged

    def close(self):
        """Stop the worker and drop the read-ahead (uncounted, so dropping
        it costs the cursor nothing)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
