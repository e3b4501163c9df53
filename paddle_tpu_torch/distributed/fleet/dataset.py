"""Datasets for trainers in the process (port of paddle_tpu/distributed/
fleet/dataset.py).

Upstream's fleet/dataset/dataset.py over framework/data_set.cc and
data_feed.cc (MultiSlotDataFeed) is a multi-threaded C++ file reader that
fills a channel of slot records a worker. Here a dataset produces host
batches: the samples live in memory (``InMemoryDataset``) or stream from
generators (``QueueDataset``), batches go to the workers round robin, and
each is a {name: ndarray} feed, which a trainer moves to the card.
Parsing files is the reader's own business (a Python callable), where
upstream parses protobuf slots.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["DatasetBase", "InMemoryDataset", "QueueDataset"]


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._thread_num = 1
        self._use_vars = []
        self._drop_last = True

    # -- upstream's configuration (dataset.py's set_* family) --
    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self._thread_num = max(1, int(thread_num))

    def set_use_var(self, var_list):
        """The feed names, in the order of a sample's fields (upstream's
        MultiSlot slots)."""
        self._use_vars = list(var_list)

    def _var_names(self):
        names = []
        for v in self._use_vars:
            names.append(v if isinstance(v, str) else v.name)
        return names

    def _samples(self):
        raise NotImplementedError

    def batches(self, worker_id=0, num_workers=1):
        """This worker's {name: ndarray} feeds. Batches, not samples, go
        to the workers round robin, as upstream splits its channel a
        worker."""
        names = self._var_names()
        if not names:
            raise ValueError("dataset.set_use_var(...) was not called")
        buf = []
        bidx = 0
        for sample in self._samples():
            if not isinstance(sample, (tuple, list)):
                sample = (sample,)
            buf.append(sample)
            if len(buf) == self._batch_size:
                if bidx % num_workers == worker_id:
                    yield self._stack(names, buf)
                bidx += 1
                buf = []
        if buf and not self._drop_last and bidx % num_workers == worker_id:
            yield self._stack(names, buf)

    @staticmethod
    def _stack(names, buf):
        cols = list(zip(*buf))
        return {n: np.stack([np.asarray(v) for v in col])
                for n, col in zip(names, cols)}


class InMemoryDataset(DatasetBase):
    """Samples held in host memory, from a reader callable or a list
    (upstream's load_into_memory over its file channels)."""

    def __init__(self):
        super().__init__()
        self._data = []
        self._lock = threading.Lock()

    def set_sample_list(self, samples):
        self._data = list(samples)

    def load_into_memory(self, reader=None):
        """reader: a callable returning an iterable of sample tuples (the
        DataGenerator's place); nothing to do when the samples were set."""
        if reader is not None:
            with self._lock:
                self._data = list(reader())

    def local_shuffle(self, seed=None):
        rng = np.random.RandomState(seed)
        with self._lock:
            idx = rng.permutation(len(self._data))
            self._data = [self._data[i] for i in idx]

    def global_shuffle(self, fleet=None, seed=None):
        """Every trainer holds the whole sample list, so a seeded local
        shuffle is the same on each (upstream shuffles across its
        servers' shards; there is no sharded store here)."""
        self.local_shuffle(seed if seed is not None else 12343)

    def release_memory(self):
        self._data = []

    def get_memory_data_size(self, fleet=None):
        return len(self._data)

    def _samples(self):
        return iter(self._data)


class QueueDataset(DatasetBase):
    """Samples streamed from generator factories in one pass, never held
    (upstream's single-pass channel).

    Workers in threads take batches from ONE shared stream, first come
    first served, under a lock (the channel's pop), so no reader is read
    twice. A reader that is not callable can be read once: a second epoch
    yields nothing; pass callables for sources to read again.
    """

    _EXHAUSTED = object()

    def __init__(self):
        super().__init__()
        self._readers = []
        self._stream_lock = threading.Lock()
        self._stream = None  # the live shared batch iterator, or _EXHAUSTED

    def set_filelist(self, readers):
        """Upstream takes data files; each entry here is a callable
        returning an iterable of samples."""
        self._readers = list(readers)
        self._stream = None

    def _samples(self):
        for r in self._readers:
            it = r() if callable(r) else r
            for s in it:
                yield s

    # a trainer's pass (upstream's framework/trainer.py MultiTrainer): one
    # shared stream a threaded pass, opened before the workers start, so
    # a worker that finishes early cannot start a second read
    def _begin_pass(self, num_workers):
        with self._stream_lock:
            self._stream = super().batches(0, 1)

    def _end_pass(self):
        with self._stream_lock:
            self._stream = None

    def batches(self, worker_id=0, num_workers=1):
        if num_workers <= 1:
            yield from super().batches(worker_id, num_workers)
            return
        with self._stream_lock:
            if self._stream is None:
                # concurrent use without _begin_pass: the first caller
                # opens the pass; it stays closed once exhausted
                self._stream = super().batches(0, 1)
        while True:
            with self._stream_lock:
                if self._stream is self._EXHAUSTED or self._stream is None:
                    return
                try:
                    b = next(self._stream)
                except StopIteration:
                    self._stream = self._EXHAUSTED
                    return
            yield b
