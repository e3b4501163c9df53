"""paddle.io (port of paddle_tpu/io/__init__.py): datasets, samplers,
``default_collate_fn`` and ``DataLoader``.

Batches are collated on the host as CPU tensors; moving them to the card
is the consumer's work (``hapi.Model.fit``'s prefetcher copies them from
pinned memory on a side stream). ``num_workers > 0`` fetches batches on a
thread pool, or, with ``use_multiprocess=True``, on a pool of spawned
worker processes that return large arrays through shared memory
(``io/worker.py``); workers never initialise CUDA. ``RandomSampler`` and
``random_split`` draw from numpy's global generator, as the reference's
do, so one ``np.random.seed`` gives one order in both packages.

The reference stacks large batches with a C++ collate (``csrc/io.cc``);
its fallback, ``np.stack``, gives the same bytes and is what the port
uses until that binding is ported (ROADMAP A13).
"""
from __future__ import annotations

import itertools
import queue as _queue
import threading

import numpy as np
import torch

from ..framework.io_utils import _Bf16Words, tensor_from_numpy

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "Sampler",
           "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
           "BatchSampler", "DistributedBatchSampler", "DataLoader",
           "get_worker_info", "default_collate_fn"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long arrays or tensors."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = sum(lengths)
    assert total == len(dataset)
    perm = np.random.permutation(total)
    out = []
    ofs = 0
    for ln in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + ln].tolist()))
        ofs += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """Draws from numpy's global generator (``generator`` is accepted and
    not read, as in the reference)."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        if isinstance(weights, torch.Tensor):
            weights = weights.detach().cpu().numpy()
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """One rank's shard of the batches: rank ``r`` of ``n`` takes every
    n-th sample of the padded index list (shuffled by a generator seeded
    with the epoch, so every rank draws the same permutation)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import get_rank, get_world_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None \
            else get_world_size()
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
            self.epoch += 1
        indices = np.concatenate(
            [indices, indices[:self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices:
            batch.append(int(idx))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


class _WorkerInfo:
    def __init__(self, id=0, num_workers=1, dataset=None):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """In a spawned worker process: its id, the pool's size and the
    dataset; None elsewhere."""
    return _worker_info


def default_collate_fn(batch):
    """Stack a list of samples into CPU tensors: arrays and tensors along a
    new leading axis, Python ints as int64 and floats as float32, and
    lists, tuples and dicts field by field."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        stacked = np.stack([np.asarray(b) for b in batch])
        if stacked.dtype.name == "bfloat16":
            return tensor_from_numpy(stacked)
        return torch.from_numpy(stacked)
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, _Bf16Words):
        # a bf16 tensor from a spawned worker, as its 16-bit words
        return torch.stack([b.tensor() for b in batch])
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, float):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        transposed = zip(*batch)
        return [default_collate_fn(list(s)) for s in transposed]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


# the environment spawned workers start with: no visible card, so nothing
# they run can initialise CUDA, and one thread for the numeric libraries,
# so that a few workers do not oversubscribe the host's cores (each BLAS
# call of a transform otherwise starts a thread per core in every worker)
_WORKER_ENV = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
               "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


class _ProcessPool:
    """A pool of spawned worker processes: one index queue per worker, one
    shared result queue, results put back in order by the caller. Spawn,
    not fork: the parent may hold a CUDA context, which a forked child
    cannot use. The children start with ``_WORKER_ENV``."""

    def __init__(self, dataset, num_workers, worker_init_fn,
                 use_shared_memory, timeout):
        import multiprocessing as mp
        import os
        from . import worker as _worker
        self._worker_mod = _worker
        self._timeout = timeout or None
        ctx = mp.get_context("spawn")
        self.index_queues = [ctx.Queue() for _ in range(num_workers)]
        self.result_queue = ctx.Queue()
        self.procs = []
        old = {k: os.environ.get(k) for k in _WORKER_ENV}
        os.environ.update(_WORKER_ENV)
        try:
            for wid in range(num_workers):
                p = ctx.Process(
                    target=_worker.worker_loop,
                    args=(dataset, self.index_queues[wid], self.result_queue,
                          wid, num_workers, worker_init_fn,
                          use_shared_memory),
                    daemon=True)
                p.start()
                self.procs.append(p)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        self.num_workers = num_workers
        self._next_send = 0  # global batch counter (round-robin dispatch)

    def submit(self, indices):
        bidx = self._next_send
        self.index_queues[bidx % self.num_workers].put((bidx, list(indices)))
        self._next_send += 1
        return bidx

    def recv(self):
        """Next result; polls so that a dead worker raises instead of
        hanging. Time blocked here is input wait (``step/input_wait``)."""
        from ..profiler.steptimer import get_steptimer
        with get_steptimer().phase("step/input_wait"):
            return self._recv()

    def _recv(self):
        waited = 0.0
        while True:
            try:
                return self.result_queue.get(timeout=1.0)
            except _queue.Empty:
                waited += 1.0
                dead = [i for i, p in enumerate(self.procs)
                        if not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"DataLoader worker(s) {dead} died unexpectedly "
                        "(exitcodes "
                        f"{[self.procs[i].exitcode for i in dead]})"
                    ) from None
                if self._timeout is not None and waited >= self._timeout:
                    raise TimeoutError(
                        f"DataLoader worker timed out after {waited}s "
                        "(slow dataset)") from None

    def shutdown(self):
        for iq in self.index_queues:
            try:
                iq.put(None)
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(timeout=1)


class DataLoader:
    """paddle.io.DataLoader.

    ``num_workers > 0`` fetches and collates batches on a thread pool with
    a bounded in-order window, or on spawned processes with
    ``use_multiprocess=True`` (the dataset must pickle; collation runs in
    the parent). ``places``, ``feed_list`` and ``return_list`` are accepted
    for the reference's signature and not read.
    """

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_multiprocess=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_multiprocess = use_multiprocess
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.persistent_workers = persistent_workers
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = max(2, prefetch_factor)
        self._pool = None  # persistent spawn pool (persistent_workers=True)
        self._iterable_ds = isinstance(dataset, IterableDataset)
        # the resumable cursor (resilience/snapshot.py): batches handed out
        # in this epoch pass, and a pending fast-forward set_state_dict arms
        self._epoch_batches = 0
        self._resume_skip = 0
        self._sampler_epoch = None
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        elif self._iterable_ds:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_ds:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _iter_batches(self, skip=0):
        if self._iterable_ds:
            done = 0
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    if done >= skip:
                        yield self.collate_fn(batch)
                    done += 1
                    batch = []
            if batch and not getattr(self, "drop_last", False) \
                    and done >= skip:
                yield self.collate_fn(batch)
        else:
            for k, indices in enumerate(self.batch_sampler):
                if k < skip:
                    continue  # cursor fast-forward: no dataset fetch
                samples = [self.dataset[i] for i in indices]
                yield self.collate_fn(samples)

    # -- the resumable cursor (resilience/snapshot.py) ----------------------
    def state_dict(self):
        """The cursor: batches handed out in the current epoch pass, and
        the sampler epoch that seeded their order."""
        return {"batches_consumed": int(self._epoch_batches),
                "epoch": self._sampler_epoch}

    def set_state_dict(self, state):
        """Arm the next iteration to skip the batches already consumed (a
        sampler-order skip: on the num_workers=0 path the skipped prefix
        fetches nothing), so a restored run replays no batch and skips
        none. An exact order needs a deterministic or epoch-seeded sampler
        (SequenceSampler, DistributedBatchSampler); RandomSampler draws
        from numpy's global generator."""
        state = state or {}
        self._resume_skip = int(state.get("batches_consumed") or 0)
        ep = state.get("epoch")
        if ep is not None and hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(int(ep))

    def __iter__(self):
        skip, self._resume_skip = self._resume_skip, 0
        # read before the sampler iterates (DistributedBatchSampler bumps
        # .epoch inside __iter__): this value reproduces the order
        self._sampler_epoch = getattr(self.batch_sampler, "epoch", None)
        self._epoch_batches = skip
        for batch in self._raw_iter(skip):
            # counted before the yield returns control: the cursor counts
            # batches whose effects a step-boundary save has seen
            self._epoch_batches += 1
            yield batch

    def iter_uncounted(self):
        """Like ``__iter__``, but the cursor does not advance per batch: a
        prefetch pipeline reads ahead of training, and its consumer calls
        :meth:`note_consumed` once a batch's step has run."""
        skip, self._resume_skip = self._resume_skip, 0
        self._sampler_epoch = getattr(self.batch_sampler, "epoch", None)
        self._epoch_batches = skip
        yield from self._raw_iter(skip)

    def note_consumed(self, n=1):
        """Advance the cursor by ``n`` trained-on batches."""
        self._epoch_batches += int(n)

    def _raw_iter(self, skip=0):
        if self.num_workers == 0:
            yield from self._iter_batches(skip)
            return
        gen = (self._iter_single_producer() if self._iterable_ds
               else self._iter_process_pool() if self.use_multiprocess
               else self._iter_worker_pool())
        # worker pools have no index-level fast-forward: batches before the
        # cursor are fetched and dropped
        for k, batch in enumerate(gen):
            if k < skip:
                continue
            yield batch

    def _iter_worker_pool(self):
        """``num_workers`` threads fetch and collate batches with a bounded
        in-order window (numpy and torch release the GIL in their
        kernels)."""
        from concurrent.futures import ThreadPoolExecutor
        window = self.prefetch_factor * self.num_workers

        def fetch(indices):
            samples = [self.dataset[i] for i in indices]
            return self.collate_fn(samples)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            it = iter(self.batch_sampler)
            try:
                for indices in it:
                    pending.append(pool.submit(fetch, indices))
                    if len(pending) >= window:
                        yield pending.pop(0).result()
                while pending:
                    yield pending.pop(0).result()
            finally:
                for f in pending:
                    f.cancel()

    def _iter_process_pool(self):
        """Spawned worker processes (``use_multiprocess=True``): each
        fetches whole batches of samples, large arrays come back through
        shared memory, and the parent collates in order.
        ``persistent_workers=True`` keeps the pool across epochs. A
        worker's exception is raised here, in the consumer, with the
        worker's traceback."""
        from . import worker as _worker
        pool = self._pool
        if pool is None:
            pool = _ProcessPool(self.dataset, self.num_workers,
                                self.worker_init_fn, self.use_shared_memory,
                                self.timeout)
            if self.persistent_workers:
                self._pool = pool
        window = self.prefetch_factor * self.num_workers
        state = {"ready": {}, "next_yield": None, "in_flight": 0}

        def drain_one():
            """Receive one result into the reorder buffer (raises on a
            failed worker)."""
            item = pool.recv()
            ridx, status, payload = item[0], item[1], item[2]
            state["in_flight"] -= 1
            if status == "err":
                raise RuntimeError(f"DataLoader worker failed:\n{payload}")
            meta = item[3] if len(item) > 3 else None
            if meta and isinstance(meta.get("fetch_ms"), (int, float)):
                from ..profiler import metrics as _metrics
                _metrics.get_registry().observe("io.worker_fetch_ms",
                                                meta["fetch_ms"])
            state["ready"][ridx] = payload

        def pop_ready():
            ready = state["ready"]
            while state["next_yield"] in ready:
                payload = ready.pop(state["next_yield"])
                state["next_yield"] += 1
                yield self.collate_fn(_worker.decode(payload))

        try:
            for indices in self.batch_sampler:
                bidx = pool.submit(indices)
                if state["next_yield"] is None:
                    state["next_yield"] = bidx  # this epoch's first batch
                state["in_flight"] += 1
                while state["in_flight"] >= window:
                    drain_one()
                    yield from pop_ready()
            while state["in_flight"]:
                drain_one()
            yield from pop_ready()
        finally:
            # an early close or an error: drain the in-flight results so a
            # persistent pool starts its next epoch clean, and free every
            # shared-memory segment
            while state["in_flight"]:
                try:
                    item = pool.result_queue.get(timeout=5)
                    status, payload = item[1], item[2]
                except (_queue.Empty, OSError):
                    break
                state["in_flight"] -= 1
                if status == "ok":
                    _worker.discard(payload)
            for payload in state["ready"].values():
                _worker.discard(payload)
            if state["in_flight"]:
                # the drain timed out: stale results remain queued, so a
                # persistent pool would fall out of step; retire it
                if pool is self._pool:
                    self._pool = None
                pool.shutdown()
            elif pool is not self._pool:
                pool.shutdown()

    def __del__(self):
        pool, self._pool = getattr(self, "_pool", None), None
        if pool is not None:
            pool.shutdown()

    def _iter_single_producer(self):
        q = _queue.Queue(
            maxsize=self.prefetch_factor * max(self.num_workers, 1))
        stop = object()
        error = []
        cancel = threading.Event()

        def producer():
            try:
                for b in self._iter_batches():
                    while not cancel.is_set():
                        try:
                            q.put(b, timeout=0.1)
                            break
                        except _queue.Full:
                            continue
                    if cancel.is_set():
                        return
            except BaseException as e:  # reaches the consumer
                error.append(e)
            finally:
                while not cancel.is_set():
                    try:
                        q.put(stop, timeout=0.1)
                        break
                    except _queue.Full:
                        continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            # the consumer stopped early: unblock the producer
            cancel.set()
            while True:
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
            t.join(timeout=5)
        if error:
            raise error[0]
