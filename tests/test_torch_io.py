"""The port's paddle.io against the reference's on the host.

Datasets, samplers and ``default_collate_fn`` must match the reference
exactly: the same indices in the same order under one
``np.random.seed``, and the same values, shapes and dtypes. The
DataLoader's paths (single process, thread pool, iterable producer,
spawned processes with shared memory) must give the same batches as its
single-process path, which matches the reference's; its resumable cursor
must skip exactly the consumed batches. Spawned workers import torch
(seconds each), so the process-pool cases are few and use the port's own
picklable datasets.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import paddle_tpu.io as rio  # noqa: E402
from paddle_tpu.vision import datasets as rds  # noqa: E402

import paddle_tpu_torch.io as pio  # noqa: E402
from paddle_tpu_torch.vision import datasets as pds  # noqa: E402

torch.set_num_threads(1)


def _np(x):
    """A batch leaf of either package as numpy."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x._value) if hasattr(x, "_value") else np.asarray(x)


def _same(a, b):
    """Equal values, shapes and dtypes over nested batches. The
    reference's arrays live in JAX without 64-bit types, where an int64
    batch becomes int32: the port keeps int64, paddle's label dtype."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
        return
    if isinstance(a, (list, tuple)) and not hasattr(a, "shape"):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    x, y = _np(a), _np(b)
    if x.dtype == np.int64 and y.dtype == np.int32:
        y = y.astype(np.int64)
    assert x.dtype == y.dtype and x.shape == y.shape
    np.testing.assert_array_equal(x, y)


def _pair(build):
    """The same construction in both packages: build(io module)."""
    return build(pio), build(rio)


SAMPLERS = {
    "sequence": lambda io: io.SequenceSampler(list(range(23))),
    "random": lambda io: io.RandomSampler(list(range(23))),
    "random_replacement": lambda io: io.RandomSampler(
        list(range(23)), replacement=True, num_samples=40),
    "random_num_samples": lambda io: io.RandomSampler(
        list(range(23)), num_samples=9),
    "weighted": lambda io: io.WeightedRandomSampler(
        np.linspace(0.1, 1.0, 23), 30),
    "weighted_no_replacement": lambda io: io.WeightedRandomSampler(
        np.linspace(0.1, 1.0, 23), 10, replacement=False),
    "batch": lambda io: io.BatchSampler(list(range(23)), batch_size=5),
    "batch_drop_last": lambda io: io.BatchSampler(
        list(range(23)), batch_size=5, drop_last=True),
    "batch_shuffle": lambda io: io.BatchSampler(
        list(range(23)), shuffle=True, batch_size=4),
    "distributed_rank0": lambda io: io.DistributedBatchSampler(
        list(range(23)), batch_size=4, num_replicas=2, rank=0),
    "distributed_rank1_shuffle": lambda io: io.DistributedBatchSampler(
        list(range(23)), batch_size=4, num_replicas=2, rank=1, shuffle=True),
    "distributed_drop_last": lambda io: io.DistributedBatchSampler(
        list(range(23)), batch_size=4, num_replicas=3, rank=2,
        drop_last=True),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_samplers_match_reference(name):
    port, ref = _pair(SAMPLERS[name])
    assert len(port) == len(ref)
    for epoch in range(2):  # DistributedBatchSampler reshuffles per epoch
        np.random.seed(epoch)
        p = list(port)
        np.random.seed(epoch)
        r = list(ref)
        assert p == r and p


DATASETS = {
    "tensor": lambda io: io.TensorDataset(
        [np.arange(12, dtype=np.float32).reshape(6, 2),
         np.arange(6, dtype=np.int64)]),
    "compose": lambda io: io.ComposeDataset(
        [io.TensorDataset([np.arange(5, dtype=np.int64)]),
         io.TensorDataset([np.arange(5, 10, dtype=np.float32),
                           np.ones(5, dtype=np.float32)])]),
    "subset": lambda io: io.Subset(
        io.TensorDataset([np.arange(10, dtype=np.int64)]), [7, 2, 5]),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_map_datasets_match_reference(name):
    port, ref = _pair(DATASETS[name])
    assert len(port) == len(ref)
    for i in range(len(ref)):
        _same(port[i], ref[i])


def test_random_split_and_chain_match_reference():
    def split(io):
        np.random.seed(4)
        return io.random_split(
            io.TensorDataset([np.arange(10, dtype=np.int64)]), [3, 7])
    port, ref = _pair(split)
    assert [p.indices for p in port] == [r.indices for r in ref]

    class Counting(pio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))
    # (list() would ask for a len(), which an IterableDataset refuses)
    assert [v for v in pio.ChainDataset([Counting(2), Counting(3)])] == \
        [0, 1, 0, 1, 2]


COLLATE = {
    "arrays": [np.full((2, 3), i, np.float32) for i in range(4)],
    "ints": [1, 5, 7],
    "floats": [0.5, 1.5],
    "int64_scalars": [np.asarray(i, np.int64) for i in range(3)],
    "tuples": [(np.ones(2, np.float32) * i, i) for i in range(3)],
    "dicts": [{"x": np.arange(3, dtype=np.int32) + i, "y": float(i)}
              for i in range(2)],
    "strings": ["a", "b"],
}


@pytest.mark.parametrize("name", sorted(COLLATE))
def test_default_collate_matches_reference(name):
    p = pio.default_collate_fn(COLLATE[name])
    r = rio.default_collate_fn(COLLATE[name])
    if name == "strings":
        assert p == r == ["a", "b"]
        return
    _same(p, r)
    leaves = p.values() if isinstance(p, dict) else \
        p if isinstance(p, list) else [p]
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in leaves)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_dataloader_matches_reference(shuffle, drop_last):
    port = pio.DataLoader(pds.MNIST(mode="train"), batch_size=300,
                          shuffle=shuffle, drop_last=drop_last)
    ref = rio.DataLoader(rds.MNIST(mode="train"), batch_size=300,
                         shuffle=shuffle, drop_last=drop_last)
    assert len(port) == len(ref)
    np.random.seed(2)
    p = list(port)
    np.random.seed(2)
    r = list(ref)
    assert len(p) == len(r)
    for a, b in zip(p, r):
        _same(a, b)


def test_basic_batching_and_shuffle_cover_all():
    xs = np.arange(20, dtype=np.float32).reshape(10, 2)
    ds = pio.TensorDataset([xs, np.arange(10, dtype=np.int64)])
    batches = list(pio.DataLoader(ds, batch_size=4, drop_last=False))
    assert [tuple(b[0].shape) for b in batches] == [(4, 2), (4, 2), (2, 2)]
    ds = pio.TensorDataset([np.arange(16, dtype=np.int64)])
    seen = np.sort(np.concatenate(
        [b[0].numpy() for b in pio.DataLoader(ds, batch_size=4,
                                              shuffle=True)]))
    np.testing.assert_array_equal(seen, np.arange(16))


def test_thread_pool_and_iterable_paths_match_single_process():
    ds = pds.MNIST(mode="train")
    single = list(pio.DataLoader(ds, batch_size=32, num_workers=0))[:5]
    threads = list(pio.DataLoader(ds, batch_size=32, num_workers=4))[:5]
    for a, b in zip(single, threads):
        _same(a, b)

    class Stream(pio.IterableDataset):
        def __iter__(self):
            return (np.full(3, i, np.float32) for i in range(10))
    got = list(pio.DataLoader(Stream(), batch_size=4, num_workers=2))
    assert [tuple(b.shape) for b in got] == [(4, 3), (4, 3), (2, 3)]
    np.testing.assert_array_equal(torch.cat(got)[:, 0].numpy(),
                                  np.arange(10, dtype=np.float32))
    # an early break does not hang the producer
    for i, _ in enumerate(pio.DataLoader(Stream(), batch_size=1,
                                         num_workers=1)):
        if i == 2:
            break


def test_process_pool_matches_single_process_through_shared_memory():
    """Flowers samples are 110 KB (above the 64 KB shared-memory bar);
    every worker reports its id through get_worker_info."""
    ds = pio.Subset(pds.Flowers(mode="test"), list(range(24)))
    single = list(pio.DataLoader(ds, batch_size=4))
    pool = pio.DataLoader(ds, batch_size=4, num_workers=2,
                          use_multiprocess=True, persistent_workers=True)
    for _ in range(2):  # the persistent pool serves a second epoch
        got = list(pool)
        assert len(got) == len(single)
        for a, b in zip(got, single):
            _same(a, b)
    pool._pool.shutdown()


def test_process_pool_worker_error_reaches_the_consumer():
    ds = pio.Subset(pio.TensorDataset([np.arange(8, dtype=np.int64)]),
                    [0, 1, 2, 3, 99, 5])
    dl = pio.DataLoader(ds, batch_size=2, num_workers=2,
                        use_multiprocess=True)
    with pytest.raises(RuntimeError, match="(?s)worker failed.*IndexError"):
        list(dl)


def test_cursor_skips_consumed_batches():
    ds = pio.TensorDataset([np.arange(20, dtype=np.int64)])
    dl = pio.DataLoader(ds, batch_size=3)
    it = iter(dl)
    first = [next(it)[0].tolist() for _ in range(2)]
    state = dl.state_dict()
    assert state == {"batches_consumed": 2, "epoch": None}
    dl2 = pio.DataLoader(ds, batch_size=3)
    dl2.set_state_dict(state)
    rest = [b[0].tolist() for b in dl2]
    assert first + rest == [list(range(i, min(i + 3, 20)))
                            for i in range(0, 20, 3)]
    # iter_uncounted leaves the cursor to note_consumed
    dl3 = pio.DataLoader(ds, batch_size=3)
    n = sum(1 for _ in dl3.iter_uncounted())
    assert n == 7 and dl3.state_dict()["batches_consumed"] == 0
    dl3.note_consumed(4)
    assert dl3.state_dict()["batches_consumed"] == 4


def test_distributed_sampler_cursor_restores_the_epoch_order():
    ds = list(range(24))

    def loader():
        return pio.DataLoader(ds, batch_sampler=pio.DistributedBatchSampler(
            ds, batch_size=3, num_replicas=2, rank=0, shuffle=True))
    dl = loader()
    list(dl)  # epoch 0
    it = iter(dl)  # epoch 1
    head = [next(it) for _ in range(2)]
    state = dl.state_dict()
    assert state == {"batches_consumed": 2, "epoch": 1}
    resumed = loader()
    resumed.set_state_dict(state)
    tail = list(resumed)
    ref = loader()
    ref.batch_sampler.set_epoch(1)
    expected = list(ref)
    _same(head + tail, expected)


def test_bf16_samples_from_workers_collate_to_bf16():
    """A spawned worker sends a bf16 tensor as its 16-bit words (no
    ml_dtypes, ROADMAP C8); collation gives back the bf16 batch."""
    from paddle_tpu_torch.framework.io_utils import _numpy_from_tensor
    from paddle_tpu_torch.io import default_collate_fn
    samples = [torch.tensor([i + 0.5, -2.25], dtype=torch.bfloat16)
               for i in range(3)]
    got = default_collate_fn([_numpy_from_tensor(s) for s in samples])
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.stack(samples))
