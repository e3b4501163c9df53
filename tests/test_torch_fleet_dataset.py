"""fleet's datasets of the PyTorch/CUDA port against the JAX reference
(the dataset cases of the reference's tests/test_trainer.py): the same
samples through both packages' ``InMemoryDataset`` and ``QueueDataset``
give the same batches, worker shards, shuffles and passes."""
import threading

import numpy as np
import pytest

import paddle_tpu.distributed as rdist

import paddle_tpu_torch.distributed as pdist

PKGS = {"ref": rdist, "port": pdist}


def _samples(n=20):
    return [(np.full(3, i, "f4"), np.int64(i % 2)) for i in range(n)]


def _as_lists(batches):
    return [{k: v.tolist() for k, v in b.items()} for b in batches]


def _both(fn):
    out = {name: fn(mod) for name, mod in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def test_the_packages_export_the_datasets():
    from paddle_tpu_torch.distributed.fleet import dataset
    assert pdist.InMemoryDataset is dataset.InMemoryDataset
    assert pdist.QueueDataset is dataset.QueueDataset


@pytest.mark.parametrize("drop_last", [True, False])
def test_inmemory_batches_and_worker_shards(drop_last):
    def run(mod):
        ds = mod.InMemoryDataset()
        ds.set_batch_size(3)
        ds.set_use_var(["x", "y"])
        ds._drop_last = drop_last
        ds.set_sample_list(_samples())
        whole = list(ds.batches(0, 1))
        shards = [list(ds.batches(w, 2)) for w in range(2)]
        return {"whole": _as_lists(whole),
                "shards": [_as_lists(s) for s in shards],
                "shapes": [(b["x"].shape, b["y"].shape, str(b["x"].dtype))
                           for b in whole]}
    got = _both(run)
    assert len(got["whole"]) == (6 if drop_last else 7)
    assert got["shapes"][0] == ((3, 3), (3,), "float32")
    seen = sorted(b["x"][0][0] for s in got["shards"] for b in s)
    assert seen == sorted(b["x"][0][0] for b in got["whole"])


def test_load_into_memory_shuffles_and_release():
    def run(mod):
        ds = mod.InMemoryDataset()
        ds.set_use_var(["x"])
        ds.load_into_memory(lambda: ((np.float32(i),) for i in range(10)))
        size = ds.get_memory_data_size()
        ds.local_shuffle(seed=3)
        local = [float(s[0]) for s in ds._data]
        ds.global_shuffle()
        glob = [float(s[0]) for s in ds._data]
        ds.release_memory()
        return size, local, glob, ds.get_memory_data_size()
    size, local, glob, after = _both(run)
    assert size == 10 and after == 0
    assert sorted(local) == list(range(10)) and local != list(range(10))
    assert sorted(glob) == list(range(10))


def test_queue_dataset_streams_its_readers_once():
    def run(mod):
        ds = mod.QueueDataset()
        ds.set_batch_size(2)
        ds.set_use_var(["x"])
        ds.set_filelist([
            lambda: ((np.float32(i),) for i in range(4)),
            lambda: ((np.float32(10 + i),) for i in range(4)),
        ])
        return [b["x"].tolist() for b in ds.batches()]
    assert _both(run) == [[0.0, 1.0], [2.0, 3.0], [10.0, 11.0],
                          [12.0, 13.0]]


def test_queue_dataset_threads_share_one_pass():
    """Workers in threads take batches first come first served from one
    stream: together they see every batch once, and a second pass over a
    closed stream yields nothing."""
    def run(mod):
        ds = mod.QueueDataset()
        ds.set_batch_size(2)
        ds.set_use_var(["x"])
        ds.set_filelist([lambda: ((np.float32(i),) for i in range(16))])
        ds._begin_pass(3)
        got = [[] for _ in range(3)]

        def worker(w):
            for b in ds.batches(w, 3):
                got[w].append(b["x"].tolist())
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        again = list(ds.batches(0, 3))
        ds._end_pass()
        return sorted(b for g in got for b in g), again
    batches, again = _both(run)
    assert batches == [[2.0 * i, 2.0 * i + 1] for i in range(8)]
    assert again == []


def test_use_var_is_required():
    for mod in PKGS.values():
        ds = mod.InMemoryDataset()
        ds.set_sample_list(_samples(4))
        with pytest.raises(ValueError, match="set_use_var"):
            list(ds.batches())
