"""Ring attention of the PyTorch/CUDA port on the host, against the JAX
reference's ``ring_attention`` (tests/test_tpu_native.py:36-102).

Ranks are gloo processes running this file as a script (``--worker``):
one spawn of 2 ranks ({"sep": 2}) and one of 4 ({"sep": 4}); the
reference runs in the test process on its 8-device CPU mesh with the
same sep degree. Each rank holds its (B, S/n, H, D) slice of q, k and v
(``split_sequence``), runs the ring forward and backward of
sum(out * out) in f32, causal and not, and writes its slices of the
output and the gradients; the test lays them end to end and holds them
to the reference's at its own gates (forward rtol 2e-5 / atol 2e-6,
grads rtol 5e-4 / atol 5e-6). Also: the split and gather round trip,
the blocks each rank runs and skips, ``compiled=True`` warning, the ring
at degree 1 (the port's scaled_dot_product_attention), and ROADMAP
C-ref-24 (``sep_degree`` in fleet's strategy).
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
SHAPE = (2, 32, 2, 8)                  # tests/test_tpu_native.py:_qkv
FWD = dict(rtol=2e-5, atol=2e-6)       # tests/test_tpu_native.py:54
GRAD = dict(rtol=5e-4, atol=5e-6)      # tests/test_tpu_native.py:81
CAUSAL = (False, True)


def _qkv(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*SHAPE).astype("float32") * 0.5 for _ in range(3)]


# -- the ranks -------------------------------------------------------------

def _worker(world):
    import warnings

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import sequence_parallel as sp
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.ops import attention
    dist.init_parallel_env()
    build_mesh({"sep": world})
    rank = dist.get_rank()
    out = {}
    for causal in CAUSAL:
        sp.reset_stats()
        ts = [sp.split_sequence(torch.tensor(a)).clone().requires_grad_()
              for a in _qkv(int(causal))]
        o = sp.ring_attention(*ts, is_causal=causal)
        (o * o).sum().backward()
        tag = f"c{int(causal)}"
        out[f"{tag}_out"] = o.detach().numpy()
        for name, t in zip("qkv", ts):
            out[f"{tag}_d{name}"] = t.grad.numpy()
        st = sp.stats()
        out[f"{tag}_blocks"] = np.array([st["blocks"],
                                         st["skipped_blocks"],
                                         st["calls"], st["backwards"]])
        out[f"{tag}_p2p_bytes"] = np.array(st["p2p_bytes"])
        out[f"{tag}_gathered"] = sp.gather_sequence(o).detach().numpy()
    x = torch.arange(64, dtype=torch.float32).reshape(2, 16, 2)
    s = sp.split_sequence(x)
    out["split"] = s.numpy()
    out["roundtrip"] = sp.gather_sequence(s).numpy()
    out["block_paths"] = np.array([attention.block_paths["kernel"],
                                   attention.block_paths["math"]])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        q = sp.split_sequence(torch.tensor(_qkv(0)[0]))
        sp.ring_attention(q, q, q, compiled=True)
    out["warned"] = np.array([str(w.message) for w in caught
                              if "eagerly" in str(w.message)][:1])
    np.savez(os.path.join(os.environ["DIST_TMP"], f"rank{rank}.npz"), **out)
    dist.barrier()
    torch.distributed.destroy_process_group()


# -- the test process --------------------------------------------------------

def _spawn(world, tmp, timeout=240):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = {**os.environ, "PADDLE_TRAINER_ID": str(r),
               "PADDLE_TRAINERS_NUM": str(world),
               "PADDLE_COORDINATOR_ADDR": f"localhost:{port}",
               "DIST_TMP": str(tmp), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": REPO}
        procs.append(subprocess.Popen(
            [sys.executable, HERE, "--worker", str(world)], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=timeout)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} exited {p.returncode}:\n{log[-3000:]}"
              for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    assert not failed, "\n".join(failed)
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
            for r in range(world)]


def _reference(sep):
    """The reference's ring output and grads of sum(out * out) on the
    mesh {"sep": sep} (its data axis takes the rest of the 8 devices)."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet.sequence_parallel import \
        ring_attention
    from paddle_tpu.distributed.mesh import build_mesh
    res = {}
    build_mesh({"sep": sep})
    try:
        for causal in CAUSAL:
            ts = [paddle.to_tensor(a) for a in _qkv(int(causal))]
            for t in ts:
                t.stop_gradient = False
            o = ring_attention(*ts, is_causal=causal)
            (o * o).sum().backward()
            res[causal] = [np.asarray(o._val)] + [np.asarray(t.grad._val)
                                                   for t in ts]
    finally:
        build_mesh()
    return res


@pytest.fixture(scope="module", params=[2, 4], ids=["sep2", "sep4"])
def ring(request, tmp_path_factory):
    sep = request.param
    return sep, _spawn(sep, tmp_path_factory.mktemp(f"sep{sep}")), \
        _reference(sep)


def _whole(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=1)


@pytest.mark.parametrize("causal", CAUSAL, ids=["full", "causal"])
def test_forward_matches_the_reference(ring, causal):
    sep, ranks, ref = ring
    np.testing.assert_allclose(_whole(ranks, f"c{int(causal)}_out"),
                               ref[causal][0], **FWD)
    for r in ranks:
        np.testing.assert_allclose(r[f"c{int(causal)}_gathered"],
                                   ref[causal][0], **FWD)


@pytest.mark.parametrize("causal", CAUSAL, ids=["full", "causal"])
def test_grads_match_the_reference(ring, causal):
    sep, ranks, ref = ring
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(
            _whole(ranks, f"c{int(causal)}_d{name}"), ref[causal][1 + i],
            err_msg=f"grad wrt {name}", **GRAD)


@pytest.mark.parametrize("causal", CAUSAL, ids=["full", "causal"])
def test_each_rank_runs_its_blocks_and_skips_the_masked(ring, causal):
    """Rank r runs r + 1 blocks and skips n - 1 - r under is_causal (the
    blocks above the diagonal), n without; K and V go round n - 1 hops
    forward; the backward also carries dK and dV home (n hops)."""
    sep, ranks, _ = ring
    b, s, h, d = SHAPE
    kv = 2 * b * (s // sep) * h * d * 4
    for r, got in enumerate(ranks):
        run = r + 1 if causal else sep
        assert got[f"c{int(causal)}_blocks"].tolist() == \
            [2 * run, 2 * (sep - run), 1, 1]
        assert int(got[f"c{int(causal)}_p2p_bytes"]) == \
            (sep - 1) * kv + (sep - 1) * kv + sep * kv
        # on the host every block is the math block
        assert got["block_paths"][0] == 0


def test_split_and_gather_round_trip(ring):
    sep, ranks, _ = ring
    x = np.arange(64, dtype="float32").reshape(2, 16, 2)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(
            got["split"], x[:, r * 16 // sep:(r + 1) * 16 // sep])
        np.testing.assert_array_equal(got["roundtrip"], x)


def test_compiled_ring_warns_that_it_runs_eagerly(ring):
    for got in ring[1]:
        assert "gloo stages them through the host" in str(got["warned"][0])


@pytest.mark.parametrize("causal", CAUSAL, ids=["full", "causal"])
def test_degree_one_is_scaled_dot_product_attention(causal):
    """No sep axis (world size 1): the port's SDPA, as the reference's
    ring gives its own SDPA, and both the reference's dense oracle."""
    import paddle_tpu as paddle
    from paddle_tpu.ops.attention import scaled_dot_product_attention as rs
    from paddle_tpu_torch.distributed.fleet.sequence_parallel import (
        gather_sequence, ring_attention, split_sequence)
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.ops.attention import scaled_dot_product_attention
    build_mesh()
    q, k, v = (torch.tensor(a) for a in _qkv(3))
    got = ring_attention(q, k, v, is_causal=causal)
    assert torch.equal(got, scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    want = rs(*(paddle.to_tensor(a) for a in _qkv(3)), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._val), **FWD)
    assert split_sequence(q) is q and gather_sequence(q) is q


def test_c_ref_24_sep_degree_builds_no_sep_axis():
    """ROADMAP C-ref-24: the reference's fleet.init stores sep_degree and
    builds no sep axis from it; the port's raises, naming the mesh call
    that does lay out the sequence-parallel ranks."""
    from paddle_tpu.distributed import fleet as rfleet
    from paddle_tpu.distributed.mesh import build_mesh as ref_build
    from paddle_tpu_torch.distributed import env, mesh
    from paddle_tpu_torch.distributed.fleet import base as pbase
    strategy = rfleet.DistributedStrategy()
    strategy.hybrid_configs["sep_degree"] = 2
    try:
        f = rfleet.base.Fleet()
        f.init(strategy=strategy)
        assert f._strategy.hybrid_configs["sep_degree"] == 2
        assert "sep" not in f.get_hybrid_communicate_group().mesh.axis_names
    finally:
        ref_build()
    ps = pbase.DistributedStrategy()
    ps.hybrid_configs["sep_degree"] = 2
    saved = dict(env._STATE), dict(mesh._STATE)
    try:
        with pytest.raises(NotImplementedError,
                           match=r"C-ref-24.*build_mesh\(\{'sep': 2\}\)"):
            pbase.Fleet().init(strategy=ps)
    finally:
        env._STATE.update(saved[0])
        mesh._STATE.update(saved[1])


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[2]))
