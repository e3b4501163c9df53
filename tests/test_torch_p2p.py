"""The port's p2p channel, its abort broadcast and the process group's
deadline, over real rank processes (this file run as ``--worker``):

- three ranks: ``send_obj``/``recv_obj`` and ``send_array``/
  ``recv_array`` round trips (a bf16 tensor included), every ``group_*``
  collective over a subset of the ranks against numpy, the other rank
  left alone, float16 and bf16 inputs reduced in their own dtype (ROADMAP
  C10); ``fleet.metrics`` over the ranks' statistics against numpy
  on their sum;
- the abort: rank 1 fails inside an ``all_reduce`` through an injected
  fault while ranks 0 and 2 wait in the same ``all_reduce``. Gloo has no
  abort call, so rank 1 broadcasts the abort on the p2p channel and then
  leaves its process group; the blocked ranks fail at once and raise the
  ``PeerAbort`` naming rank 1 and ``collective.all_reduce``, in seconds,
  well inside ``FLAGS_collective_timeout`` (60 s here);
- the deadline (the repaired ``init_parallel_env``): two ranks with
  ``FLAGS_collective_timeout=5``; rank 1 never enters the ``all_reduce``
  rank 0 waits in, which raises ``DistributedTimeout`` naming
  ``collective.all_reduce`` in under 30 s (gloo alone would wait 30
  minutes), and rank 1 hears rank 0's abort.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


def _arr(rank, shape=(2, 3)):
    return (np.arange(np.prod(shape), dtype="float32").reshape(shape)
            + 10.0 * rank)


def _channel_checks(rank, out):
    from paddle_tpu_torch.distributed import p2p
    p2p.connect()
    if rank == 0:
        p2p.send_obj({"k": [1, "two", (3.0, None)], "a": _arr(0)}, 1)
        p2p.send_array(torch.tensor([1.5, -2.25], dtype=torch.bfloat16), 2)
        out["echo"] = p2p.recv_obj(1, tag="echo").tolist()
    elif rank == 1:
        got = p2p.recv_obj(0)
        out["got_obj"] = {"k": got["k"], "a": got["a"].tolist()}
        p2p.send_obj(got["a"] * 2, 0, tag="echo")
    else:
        t = p2p.recv_array(0)
        out["got_bf16"] = [str(t.dtype), t.float().tolist()]
    sub = [0, 2]
    if rank in sub:
        # ROADMAP C10: float16 stays float16; bf16 comes back as bf16
        h = torch.from_numpy(_half(rank))
        r16 = p2p.group_all_reduce(h, sub)
        b = h.to(torch.bfloat16)
        rb = p2p.group_all_reduce(b, sub)
        gb = p2p.group_all_gather(b, sub)
        out["half"] = {"f16": [str(r16.dtype), r16.tolist()],
                       "bf16": [str(rb.dtype), rb.float().tolist()],
                       "bf16_gather": [str(gb.dtype), gb.float().tolist()],
                       "f16_max": p2p.group_all_reduce(h, sub, op="max"
                                                       ).tolist()}
        out["ar_sum"] = p2p.group_all_reduce(_arr(rank), sub).tolist()
        out["ar_max"] = p2p.group_all_reduce(
            torch.from_numpy(_arr(rank)), sub, op="max").tolist()
        out["bc"] = p2p.group_broadcast(_arr(rank), sub, src=2).tolist()
    both = [0, 1]
    if rank in both:
        out["rs"] = p2p.group_reduce_scatter(_arr(rank, (4, 2)), both
                                             ).tolist()
    world = [0, 1, 2]
    out["ag"] = p2p.group_all_gather(_arr(rank), world).tolist()
    out["a2a"] = p2p.group_alltoall(
        np.stack([np.full(2, 10 * rank + j, "float32") for j in world]),
        world).tolist()
    p2p.group_barrier(world)


def _half(rank):
    return (np.array([[1.5, -2.25, 3.0], [1e-3, 7.0, -0.3]])
            * (rank + 1.7)).astype("float16")


def _stats(rank):
    rng = np.random.RandomState(40 + rank)
    return {"pos": rng.randint(0, 9, 16).astype("float64"),
            "neg": rng.randint(0, 9, 16).astype("float64"),
            "err": rng.rand(3), "n": np.array([5.0 + rank]),
            "correct": np.array([3.0 + rank]), "v": rng.randn(4)}


def _metrics(rank, out):
    from paddle_tpu_torch.distributed.fleet import metrics
    s = _stats(rank)
    out["metrics"] = {
        "auc": metrics.auc(torch.from_numpy(s["pos"]), s["neg"]),
        "acc": metrics.acc(s["correct"], s["n"]),
        "rmse": metrics.rmse(s["err"], s["n"]),
        "mae": metrics.mae(s["err"], s["n"]),
        "mse": metrics.mse(s["err"], s["n"]),
        "sum": metrics.sum(s["v"]).tolist(),
        "max": metrics.max(s["v"]).tolist(),
        "min": metrics.min(s["v"]).tolist()}


def _abort_case(rank, out):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.resilience import faults
    t = torch.ones(4)
    if rank == 1:
        time.sleep(1.0)  # blocking-ok: the others wait in the all_reduce by now
        faults.configure("collective.all_reduce:#1")
    t0 = time.monotonic()
    try:
        dist.all_reduce(t)
        out["abort"] = {"raised": None}
    except BaseException as e:  # noqa: BLE001 - reported to the test
        out["abort"] = {"raised": type(e).__name__, "message": str(e),
                        "src": getattr(e, "src", None),
                        "section": getattr(e, "section", None),
                        "seconds": time.monotonic() - t0,
                        "initialized": dist.is_initialized()}


def _deadline_case(rank, out):
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import p2p
    p2p.connect()
    dist.barrier()
    if rank == 0:
        t0 = time.monotonic()
        try:
            dist.all_reduce(torch.ones(4))
            out["deadline"] = {"raised": None}
        except BaseException as e:  # noqa: BLE001 - reported to the test
            out["deadline"] = {"raised": type(e).__name__,
                               "section": getattr(e, "section", None),
                               "timeout": getattr(e, "timeout", None),
                               "message": str(e),
                               "seconds": time.monotonic() - t0}
    else:
        # never enters: waits for rank 0's abort instead
        peer = p2p.peer_abort(wait=60.0)
        out["deadline"] = {"heard": None if peer is None else
                           [peer.src, peer.section]}


def _worker(mode):
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()
    rank = dist.get_rank()
    out = {"rank": rank}
    if mode == "channel":
        _channel_checks(rank, out)
        _metrics(rank, out)
        _abort_case(rank, out)
    else:
        _deadline_case(rank, out)
    with open(os.path.join(os.environ["DIST_TMP"], f"{mode}{rank}.json"),
              "w") as f:
        json.dump(out, f)


def _free_ports(n):
    from paddle_tpu_torch.distributed.launch_utils import find_free_ports
    return find_free_ports(n)


def _start(mode, world, tmp, flags):
    ports = _free_ports(world + 1)
    eps = ",".join(f"127.0.0.1:{p}" for p in ports[1:])
    procs = []
    for r in range(world):
        env = {**os.environ, "PADDLE_TRAINER_ID": str(r),
               "PADDLE_TRAINERS_NUM": str(world),
               "PADDLE_COORDINATOR_ADDR": f"127.0.0.1:{ports[0]}",
               "PADDLE_TPU_P2P_ENDPOINTS": eps, "DIST_TMP": str(tmp),
               "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO,
               "PADDLE_TPU_ARTIFACTS_DIR": str(tmp / "artifacts"), **flags}
        procs.append(subprocess.Popen(
            [sys.executable, HERE, "--worker", mode], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def _join(procs, mode, tmp, timeout=180):
    try:
        logs = [p.communicate(timeout=timeout)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{mode} rank {r} exited " \
                                  f"{p.returncode}:\n{log[-3000:]}"
    out = []
    for r in range(len(procs)):
        with open(tmp / f"{mode}{r}.json") as f:
            out.append(json.load(f))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("p2p")
    chan = _start("channel", 3, tmp, {"FLAGS_collective_timeout": "60"})
    dead = _start("deadline", 2, tmp, {"FLAGS_collective_timeout": "5"})
    return _join(chan, "channel", tmp), _join(dead, "deadline", tmp)


def test_send_and_recv_round_trips(ranks):
    chan, _ = ranks
    assert chan[1]["got_obj"] == {"k": [1, "two", [3.0, None]],
                                  "a": _arr(0).tolist()}
    assert chan[0]["echo"] == (2 * _arr(0)).tolist()
    assert chan[2]["got_bf16"] == ["torch.bfloat16", [1.5, -2.25]]


def test_group_collectives_over_subsets_match_numpy(ranks):
    chan, _ = ranks
    sub = [_arr(0), _arr(2)]
    for r in (0, 2):
        assert chan[r]["ar_sum"] == (sub[0] + sub[1]).tolist()
        assert chan[r]["ar_max"] == np.maximum(*sub).tolist()
        assert chan[r]["bc"] == _arr(2).tolist()
    assert "ar_sum" not in chan[1] and "rs" not in chan[2]
    red = _arr(0, (4, 2)) + _arr(1, (4, 2))
    assert chan[0]["rs"] == red[:2].tolist()
    assert chan[1]["rs"] == red[2:].tolist()
    for r in range(3):
        assert chan[r]["ag"] == np.stack([_arr(i) for i in range(3)]
                                         ).tolist()
        assert chan[r]["a2a"] == [[10.0 * j + r] * 2 for j in range(3)]


def test_group_collectives_keep_half_precision(ranks):
    """ROADMAP C10: a float16 input's group_all_reduce returns float16 (it
    returned float32); a bf16 input's returns a bf16 tensor, as the
    reference returns an ml_dtypes bfloat16 array: both equal the
    reference's reduction over ranks 0 and 2."""
    import ml_dtypes

    from paddle_tpu.distributed.p2p import _REDUCE_NP
    chan, _ = ranks
    f16 = [_half(0), _half(2)]
    bf16 = [a.astype(ml_dtypes.bfloat16) for a in f16]
    want16 = _REDUCE_NP["sum"](np.stack(f16)).astype(np.float16)
    wantb = _REDUCE_NP["sum"](np.stack(bf16)).astype(ml_dtypes.bfloat16)
    for r in (0, 2):
        half = chan[r]["half"]
        assert half["f16"] == ["float16", want16.tolist()]
        assert half["f16_max"] == np.maximum(*f16).tolist()
        assert half["bf16"] == ["torch.bfloat16",
                                wantb.astype(np.float32).tolist()]
        assert half["bf16_gather"] == [
            "torch.bfloat16", np.stack(bf16).astype(np.float32).tolist()]


def _np_metrics(stats):
    """The metrics from numpy on the ranks' summed statistics (the
    reference's formulas)."""
    tot = {k: sum(s[k] for s in stats) for k in stats[0]}
    pos, neg = tot["pos"], tot["neg"]
    tp = tn = area = 0.0
    for i in range(len(pos) - 1, -1, -1):
        area += neg[i] * (2 * tp + pos[i]) / 2.0
        tp, tn = tp + pos[i], tn + neg[i]
    mse = tot["err"].sum() / tot["n"].sum()
    return {"auc": area / (tp * tn), "acc": tot["correct"].sum()
            / tot["n"].sum(), "rmse": np.sqrt(mse),
            "mae": mse, "mse": mse, "sum": tot["v"],
            "max": np.max([s["v"] for s in stats], axis=0),
            "min": np.min([s["v"] for s in stats], axis=0)}


def test_fleet_metrics_over_ranks_match_numpy_on_their_sums(ranks):
    chan, _ = ranks
    want = _np_metrics([_stats(r) for r in range(3)])
    for r in range(3):
        got = chan[r]["metrics"]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)


@pytest.mark.parametrize("name", ["sum", "max", "min", "auc", "mae", "rmse",
                                  "mse", "acc"])
def test_fleet_metrics_at_world_size_one_equal_the_reference(name):
    import paddle_tpu.distributed.fleet.metrics as ref
    from paddle_tpu_torch.distributed.fleet import metrics
    s = _stats(0)
    args = {"auc": (s["pos"], s["neg"]), "acc": (s["correct"], s["n"]),
            "sum": (s["v"],), "max": (s["v"],), "min": (s["v"],)}.get(
                name, (s["err"], s["n"]))
    want = getattr(ref, name)(*args)
    got = getattr(metrics, name)(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got, want)


def test_a_failed_rank_aborts_its_blocked_peers_in_seconds(ranks):
    chan, _ = ranks
    assert chan[1]["abort"]["raised"] == "FaultInjected"
    for r in (0, 2):
        a = chan[r]["abort"]
        assert a["raised"] == "PeerAbort", a
        assert a["src"] == 1 and a["section"] == "collective.all_reduce"
        # rank 1 failed a second in; its peers within seconds of that,
        # far inside the group's 60 s deadline
        assert a["seconds"] < 10, a
    for r in range(3):
        assert chan[r]["abort"]["initialized"] is False  # torn down


def test_the_group_deadline_is_the_flag(ranks):
    _, dead = ranks
    d = dead[0]["deadline"]
    assert d["raised"] == "DistributedTimeout", d
    assert d["section"] == "collective.all_reduce" and d["timeout"] == 5.0
    assert "collective.all_reduce" in d["message"]
    assert 4.0 <= d["seconds"] < 30, d
    assert dead[1]["deadline"]["heard"] == [0, "collective.all_reduce"]


def test_init_parallel_env_passes_the_flag_as_the_group_timeout(monkeypatch):
    import datetime

    import torch.distributed as tdist

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import env
    seen = {}
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda *a, **kw: seen.update(kw))
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    monkeypatch.setattr("paddle_tpu_torch.distributed.mesh.build_mesh",
                        lambda *a, **kw: None)
    monkeypatch.setattr(
        "paddle_tpu_torch.resilience.recorder.install_signal_dump",
        lambda: None)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_COORDINATOR_ADDR", "127.0.0.1:1")
    state = dict(env._STATE)
    before = pt.get_flags("FLAGS_collective_timeout")
    try:
        pt.set_flags({"FLAGS_collective_timeout": 7.0})
        env._STATE.update(initialized=False, rendezvous=None)
        env.init_parallel_env()
    finally:
        pt.set_flags(before)
        env._STATE.clear()
        env._STATE.update(state)
    assert seen["timeout"] == datetime.timedelta(seconds=7.0)
    assert seen["init_method"] == "tcp://127.0.0.1:1"
    assert seen["rank"] == 1 and seen["world_size"] == 2


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(sys.argv[2])
