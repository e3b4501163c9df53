"""incubate.MoELayer and the expert-parallel exchange of the PyTorch/CUDA
port on the host, against the JAX reference (paddle_tpu/incubate/moe.py,
paddle_tpu/distributed/utils.py).

The reference's weights cross by name. At world size 1 the port's layer
is held to the reference's in f32 (relative L2 1e-5: forward, every
parameter's gradient and the input's; the aux loss to 1e-6) at top_k 1
and 2, with capacities that drop tokens in every round. Two gloo ranks
on {"ep": 2} (this file run as a script, ``--worker``), each with half
the batch and 2 of the 4 experts, under DataParallel, are held to the
reference's serial layer on the whole batch: the output, the dropped
tokens, the aux loss, the first step's gradients (the gate's averaged by
the Reducer, each expert slice the owner's) and three SGD steps' losses.
A capacity or a queue order taken per rank, or expert gradients summed
over the ranks, fail it. ``global_scatter``/``global_gather`` at one rank
are the reference's identity after the count check; at two ranks they
are held to the exchange's numpy definition (ROADMAP C-ref-26).
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
D, H, E = 16, 32, 4
RTOL = 1e-5
AUX_TOL = 1e-6
EP_STEPS, EP_LR = 3, 0.1
EP_CASES = ((2, 0.5), (1, 0.75))   # (top_k, capacity_factor): both drop


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _arrays():
    import paddle_tpu as paddle
    paddle.seed(0)
    moe = paddle.incubate.MoELayer(D, H, E)
    return {k: np.asarray(v._val) for k, v in moe.state_dict().items()}


def _batch(rows=4, seq=6, seed=1):
    return np.random.RandomState(seed).randn(rows, seq, D).astype("float32")


def _expected_dropped(arrays, x, k, cf):
    """Tokens over capacity in each round, from the reference's gate: the
    count the layer must report (numpy definition)."""
    xf = x.reshape(-1, D).astype(np.float64)
    logits = xf @ arrays["gate.weight"].astype(np.float64)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    order = np.argsort(-probs, axis=1, kind="stable")
    cap = max(1, int(k * len(xf) / E * cf))
    return [int(np.maximum(np.bincount(order[:, r], minlength=E) - cap,
                           0).sum()) for r in range(k)]


def _reference(arrays, x, k, cf, steps=1):
    """The reference's serial layer: outputs, aux loss, the first step's
    grads (and the input's), and the losses of ``steps`` SGD steps on
    (out**2).mean() + 0.1 * aux."""
    import paddle_tpu as paddle
    moe = paddle.incubate.MoELayer(D, H, E, top_k=k, capacity_factor=cf)
    moe.set_state_dict({n: paddle.to_tensor(v) for n, v in arrays.items()})
    opt = paddle.optimizer.SGD(learning_rate=EP_LR,
                               parameters=moe.parameters())
    out = {"losses": []}
    for i in range(steps):
        xt = paddle.to_tensor(x)
        xt.stop_gradient = False
        y = moe(xt)
        loss = (y * y).mean() + 0.1 * moe.aux_loss
        loss.backward()
        if i == 0:
            out["out"] = np.asarray(y._val)
            out["aux"] = float(moe.aux_loss.item())
            out["grads"] = {n: np.asarray(p.grad._val)
                            for n, p in moe.named_parameters()}
            out["x_grad"] = np.asarray(xt.grad._val)
        out["losses"].append(float(loss.item()))
        opt.step()
        opt.clear_grad()
    return out


def _port(arrays, x, k, cf, expert_axis=None):
    import paddle_tpu_torch as pt
    moe = pt.incubate.MoELayer(D, H, E, top_k=k, capacity_factor=cf,
                               expert_axis=expert_axis, device="cpu")
    pt.load_numpy_state_dict(moe, arrays)
    xt = torch.tensor(x, requires_grad=True)
    y = moe(xt)
    loss = (y * y).mean() + 0.1 * moe.aux_loss
    loss.backward()
    return moe, y, xt


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


# -- world size 1 -------------------------------------------------------------

@pytest.mark.parametrize("k, cf", [(1, 0.5), (2, 0.5), (2, 0.25)])
def test_moe_matches_reference_in_f32(arrays, k, cf):
    x = _batch()
    ref = _reference(arrays, x, k, cf)
    moe, y, xt = _port(arrays, x, k, cf)
    dropped = _expected_dropped(arrays, x, k, cf)
    assert all(d > 0 for d in dropped), dropped
    assert moe.dropped_tokens.tolist() == dropped
    assert _rel(y.detach().numpy(), ref["out"]) <= RTOL
    assert abs(moe.aux_loss.item() - ref["aux"]) <= AUX_TOL
    for name, p in moe.named_parameters():
        assert _rel(p.grad.numpy(), ref["grads"][name]) <= RTOL, name
    assert _rel(xt.grad.numpy(), ref["x_grad"]) <= RTOL


def test_capacity_floors_as_the_reference_does(arrays):
    """ROADMAP C-ref-25 (mirrored): capacity = max(1, int(k·N/E·cf)), a
    floor where the reference's docstring says ceil. 24 tokens, k 1, cf
    0.3: 1.8 -> 1 slot an expert."""
    x = _batch(rows=4)
    moe, _, _ = _port(arrays, x, 1, 0.3)
    total = np.bincount(np.argmax(
        x.reshape(-1, D) @ arrays["gate.weight"], 1), minlength=E)
    assert moe.dropped_tokens.tolist() == [int(np.maximum(total - 1,
                                                          0).sum())]


def test_dispatch_and_combine_match_the_reference():
    """The index scatter and gather hold what the reference's one-hot
    einsums hold: the buffer, each token's slot and the kept mask."""
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.distributed import utils as ref_utils
    from paddle_tpu_torch.distributed import utils
    rng = np.random.RandomState(3)
    x = rng.randn(20, D).astype("float32")
    idx = rng.randint(0, E, 20).astype("int32")
    cap = 3
    rb, rc, rk = ref_utils.dispatch_tokens(paddle.to_tensor(x),
                                           paddle.to_tensor(idx), E, cap)
    buf, slots, keep = utils.dispatch_tokens(torch.tensor(x),
                                             torch.tensor(idx), E, cap)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(rb._val))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rk._val))
    onehot = np.asarray(rc._val).reshape(20, E * cap)
    want = np.where(onehot.any(1), onehot.argmax(1), -1)
    np.testing.assert_array_equal(slots.numpy(), want)
    eo = rng.randn(E, cap, D).astype("float32")
    got = utils.combine_tokens(torch.tensor(eo), slots)
    ref = ref_utils.combine_tokens(paddle.to_tensor(eo), rc)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.asarray(
        ref._val)), rtol=1e-6, atol=1e-6)


def test_gate_noise_is_seeded_perturbs_training_and_is_off_in_eval(arrays):
    """tests/test_incubate.py:56-90's properties on the port (JAX's and
    torch's draws never match)."""
    import paddle_tpu_torch as pt
    moe = pt.incubate.MoELayer(D, H, E, top_k=1, capacity_factor=0.5,
                               gate_noise=4.0, device="cpu")
    pt.load_numpy_state_dict(moe, arrays)
    x = torch.tensor(_batch(rows=8, seed=3))
    with torch.no_grad():
        pt.seed(42)
        a, b = moe(x), moe(x)
        assert not torch.allclose(a, b)
        pt.seed(42)
        assert torch.equal(a, moe(x))
        moe.eval()
        e1, e2 = moe(x), moe(x)
        assert torch.equal(e1, e2)
        moe.gate_noise = 0.0
        moe.train()
        assert torch.equal(e1, moe(x))
    with pytest.raises(Exception, match="gate_noise"):
        pt.incubate.MoELayer(D, H, E, gate_noise=-0.1, device="cpu")


def test_expert_axis_without_a_mesh_axis_runs_whole_at_one_rank(arrays):
    """ROADMAP C-ref-25: at world size 1 an expert_axis the mesh lacks
    runs the experts whole, as the reference's caught constraint does."""
    x = _batch()
    _, want, _ = _port(arrays, x, 2, 0.5)
    moe, got, _ = _port(arrays, x, 2, 0.5, expert_axis="ep")
    assert moe.w1.shape[0] == E
    assert torch.equal(got, want)


def test_global_scatter_gather_at_one_rank_are_the_identity():
    from paddle_tpu_torch.distributed.utils import (global_gather,
                                                    global_scatter)
    x = torch.tensor(np.random.RandomState(0).randn(10, 4).astype("f"))
    counts = torch.tensor([3, 2, 5])
    s = global_scatter(x, counts, counts)
    assert torch.equal(global_gather(s, counts, counts), x)
    with pytest.raises(ValueError, match="local_count"):
        global_scatter(x, torch.tensor([3, 2]), counts)


# -- two ranks on {"ep": 2} ---------------------------------------------------

def _scatter_numpy(xs, locals_, n, n_expert):
    """global_scatter_op.cc's definition: what rank ``me`` receives."""
    out = []
    for me in range(n):
        parts = []
        for i in range(n_expert):
            for j in range(n):
                idx = me * n_expert + i
                start = sum(locals_[j][:idx])
                parts.append(xs[j][start:start + locals_[j][idx]])
        out.append(np.concatenate(parts))
    return out


def _worker():
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import utils
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.framework.io_utils import full_state_dict
    dist.init_parallel_env()
    tmp = os.environ["DIST_TMP"]
    rank, n = dist.get_rank(), dist.get_world_size()
    data = dict(np.load(os.path.join(tmp, "moe.npz")))
    arrays = {k[2:]: v for k, v in data.items() if k.startswith("a.")}
    x = data["x"]
    out = {}
    try:
        pt.incubate.MoELayer(D, H, E, expert_axis="ep", device="cpu")
    except ValueError as err:
        out["no_axis_error"] = np.array(str(err))
    build_mesh({"ep": n})
    half = len(x) // n
    for k, cf in EP_CASES:
        tag = f"k{k}"
        moe = pt.incubate.MoELayer(D, H, E, top_k=k, capacity_factor=cf,
                                   expert_axis="ep", device="cpu")
        pt.load_numpy_state_dict(moe, arrays)
        out[f"{tag}.w1_rows"] = np.array(moe.w1.shape[0])
        net = pt.DataParallel(moe)
        opt = pt.optimizer.SGD(learning_rate=EP_LR,
                               parameters=moe.parameters())
        # an input that wants its gradient, as a layer's output does: the
        # dispatch's backward exchange runs too
        mine = torch.tensor(x[rank * half:(rank + 1) * half],
                            requires_grad=True)
        losses = []
        utils.reset_exchange_stats()
        for i in range(EP_STEPS):
            y = net(mine)
            loss = (y * y).mean() + 0.1 * moe.aux_loss
            loss.backward()
            if i == 0:
                out[f"{tag}.out"] = y.detach().numpy()
                out[f"{tag}.aux"] = np.array(float(moe.aux_loss))
                out[f"{tag}.dropped"] = moe.dropped_tokens.numpy()
                for name, p in moe.named_parameters():
                    out[f"{tag}.grad.{name}"] = p.grad.numpy().copy()
                out[f"{tag}.stats"] = np.array(
                    [utils.exchange_stats()["exchanges"],
                     utils.exchange_stats()["bytes"]])
            losses.append(dist.all_reduce(loss.detach().clone(),
                                          op=dist.ReduceOp.AVG).item())
            opt.step()
            opt.clear_grad()
        out[f"{tag}.losses"] = np.array(losses)
        for name, v in full_state_dict(moe).items():
            out[f"{tag}.final.{name}"] = v.numpy()
    # upstream's variable-count exchange, at n ranks, 2 experts a rank
    rng = np.random.RandomState(10 + rank)
    local = rng.randint(0, 4, 2 * n)
    xs = rng.randn(int(local.sum()), 3).astype("float32")
    glob = dist.all_gather([], torch.tensor(local))
    glob = np.stack([g.numpy() for g in glob])[:, [rank * 2, rank * 2 + 1]]
    glob = glob.reshape(-1)   # [source rank][my local expert]
    xt = torch.tensor(xs, requires_grad=True)
    s = utils.global_scatter(xt, torch.tensor(local), torch.tensor(glob))
    back = utils.global_gather(s, torch.tensor(local), torch.tensor(glob))
    (s * torch.arange(1, s.shape[0] + 1.0)[:, None]).sum().backward()
    out.update({"gs.x": xs, "gs.local": local, "gs.out": s.detach().numpy(),
                "gs.back": back.detach().numpy(),
                "gs.x_grad": xt.grad.numpy()})
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    dist.barrier()
    torch.distributed.destroy_process_group()


def _spawn(world, tmp, timeout=120):
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
            [sys.executable, HERE, "--worker"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
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


@pytest.fixture(scope="module")
def ep(arrays, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    x = _batch(rows=4)
    np.savez(os.path.join(tmp, "moe.npz"), x=x,
             **{f"a.{k}": v for k, v in arrays.items()})
    ranks = _spawn(2, tmp)
    refs = {k: _reference(arrays, x, k, cf, steps=EP_STEPS)
            for k, cf in EP_CASES}
    return {"ranks": ranks, "refs": refs, "x": x}


@pytest.mark.parametrize("k, cf", EP_CASES, ids=["top2", "top1"])
def test_ep_ranks_compute_the_serial_layer(ep, arrays, k, cf):
    ranks, ref, tag = ep["ranks"], ep["refs"][k], f"k{k}"
    out = np.concatenate([r[f"{tag}.out"] for r in ranks])
    assert _rel(out, ref["out"]) <= RTOL
    want = _expected_dropped(arrays, ep["x"], k, cf)
    assert all(d > 0 for d in want), want
    for r in ranks:
        assert r[f"{tag}.dropped"].tolist() == want
        assert abs(float(r[f"{tag}.aux"]) - ref["aux"]) <= AUX_TOL
        assert int(r[f"{tag}.w1_rows"]) == E // 2


@pytest.mark.parametrize("k, cf", EP_CASES, ids=["top2", "top1"])
def test_ep_first_step_gradients_are_the_serial_layers(ep, k, cf):
    """The gate's (the Reducer's mean) on every rank, and each rank's
    expert slices (the owner's, scaled to the ranks' mean loss), against
    the serial layer's on the whole batch."""
    ref, tag = ep["refs"][k], f"k{k}"
    for r, got in enumerate(ep["ranks"]):
        assert _rel(got[f"{tag}.grad.gate.weight"],
                    ref["grads"]["gate.weight"]) <= RTOL
        for name in ("w1", "b1", "w2", "b2"):
            want = np.split(ref["grads"][name], 2)[r]
            assert _rel(got[f"{tag}.grad.{name}"], want) <= RTOL, name


@pytest.mark.parametrize("k, cf", EP_CASES, ids=["top2", "top1"])
def test_ep_sgd_steps_track_the_serial_layer(ep, k, cf):
    ref, tag = ep["refs"][k], f"k{k}"
    for got in ep["ranks"]:
        np.testing.assert_allclose(got[f"{tag}.losses"], ref["losses"],
                                   rtol=RTOL, atol=1e-7)
    for name in ("gate.weight", "w1", "b2"):
        np.testing.assert_array_equal(ep["ranks"][0][f"{tag}.final.{name}"],
                                      ep["ranks"][1][f"{tag}.final.{name}"])


def test_ep_exchange_bytes_are_the_capacity_blocks(ep):
    """The first forward and backward: k rounds x (dispatch, combine) x
    (forward, backward) all-to-alls, each of (2 ranks x 2 experts x C x
    d) f32."""
    for k, cf in EP_CASES:
        cap = max(1, int(k * 24 / E * cf))
        count, nbytes = ep["ranks"][0][f"k{k}.stats"].tolist()
        assert count == 4 * k
        assert nbytes == 4 * k * (2 * (E // 2) * cap * D * 4)


def test_ep_expert_axis_the_mesh_lacks_raises(ep):
    """ROADMAP C-ref-25 (raised): at world size 2 an expert_axis that is
    not a mesh axis names the axis."""
    for r in ep["ranks"]:
        assert "'ep'" in str(r["no_axis_error"])
        assert "C-ref-25" in str(r["no_axis_error"])


def test_global_scatter_and_gather_at_two_ranks_match_their_definition(ep):
    """ROADMAP C-ref-26: the exchange of global_scatter_op.cc (the
    reference returns its input), its inverse, and scatter's gradient is
    gather of the output's."""
    ranks = ep["ranks"]
    xs = [r["gs.x"] for r in ranks]
    locals_ = [r["gs.local"].tolist() for r in ranks]
    want = _scatter_numpy(xs, locals_, 2, 2)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["gs.out"], want[r])
        np.testing.assert_array_equal(got["gs.back"], xs[r])
    # d/dx of sum(s * row number): each row's weight travels back home
    weights = [np.repeat(np.arange(1, len(w) + 1.0)[:, None], 3, 1)
               for w in want]
    for r, got in enumerate(ranks):
        # each of rank r's rows gets its row number on the receiver
        grad = np.zeros_like(xs[r])
        for me in range(2):
            row = 0
            for i in range(2):
                for j in range(2):
                    idx = me * 2 + i
                    cnt = locals_[j][idx]
                    if j == r:
                        start = sum(locals_[r][:idx])
                        grad[start:start + cnt] = weights[me][row:row + cnt]
                    row += cnt
        np.testing.assert_array_equal(got["gs.x_grad"], grad)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker()
