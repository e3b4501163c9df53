"""The SPMD circular pipeline of the PyTorch/CUDA port on the host,
against the JAX reference's ``PipelineStageStack``
(tests/test_tpu_native.py:105-146).

Ranks are gloo processes running this file as a script (``--worker``):
one spawn of 2 ranks ({"pipe": 2}) and one of 4 ({"pipe": 4}); the
reference runs in the test process on its 8-device CPU mesh with the
same pipe degree. The reference's stack (seed 42, stages of Linear(16,
16) and Tanh) gives its stacked weights to the ranks by name, each rank
taking its slice (``load_numpy_state_dict``), and its gathered state
must come back under the reference's stacked names and shapes. Held to
the reference at its own gates: the forward at rtol 2e-5 / atol 1e-6,
the stacked parameters' grads at rtol 1e-4 / atol 1e-6; and a small
model around the stack (a replicated embedding in front, a replicated
head behind) trained 3 SGD steps at rtol 1e-5 against the reference's,
its replicated parameters bitwise equal on every rank. Also the
stage-count check, the ticks each rank runs and skips, and the stack at
pipe degree 1 (the stages in turn).
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
FWD = dict(rtol=2e-5, atol=1e-6)       # tests/test_tpu_native.py:116
GRAD = dict(rtol=1e-4, atol=1e-6)      # tests/test_tpu_native.py:139
TRAIN = dict(rtol=1e-5, atol=1e-6)
MICRO, BATCH, STEPS, LR = 4, 8, 3, 0.1


def _x():
    return np.random.RandomState(0).randn(BATCH, 16).astype("float32")


def _tokens():
    rng = np.random.RandomState(5)
    return [(rng.randint(0, 32, (BATCH, 3)).astype("int64"),
             rng.randint(0, 32, (BATCH, 3)).astype("int64"))
            for _ in range(STEPS)]


# -- the ranks -------------------------------------------------------------

def _port_stack(pt, n, arrays):
    from paddle_tpu_torch.distributed.fleet.spmd_pipeline import \
        PipelineStageStack
    nn = pt.nn
    stack = PipelineStageStack(
        lambda: nn.Sequential(nn.Linear(16, 16, device="cpu"), nn.Tanh()),
        num_stages=n, num_microbatches=MICRO)
    pt.load_numpy_state_dict(stack, arrays)
    return stack


class _Model(torch.nn.Module):
    """A replicated embedding, the stack, a replicated head."""

    def __init__(self, pt, stack):
        super().__init__()
        self.emb = pt.nn.Embedding(32, 16, device="cpu")
        self.stack = stack
        self.head = pt.nn.Linear(16, 32, device="cpu")

    def forward(self, ids):
        b, s = ids.shape
        h = self.emb(ids).reshape(b * s, 16)
        return self.head(self.stack(h)).reshape(b, s, 32)


def _worker(world):
    import hashlib

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.framework.io_utils import full_state_dict
    dist.init_parallel_env()
    build_mesh({"pipe": world})
    rank = dist.get_rank()
    ref = dict(np.load(os.path.join(os.environ["DIST_TMP"], "ref.npz")))
    stack_arrays = {k[6:]: v for k, v in ref.items() if k.startswith("stack.")}
    out = {}
    stack = _port_stack(pt, world, stack_arrays)
    out["local_shapes"] = np.array([list(p.shape)[0]
                                    for p in stack.parameters()])
    y = stack(torch.tensor(_x()))
    out["fwd"] = y.detach().numpy()
    (y * y).sum().backward()
    for k, p in stack.named_parameters():
        if p.grad is not None:
            out[f"grad.{k}"] = p.grad.numpy()
    out["ticks"] = np.array([stack.stats()["ticks"],
                             stack.stats()["bubble_ticks_skipped"]])
    gathered = full_state_dict(stack)
    out["names"] = np.array(list(gathered))
    for k, v in gathered.items():
        out[f"state.{k}"] = v.numpy()
    with torch.no_grad():
        out["eval"] = stack(torch.tensor(_x())).numpy()
    # training around the stack
    model = _Model(pt, _port_stack(pt, world, stack_arrays))
    pt.load_numpy_state_dict(model, {k: v for k, v in ref.items()
                                     if not k.startswith("stack.")},
                             strict=False)
    opt = pt.optimizer.SGD(learning_rate=LR, parameters=model.parameters())
    losses, shas = [], []
    for ids, labels in _tokens():
        logits = model(torch.tensor(ids))
        loss = F.cross_entropy(logits.reshape(-1, 32),
                               torch.tensor(labels).reshape(-1))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
        h = hashlib.sha1()
        for name in ("emb.weight", "head.weight", "head.bias"):
            h.update(dict(model.named_parameters())[name].detach()
                     .numpy().tobytes())
        shas.append(h.hexdigest())
    out["losses"] = np.array(losses)
    out["replicated_sha"] = np.array(shas)
    for k, v in full_state_dict(model).items():
        out[f"trained.{k}"] = v.numpy()
    try:
        _port_stack(pt, world + 1, stack_arrays)
        out["count_check"] = np.array("no error")
    except ValueError as err:
        out["count_check"] = np.array(str(err))
    np.savez(os.path.join(os.environ["DIST_TMP"], f"rank{rank}.npz"), **out)
    dist.barrier()
    torch.distributed.destroy_process_group()


# -- the test process: the reference -----------------------------------------

def _ref_stack(n):
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    from paddle_tpu.distributed.fleet.spmd_pipeline import \
        PipelineStageStack
    paddle.seed(42)
    return PipelineStageStack(
        lambda: nn.Sequential(nn.Linear(16, 16), nn.Tanh()),
        num_stages=n, num_microbatches=MICRO)


def _reference(n):
    """The reference at pipe n: its stack's state, forward, grads of
    sum(y * y) and eval output, then the small model's losses and final
    state after STEPS SGD steps."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as F
    from paddle_tpu.distributed.mesh import build_mesh
    res = {}
    build_mesh({"pipe": n})
    try:
        stack = _ref_stack(n)
        res["state"] = {k: np.asarray(v._val)
                        for k, v in stack.state_dict().items()}
        y = stack(paddle.to_tensor(_x()))
        res["fwd"] = np.asarray(y._val)
        (y * y).sum().backward()
        res["grads"] = {k: np.asarray(p.grad._val)
                        for k, p in stack.named_parameters()
                        if p.grad is not None}
        for p in stack.parameters():
            p.clear_grad()

        class Model(nn.Layer):
            def __init__(self):
                super().__init__()
                self.emb = nn.Embedding(32, 16)
                self.stack = _ref_stack(n)
                self.head = nn.Linear(16, 32)

            def forward(self, ids):
                b, s = ids.shape
                h = self.emb(ids).reshape([b * s, 16])
                return self.head(self.stack(h)).reshape([b, s, 32])
        model = Model()
        res["model"] = {k: np.asarray(v._val)
                        for k, v in model.state_dict().items()}
        opt = paddle.optimizer.SGD(learning_rate=LR,
                                   parameters=model.parameters())
        losses = []
        for ids, labels in _tokens():
            logits = model(paddle.to_tensor(ids))
            loss = F.cross_entropy(logits.reshape([-1, 32]),
                                   paddle.to_tensor(labels).reshape([-1]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.item()))
        res["losses"] = losses
        res["trained"] = {k: np.asarray(v._val)
                          for k, v in model.state_dict().items()}
    finally:
        build_mesh()
    return res


def _spawn(world, tmp, ref, timeout=240):
    arrays = {f"stack.{k}": v for k, v in ref["state"].items()}
    arrays.update(ref["model"])
    np.savez(os.path.join(tmp, "ref.npz"), **arrays)
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


@pytest.fixture(scope="module", params=[2, 4], ids=["pipe2", "pipe4"])
def pipe(request, tmp_path_factory):
    n = request.param
    ref = _reference(n)
    return n, _spawn(n, tmp_path_factory.mktemp(f"pipe{n}"), ref), ref


def test_forward_matches_the_reference_on_every_rank(pipe):
    n, ranks, ref = pipe
    for got in ranks:
        np.testing.assert_allclose(got["fwd"], ref["fwd"], **FWD)
        np.testing.assert_allclose(got["eval"], ref["fwd"], **FWD)
    assert not np.allclose(ref["fwd"], _x())


def test_grads_match_the_reference(pipe):
    """Each rank's grads are its stage's slice of the stacked grads."""
    n, ranks, ref = pipe
    assert ref["grads"]
    for k, want in ref["grads"].items():
        got = np.concatenate([r[f"grad.{k}"] for r in ranks])
        np.testing.assert_allclose(got, want, err_msg=k, **GRAD)


def test_stacked_names_and_shapes_carried_both_ways(pipe):
    n, ranks, ref = pipe
    for got in ranks:
        assert list(got["local_shapes"][:2]) == [1, 1]
        assert list(got["names"]) == list(ref["state"])
        for k, v in ref["state"].items():
            np.testing.assert_array_equal(got[f"state.{k}"], v)


def test_training_around_the_stack_matches_the_reference(pipe):
    n, ranks, ref = pipe
    for got in ranks:
        np.testing.assert_allclose(got["losses"], ref["losses"], **TRAIN)
        # the embedding in front and the head behind: bitwise equal on
        # every rank after every step
        assert list(got["replicated_sha"]) == list(ranks[0]["replicated_sha"])
        for k, v in ref["trained"].items():
            np.testing.assert_allclose(got[f"trained.{k}"], v, err_msg=k,
                                       **TRAIN)


def test_each_rank_runs_its_micro_batches_and_skips_the_bubble(pipe):
    """The reference runs m + n - 1 ticks a device; the port runs the m
    that carry a micro-batch and skips the n - 1 bubble ticks."""
    n, ranks, _ = pipe
    for got in ranks:
        assert got["ticks"].tolist() == [MICRO, n - 1]


def test_stage_count_must_match_the_axis(pipe):
    n, ranks, _ = pipe
    for got in ranks:
        assert "must equal the 'pipe' mesh axis degree" in \
            str(got["count_check"])


def test_degree_one_runs_the_stages_in_turn():
    """World size 1: the sequential path against the reference's, with
    the reference's weights carried in whole."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.mesh import build_mesh
    build_mesh()
    ref = _reference(4)
    stack = _port_stack(pt, 4, ref["state"])
    assert tuple(stack.state_dict()["0__weight"].shape) == (4, 16, 16)
    x = torch.tensor(_x())
    y = stack(x)
    np.testing.assert_allclose(y.detach().numpy(), ref["fwd"], **FWD)
    (y * y).sum().backward()
    for k, want in ref["grads"].items():
        np.testing.assert_allclose(dict(stack.named_parameters())[k]
                                   .grad.numpy(), want, err_msg=k, **GRAD)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[2]))
