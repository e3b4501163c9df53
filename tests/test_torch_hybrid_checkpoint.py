"""The hybrid checkpoint of the PyTorch/CUDA port (distributed/checkpoint.py)
against the JAX reference's (paddle_tpu/distributed/checkpoint.py), both
ways, as the reference's own tests save and reshard
(tests/test_hybrid_parallel.py:645-730, tests/test_integrity.py:604-640).

Ranks are gloo processes running this file as a script (``--worker``);
one spawn of 2 ranks carries the multi-rank checks, each layout after a
``fleet.init`` of its own, and the reference runs only in the test
process:

- the port saves at mp 2 (a tensor-parallel GPT after 2 AdamW steps) and
  at pp 2 (the reference test's mini-GPT as a 2-stage PipelineLayer);
  the reference's ``load_hybrid_checkpoint`` loads each file into its
  serial model: the same weights to the bit, the same next loss, and its
  next AdamW step lands where the port's uninterrupted one does;
- the reference saves (its serial GPT, its one-stage PipelineLayer) and
  the port loads at mp 2, at pp 2 and at 1 rank: the same loss at rtol
  1e-4, and training continues;
- ZeRO-1: saved at sharding 2, resumed at sharding 2 and at 1 rank, the
  next 2 losses equal an uninterrupted run's;
- the sidecar: a flipped byte falls back to ``.old``, a torn pickle with
  no ``.old`` raises ``CorruptCheckpointError``, a directory of manifests
  restores its newest;
- ``reshard_model`` puts a full state onto the mp 2 layout, bitwise;
- a saved array whose split does not tile the current model ranks raises
  ``ValueError`` naming the parameter (ROADMAP C-ref-23).
"""
import hashlib
import json
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
GPT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=64, dropout=0.0)
BATCH, SEQ, LR = 4, 16, 1e-3
LOSS_RTOL = 1e-4


def _stream(steps=5):
    rng = np.random.RandomState(3)
    shape = (steps, BATCH, SEQ)
    return (rng.randint(0, GPT_CFG["vocab_size"], shape).astype("int64"),
            rng.randint(0, GPT_CFG["vocab_size"], shape).astype("int64"))


def _mini_data(steps=4):
    rng = np.random.RandomState(13)
    return [(rng.randint(0, 32, (8, 6)).astype("int64"),
             rng.randint(0, 32, (8, 6)).astype("int64"))
            for _ in range(steps)]


def _sha(arrays):
    """{name: sha256 of the f32 bytes}."""
    return {k: hashlib.sha256(np.ascontiguousarray(
        np.asarray(v, np.float32)).tobytes()).hexdigest()
        for k, v in arrays.items()}


# -- the ranks -------------------------------------------------------------

def _fleet(hybrid, micro=2):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {**strategy.hybrid_configs, **hybrid}
    strategy.pipeline_configs = {"accumulate_steps": micro}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet, fleet.get_hybrid_communicate_group()


def _port_gpt(pt, arrays, tp):
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(tensor_parallel=tp, **GPT_CFG),
                           device="cpu")
    if arrays is not None:
        pt.load_numpy_state_dict(model, arrays)
    return model


def _gpt_loss(model, i):
    xs, ys = _stream()
    with torch.no_grad():
        return float(model(torch.tensor(xs[i]), labels=torch.tensor(ys[i])))


def _gpt_steps(model, opt, steps):
    xs, ys = _stream()
    out = []
    for i in steps:
        loss = model(torch.tensor(xs[i]), labels=torch.tensor(ys[i]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss.detach()))
    return out


def _port_pipe(pt, stages):
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    nn, kw = pt.nn, {"device": "cpu"}

    def block():
        return nn.Sequential(nn.Linear(16, 16, **kw), nn.Tanh())
    return PipelineLayer([nn.Embedding(32, 16, **kw), block(), block(),
                          nn.Linear(16, 32, **kw)], num_stages=stages,
                         loss_fn=lambda o, y: F.cross_entropy(o, y))


def _mp2(out, arrays, tmp):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import (
        load_hybrid_checkpoint, save_hybrid_checkpoint)
    from paddle_tpu_torch.distributed.checkpoint import _apply_blob
    fleet, _ = _fleet({"mp_degree": 2})
    model = _port_gpt(pt, arrays["gpt"], tp=True)
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=LR, parameters=model.parameters()))
    _gpt_steps(dist_model, opt, [0, 1])
    save_hybrid_checkpoint(os.path.join(tmp, "mp2.ckpt"), dist_model, opt,
                           meta={"step": 2})
    out["mp2_sha"] = _sha({k: v.numpy() for k, v in
                           pt.full_state_dict(model).items()})
    out["mp2_next_loss"] = _gpt_loss(dist_model, 2)
    _gpt_steps(dist_model, opt, [2])
    out["mp2_after_step_loss"] = _gpt_loss(dist_model, 3)
    # the reference's file at mp 2: the same loss, and training goes on
    model = _port_gpt(pt, None, tp=True)
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=LR, parameters=model.parameters()))
    meta = load_hybrid_checkpoint(os.path.join(tmp, "ref_gpt.ckpt"),
                                  dist_model, opt)
    out["ref_at_mp2"] = [meta["step"], _gpt_loss(dist_model, 2),
                         *_gpt_steps(dist_model, opt, [2]),
                         _gpt_loss(dist_model, 3)]
    # reshard_model: a full state (the serial arrays) onto the TP layout
    from paddle_tpu_torch.distributed import reshard_model
    reshard_model(dist_model, arrays["gpt"])
    out["resharded_sha"] = _sha({k: v.numpy() for k, v in
                                 pt.full_state_dict(model).items()})
    # C-ref-23: a vocabulary of 255 rows does not split over 2 ranks
    bad = {k: v.numpy() for k, v in pt.full_state_dict(model).items()}
    bad["gpt.wte.weight"] = bad["gpt.wte.weight"][:255]
    try:
        _apply_blob({"model": bad}, model)
    except ValueError as e:
        out["untiled"] = str(e)


def _pp2(out, arrays, tmp):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import (
        load_hybrid_checkpoint, save_hybrid_checkpoint)
    fleet, _ = _fleet({"pp_degree": 2})
    data = _mini_data()

    def run(pl, opt, steps):
        model = fleet.distributed_model(pl)
        return model, [float(model.train_batch(
            (torch.tensor(data[i][0]), torch.tensor(data[i][1])), opt))
            for i in steps]
    pl = _port_pipe(pt, 2)
    pt.load_numpy_state_dict(pl, {k: arrays["mini"][k]
                                  for k in pl.state_dict()})
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=LR, parameters=pl.parameters()))
    model, _ = run(pl, opt, [0, 1])
    save_hybrid_checkpoint(os.path.join(tmp, "pp2.ckpt"), model, opt,
                           meta={"step": 2})
    out["pp2_weights"] = {k: v.tolist() for k, v in pl.state_dict().items()}
    x, y = (torch.tensor(a) for a in data[2])
    out["pp2_next_loss"] = float(model.eval_batch((x, y)))
    # the reference's file at pp 2
    pl = _port_pipe(pt, 2)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=LR, parameters=pl.parameters()))
    model = fleet.distributed_model(pl)
    load_hybrid_checkpoint(os.path.join(tmp, "ref_pp.ckpt"), model, opt)
    out["ref_at_pp2"] = [float(model.eval_batch((x, y))),
                         *run(pl, opt, [2])[1]]


def _zero(out, arrays, tmp):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import (
        load_hybrid_checkpoint, save_hybrid_checkpoint)
    fleet, _ = _fleet({"sharding_degree": 2})

    def fresh():
        model = _port_gpt(pt, arrays["gpt"], tp=False)
        dist_model = fleet.distributed_model(model)
        opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
            learning_rate=LR, parameters=model.parameters()))
        return dist_model, opt
    model, opt = fresh()
    out["zero_straight"] = _gpt_steps(model, opt, range(4))
    model, opt = fresh()
    _gpt_steps(model, opt, [0, 1])
    out["zero_owned"] = len(opt._inner.owned_parameters)
    save_hybrid_checkpoint(os.path.join(tmp, "zero.ckpt"), model, opt)
    model, opt = fresh()
    load_hybrid_checkpoint(os.path.join(tmp, "zero.ckpt"), model, opt)
    out["zero_resumed"] = _gpt_steps(model, opt, [2, 3])


def _worker():
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()
    rank = dist.get_rank()
    tmp = os.environ["DIST_TMP"]
    with open(os.path.join(tmp, "arrays.json")) as f:
        arrays = {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
                  for k, d in json.load(f).items()}
    out = {"rank": rank}
    _mp2(out, arrays, tmp)
    _pp2(out, arrays, tmp)
    _zero(out, arrays, tmp)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


# -- the test process: the reference -----------------------------------------

def _arrays(layer):
    return {k: np.asarray(v._val, np.float32)
            for k, v in layer.state_dict().items()}


def _ref_gpt():
    import paddle_tpu as paddle
    from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM
    paddle.seed(0)
    model = GPTForCausalLM(GPTConfig(**GPT_CFG))
    return model, paddle.optimizer.AdamW(learning_rate=LR,
                                         parameters=model.parameters())


def _ref_gpt_loss(model, i):
    import paddle_tpu as paddle
    xs, ys = _stream()
    return float(model(paddle.to_tensor(xs[i].astype("int32")),
                       labels=paddle.to_tensor(ys[i])))


def _ref_gpt_steps(model, opt, steps):
    import paddle_tpu as paddle
    xs, ys = _stream()
    out = []
    for i in steps:
        loss = model(paddle.to_tensor(xs[i].astype("int32")),
                     labels=paddle.to_tensor(ys[i]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out


def _ref_pipe():
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as F
    from paddle_tpu.distributed import fleet as rfleet
    from paddle_tpu.distributed.fleet.meta_parallel import (
        PipelineLayer, PipelineParallel)
    paddle.seed(21)

    def block():
        return nn.Sequential(nn.Linear(16, 16), nn.Tanh())
    model = PipelineLayer([nn.Embedding(32, 16), block(), block(),
                           nn.Linear(16, 32)], num_stages=1,
                          loss_fn=lambda o, y: F.cross_entropy(o, y))
    strategy = rfleet.DistributedStrategy()
    strategy.pipeline_configs = {"accumulate_steps": 2}
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=model.parameters())
    return model, PipelineParallel(model, None, strategy), opt


def _ref_pp_batch(i):
    import paddle_tpu as paddle
    x, y = _mini_data()[i]
    return paddle.to_tensor(x.astype("int32")), paddle.to_tensor(y)


def _reference(tmp):
    from paddle_tpu.distributed import save_hybrid_checkpoint
    res, arrays = {}, {}
    model, opt = _ref_gpt()
    arrays["gpt"] = _arrays(model)
    _ref_gpt_steps(model, opt, [0, 1])
    save_hybrid_checkpoint(os.path.join(tmp, "ref_gpt.ckpt"), model, opt,
                           meta={"step": 2})
    res["gpt_next_loss"] = _ref_gpt_loss(model, 2)
    res["gpt_continued"] = _ref_gpt_steps(model, opt, [2]) + \
        [_ref_gpt_loss(model, 3)]
    model, pp, opt = _ref_pipe()
    arrays["mini"] = _arrays(model)
    for i in (0, 1):
        pp.train_batch(_ref_pp_batch(i), opt)
    save_hybrid_checkpoint(os.path.join(tmp, "ref_pp.ckpt"), model, opt,
                           meta={"step": 2})
    res["pp_next_loss"] = float(pp.eval_batch(_ref_pp_batch(2)))
    res["pp_continued"] = float(pp.train_batch(_ref_pp_batch(2), opt))
    return res, arrays


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's saves, then the 2 ranks (their files in the same
    directory)."""
    tmp = str(tmp_path_factory.mktemp("ckpt"))
    res, arrays = _reference(tmp)
    with open(os.path.join(tmp, "arrays.json"), "w") as f:
        json.dump({k: {n: v.tolist() for n, v in d.items()}
                   for k, d in arrays.items()}, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = {**os.environ, "PADDLE_TRAINER_ID": str(r),
               "PADDLE_TRAINERS_NUM": "2",
               "PADDLE_COORDINATOR_ADDR": f"localhost:{port}",
               "DIST_TMP": tmp, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
        procs.append(subprocess.Popen(
            [sys.executable, HERE, "--worker"], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors="replace")
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
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return {"tmp": tmp, "ref": res, "arrays": arrays, "ranks": ranks}


# -- the tests ---------------------------------------------------------------

def test_port_mp2_file_loads_into_the_reference_serial_gpt(run):
    from paddle_tpu.distributed import load_hybrid_checkpoint
    model, opt = _ref_gpt()
    meta = load_hybrid_checkpoint(os.path.join(run["tmp"], "mp2.ckpt"),
                                  model, opt)
    assert meta["step"] == 2
    for r in run["ranks"]:
        assert _sha(_arrays(model)) == r["mp2_sha"]
        np.testing.assert_allclose(_ref_gpt_loss(model, 2),
                                   r["mp2_next_loss"], rtol=LOSS_RTOL)
    # the moments came across: the next AdamW step lands where the port's
    # uninterrupted one did
    _ref_gpt_steps(model, opt, [2])
    np.testing.assert_allclose(_ref_gpt_loss(model, 3),
                               run["ranks"][0]["mp2_after_step_loss"],
                               rtol=LOSS_RTOL)


def test_port_pp2_file_loads_into_the_reference_serial_pipeline(run):
    from paddle_tpu.distributed import load_hybrid_checkpoint
    model, pp, opt = _ref_pipe()
    assert load_hybrid_checkpoint(os.path.join(run["tmp"], "pp2.ckpt"),
                                  model, opt)["step"] == 2
    got = _arrays(model)
    saved = {}
    for r in run["ranks"]:
        saved.update(r["pp2_weights"])
    assert set(saved) == set(got)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32),
                                      err_msg=k)
    for r in run["ranks"]:
        np.testing.assert_allclose(float(pp.eval_batch(_ref_pp_batch(2))),
                                   r["pp2_next_loss"], rtol=LOSS_RTOL)


def test_reference_file_loads_into_the_port_at_mp2(run):
    ref = run["ref"]
    for r in run["ranks"]:
        step, loss, train_loss, after = r["ref_at_mp2"]
        assert step == 2
        np.testing.assert_allclose(loss, ref["gpt_next_loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose([train_loss, after], ref["gpt_continued"],
                                   rtol=LOSS_RTOL)


def test_reference_file_loads_into_the_port_at_pp2(run):
    ref = run["ref"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["ref_at_pp2"],
                                   [ref["pp_next_loss"],
                                    ref["pp_continued"]], rtol=LOSS_RTOL)


def test_reference_file_loads_into_the_port_at_one_rank(run):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import load_hybrid_checkpoint
    model = _port_gpt(pt, None, tp=False)
    opt = pt.optimizer.AdamW(learning_rate=LR, parameters=model.parameters())
    meta = load_hybrid_checkpoint(os.path.join(run["tmp"], "ref_gpt.ckpt"),
                                  model, opt)
    assert meta["step"] == 2
    np.testing.assert_allclose(_gpt_loss(model, 2), run["ref"]
                               ["gpt_next_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(_gpt_steps(model, opt, [2]) +
                               [_gpt_loss(model, 3)],
                               run["ref"]["gpt_continued"], rtol=LOSS_RTOL)


def test_zero1_resumes_at_sharding_2_and_at_one_rank(run):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import load_hybrid_checkpoint
    ranks = run["ranks"]
    straight = ranks[0]["zero_straight"]
    assert sum(r["zero_owned"] for r in ranks) == \
        len(run["arrays"]["gpt"])
    for r in ranks:
        np.testing.assert_allclose(r["zero_resumed"], straight[2:],
                                   rtol=1e-6)
    model = _port_gpt(pt, None, tp=False)
    opt = pt.optimizer.AdamW(learning_rate=LR, parameters=model.parameters())
    load_hybrid_checkpoint(os.path.join(run["tmp"], "zero.ckpt"), model, opt)
    np.testing.assert_allclose(_gpt_steps(model, opt, [2, 3]), straight[2:],
                               rtol=1e-6)


def test_reshard_model_applies_a_full_state_to_the_tp_layout(run):
    for r in run["ranks"]:
        assert r["resharded_sha"] == _sha(run["arrays"]["gpt"])


def test_untiled_split_raises_naming_the_parameter(run):
    """ROADMAP C-ref-23: the reference would replicate the parameter and
    warn; a tensor-parallel layer of the port holds its shard."""
    for r in run["ranks"]:
        assert "'gpt.wte.weight'" in r["untiled"]
        assert "does not tile" in r["untiled"]


def _one_rank_model(seed):
    import paddle_tpu_torch as pt
    model = pt.nn.Sequential(
        pt.nn.Linear(8, 16, device="cpu",
                     generator=torch.Generator().manual_seed(seed)),
        pt.nn.ReLU(), pt.nn.Linear(16, 4, device="cpu"))
    return model, pt.optimizer.Adam(learning_rate=1e-2,
                                    parameters=model.parameters())


def _adam_step(model, opt):
    model(torch.ones(2, 8)).sum().backward()
    opt.step()
    opt.clear_grad()


def test_flipped_byte_falls_back_to_old(tmp_path):
    from paddle_tpu_torch.distributed import (
        load_hybrid_checkpoint, save_hybrid_checkpoint)
    model, opt = _one_rank_model(2)
    ckpt = str(tmp_path / "c.pdparams")
    save_hybrid_checkpoint(ckpt, model, opt, meta={"step": 1})
    want = {k: v.clone() for k, v in model.state_dict().items()}
    _adam_step(model, opt)
    save_hybrid_checkpoint(ckpt, model, opt, meta={"step": 2})
    assert os.path.exists(ckpt + ".sha256")
    assert os.path.exists(ckpt + ".old.sha256")
    with open(ckpt, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    model2, opt2 = _one_rank_model(9)
    meta = load_hybrid_checkpoint(ckpt, model2, opt2)
    assert meta["restored_from_fallback"] is True and meta["step"] == 1
    for k, v in want.items():
        torch.testing.assert_close(model2.state_dict()[k], v, rtol=0,
                                   atol=0)


def test_torn_file_without_old_raises_typed(tmp_path):
    from paddle_tpu_torch.distributed import (
        CorruptCheckpointError, load_hybrid_checkpoint,
        save_hybrid_checkpoint)
    model, opt = _one_rank_model(2)
    ckpt = str(tmp_path / "c.pdparams")
    save_hybrid_checkpoint(ckpt, model, opt)
    with open(ckpt, "ab") as f:
        f.write(b"garbage")
    with pytest.raises(CorruptCheckpointError, match="sha256 mismatch"):
        load_hybrid_checkpoint(ckpt, model, opt)
    os.remove(ckpt + ".sha256")
    with open(ckpt, "r+b") as f:
        f.truncate(40)
    with pytest.raises(CorruptCheckpointError, match="unreadable"):
        load_hybrid_checkpoint(ckpt, model, opt)


def test_directory_of_manifests_restores_the_newest(tmp_path):
    from paddle_tpu_torch.distributed import load_hybrid_checkpoint
    from paddle_tpu_torch.resilience.snapshot import checkpointer_for
    model, opt = _one_rank_model(2)
    root = str(tmp_path / "snaps")
    ck = checkpointer_for(root)
    for step in (1, 2):
        _adam_step(model, opt)
        blob = {"model": dict(model.state_dict()),
                "optimizer": dict(opt.state_dict()), "meta": {"step": step}}
        ck.save({"c.pdparams": (blob, "blob")}, step=step)
    model2, opt2 = _one_rank_model(9)
    meta = load_hybrid_checkpoint(root, model2, opt2)
    assert meta["step"] == 2 and "manifest-" in meta["restored_from"]
    for k, v in model.state_dict().items():
        torch.testing.assert_close(model2.state_dict()[k], v, rtol=0,
                                   atol=0)
    _adam_step(model, opt)
    _adam_step(model2, opt2)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(model2.state_dict()[k], v, rtol=0,
                                   atol=0)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker()
