"""The port's launcher and in-job recovery on the host: ``python -m
paddle_tpu_torch.distributed.launch --cpu_sim`` over real rank processes
joined by gloo.

- the launcher's topology, free ports and the reference's environment
  contract; a failed rank terminates its peers; the module entry point;
  the wire secret injected alike into every rank;
- the supervised relaunch (``--max_restarts``): a 2-layer, width-64 GPT
  under ``DataParallel``, each rank in a ``RecoveryManager`` with an
  ``ElasticManager`` on a ``FileStore``, a hybrid checkpoint every second
  step; rank 1 (in one launch) or rank 0 (in another) is killed at step
  3 by ``os._exit`` through a fault site of its first incarnation. The
  launcher relaunches it, the survivor tears its group down, both meet at
  generation 2, restore the checkpoint and finish: every loss equals an
  uninterrupted launch's to the bit, and the reference's serial GPT on
  the global batch within f32 rtol 1e-5; the journal names the
  launcher's ``worker_restart`` and the survivor's ``restart``;
- a spent budget journals ``recovery_exhausted``; exit 117 (quarantine)
  is not relaunched and not charged.

The jobs run this file as the training script (``--job``); only the test
process imports the JAX reference.
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
GPT_CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
               max_position_embeddings=64, dropout=0.0)
STEPS, BATCH, SEQ = 6, 4, 32        # BATCH is the global batch
CKPT_EVERY = 2
KILL_STEP = 3
KILLED = 9                          # the killed rank's exit code
F32 = dict(rtol=1e-5, atol=1e-6)


# -- the job (one rank, started by the launcher) ------------------------------

def _stream():
    rng = np.random.RandomState(7)
    xs = rng.randint(0, GPT_CFG["vocab_size"],
                     (STEPS, BATCH, SEQ)).astype("int32")
    ys = rng.randint(0, GPT_CFG["vocab_size"],
                     (STEPS, BATCH, SEQ)).astype("int64")
    return xs, ys


def _job(out, kill_rank):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import p2p
    from paddle_tpu_torch.distributed.checkpoint import (
        load_hybrid_checkpoint, save_hybrid_checkpoint)
    from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                           FileStore)
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.recovery import RecoveryManager
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    pt.set_flags({"FLAGS_recovery_backoff_base": 0.0})
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    incarnation = int(os.environ.get("PADDLE_TPU_GENERATION", "0") or 0)
    if rank == kill_rank and incarnation == 0:
        faults.configure(f"job.kill:#{KILL_STEP + 1}")
    em = ElasticManager(FileStore(os.path.join(out, "store")), "job",
                        np_min=2, np_max=2, rank=rank,
                        endpoint=os.environ["PADDLE_CURRENT_ENDPOINT"])
    em.register()
    gen0, _ = em.rendezvous(timeout=120)
    dist.init_parallel_env()
    p2p.connect()
    with open(os.path.join(out, "arrays.json")) as f:
        arrays = {k: np.asarray(v, np.float32)
                  for k, v in json.load(f).items()}
    model = GPTForCausalLM(GPTConfig(**GPT_CFG), device="cpu")
    pt.load_numpy_state_dict(model, arrays)
    dp = pt.DataParallel(model)
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    ckpt = os.path.join(out, "ckpt.pdparams")
    xs, ys = _stream()
    per = BATCH // dist.get_world_size()
    losses = {}

    def restore(gen):
        p2p.connect()
        opt.clear_grad()   # a step cut short leaves its local gradients
        if not os.path.exists(ckpt):
            return {"step": 0}
        return load_hybrid_checkpoint(ckpt, dp, opt)

    def train(resume):
        start = (resume or restore(gen0))["step"]
        for step in range(start, STEPS):
            if faults.should_inject("job.kill"):
                os._exit(KILLED)
            sl = slice(rank * per, (rank + 1) * per)
            loss = dp(torch.from_numpy(xs[step, sl]),
                      labels=torch.from_numpy(ys[step, sl]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            g = loss.detach().reshape(1).clone()
            losses[step] = dist.all_reduce(
                g, op=dist.ReduceOp.AVG).item()
            if (step + 1) % CKPT_EVERY == 0:
                save_hybrid_checkpoint(ckpt, dp, opt, meta={"step": step + 1})
        return start

    rm = RecoveryManager(em, restore=restore, max_restarts=1,
                         rendezvous_timeout=120)
    start = rm.run(train)
    from paddle_tpu_torch.resilience.recovery import current_generation
    with open(os.path.join(out, f"rank{rank}.inc{incarnation}.json"),
              "w") as f:
        json.dump({"losses": [losses[s] for s in sorted(losses)],
                   "steps": sorted(losses), "start": start,
                   "generation": current_generation(),
                   "restarts": rm.restarts, "env": {
                       k: os.environ.get(k) for k in (
                           "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                           "PADDLE_CURRENT_ENDPOINT",
                           "PADDLE_TRAINER_ENDPOINTS",
                           "PADDLE_COORDINATOR_ADDR", "JAX_PROCESS_ID",
                           "JAX_NUM_PROCESSES", "CUDA_VISIBLE_DEVICES",
                           "PADDLE_TPU_WIRE_SECRET")}}, f)
    dist.barrier()
    dist.env.teardown()


# -- the test process ---------------------------------------------------------

def _launch(tmp, *args, max_restarts=1, timeout=240, extra=()):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
           "PADDLE_TPU_ARTIFACTS_DIR": str(tmp / "artifacts"),
           "PADDLE_JOB_ID": "job", "PADDLE_TPU_P2P_CONNECT_TIMEOUT": "2"}
    env.pop("PADDLE_TPU_WIRE_SECRET", None)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--cpu_sim", "--log_dir",
           str(tmp / "logs"), *extra]
    if max_restarts:
        cmd += ["--max_restarts", str(max_restarts)]
    return subprocess.Popen(cmd + [*map(str, args)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _logs(tmp):
    out = []
    d = tmp / "logs"
    for name in sorted(os.listdir(d)) if d.exists() else ():
        out.append(f"--- {name}\n" + (d / name).read_text()[-3000:])
    return "\n".join(out)


def _finish(p, tmp, timeout=240):
    try:
        text = p.communicate(timeout=timeout)[0].decode(errors="replace")
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    return p.returncode, text + _logs(tmp)


def _ref_serial():
    """The reference's 2-layer GPT: its initial weights, and its serial
    AdamW steps on the global batch."""
    import paddle_tpu as paddle
    from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
    from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT
    paddle.seed(0)
    ref = RefGPT(RefConfig(**GPT_CFG))
    arrays = {k: np.asarray(v._val) for k, v in ref.state_dict().items()}
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=ref.parameters())
    losses = []
    for x, y in zip(*_stream()):
        loss = ref(paddle.to_tensor(x), labels=paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return arrays, losses


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Three launches at once: uninterrupted, rank 1 killed, rank 0
    killed; plus the reference's serial losses from the same weights."""
    arrays, ref = _ref_serial()
    runs = {}
    for name, kill in (("whole", -1), ("kill1", 1), ("kill0", 0)):
        tmp = tmp_path_factory.mktemp(name)
        with open(tmp / "arrays.json", "w") as f:
            json.dump({k: v.tolist() for k, v in arrays.items()}, f)
        runs[name] = (tmp, _launch(tmp, HERE, "--job", tmp, kill))
    out = {}
    for name, (tmp, p) in runs.items():
        code, text = _finish(p, tmp)
        assert code == 0, f"{name} launch exited {code}:\n{text[-8000:]}"
        out[name] = tmp
    return out, ref


def _result(tmp, rank, inc):
    with open(tmp / f"rank{rank}.inc{inc}.json") as f:
        return json.load(f)


def _journal(tmp):
    from paddle_tpu_torch.resilience.recovery import RecoveryJournal
    return RecoveryJournal("job", dir=str(tmp / "artifacts")).entries()


def test_uninterrupted_launch_follows_the_reference_serial_gpt(jobs):
    runs, ref = jobs
    for r in range(2):
        res = _result(runs["whole"], r, 0)
        assert res["steps"] == list(range(STEPS)) and res["restarts"] == 0
        assert res["generation"] == 1
        np.testing.assert_allclose(res["losses"], ref, **F32)
    assert _journal(runs["whole"]) == []


def test_launch_environment_contract(jobs):
    runs, _ = jobs
    envs = [_result(runs["whole"], r, 0)["env"] for r in range(2)]
    eps = envs[0]["PADDLE_TRAINER_ENDPOINTS"].split(",")
    assert len(eps) == 2 and len(set(eps)) == 2
    for r, e in enumerate(envs):
        assert e["PADDLE_TRAINER_ID"] == e["JAX_PROCESS_ID"] == str(r)
        assert e["PADDLE_TRAINERS_NUM"] == e["JAX_NUM_PROCESSES"] == "2"
        assert e["PADDLE_CURRENT_ENDPOINT"] == eps[r]
        assert e["PADDLE_COORDINATOR_ADDR"] == eps[0]
        assert e["CUDA_VISIBLE_DEVICES"] == ""       # --cpu_sim
    # one generated secret, the same in every rank
    assert envs[0]["PADDLE_TPU_WIRE_SECRET"] == \
        envs[1]["PADDLE_TPU_WIRE_SECRET"]
    assert len(envs[0]["PADDLE_TPU_WIRE_SECRET"]) == 64


@pytest.mark.parametrize("killed", [1, 0])
def test_killed_rank_is_relaunched_and_the_losses_are_uninterrupted(
        jobs, killed):
    runs, ref = jobs
    tmp = runs[f"kill{killed}"]
    whole = _result(runs["whole"], 0, 0)["losses"]
    survivor = _result(tmp, 1 - killed, 0)
    replacement = _result(tmp, killed, 1)
    # the survivor kept steps 0-1 and redid 2-5 from the checkpoint of
    # step 2; the replacement started there
    assert survivor["restarts"] == 1 and replacement["restarts"] == 0
    assert replacement["start"] == CKPT_EVERY
    assert survivor["generation"] == replacement["generation"] == 2
    assert survivor["steps"] == list(range(STEPS))
    assert survivor["losses"] == whole          # to the bit
    assert replacement["losses"] == whole[CKPT_EVERY:]
    np.testing.assert_allclose(survivor["losses"], ref, **F32)
    assert not (tmp / f"rank{killed}.inc0.json").exists()
    ents = _journal(tmp)
    wr = [e for e in ents if e["event"] == "worker_restart"]
    rs = [e for e in ents if e["event"] == "restart"]
    assert len(wr) == 1 and wr[0]["rank"] == killed
    assert wr[0]["code"] == KILLED and wr[0]["generation"] == 1
    assert "exit code 9" in wr[0]["cause"]
    assert len(rs) == 1 and rs[0]["generation"] == 2 and rs[0]["np"] == 2
    assert rs[0]["cause"] in ("ConnectionError", "PeerAbort"), rs[0]


FAIL = ("import os, sys, time\n"
        "sys.exit(3) if os.environ['PADDLE_TRAINER_ID'] == '1' "
        "else time.sleep(60)\n")


def test_failure_terminates_the_peers(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(FAIL)
    t0 = time.time()
    code, text = _finish(_launch(tmp_path, script, max_restarts=0),
                         tmp_path, timeout=120)
    assert code != 0 and "rank 1 exited with code 3" in text, text
    assert time.time() - t0 < 40     # the sleeper did not run out its 60 s


def test_spent_budget_journals_recovery_exhausted(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(FAIL.replace("sys.exit(3)", "sys.exit(7)"))
    code, text = _finish(_launch(tmp_path, script, max_restarts=1),
                         tmp_path, timeout=120)
    assert code != 0 and "restart budget (1) is spent" in text, text
    ents = _journal(tmp_path)
    assert [e["event"] for e in ents] == ["worker_restart",
                                          "recovery_exhausted"]
    assert ents[-1]["rank"] == 1 and ents[-1]["code"] == 7


def test_quarantine_exit_is_not_relaunched(tmp_path):
    script = tmp_path / "q.py"
    script.write_text(
        "import os, sys\n"
        "from paddle_tpu_torch.resilience.health import "
        "QUARANTINE_EXIT_CODE\n"
        "if os.environ['PADDLE_TRAINER_ID'] == '1':\n"
        "    sys.exit(QUARANTINE_EXIT_CODE)\n")
    code, text = _finish(_launch(tmp_path, script, max_restarts=1),
                         tmp_path, timeout=120)
    assert code == 0, text
    ents = _journal(tmp_path)
    assert [e["event"] for e in ents] == ["quarantined"]
    assert ents[0]["rank"] == 1 and ents[0]["code"] == 117


def test_topology_and_free_ports():
    from paddle_tpu_torch.distributed.launch_utils import (
        find_free_ports, get_cluster_from_args)
    cluster, pod = get_cluster_from_args(ips="127.0.0.1", nproc_per_node=4)
    assert cluster.trainers_nranks() == pod.trainers_num() == 4
    assert len(set(cluster.trainers_endpoints())) == 4
    cluster, pod = get_cluster_from_args(
        ips="10.0.0.1,10.0.0.2", nproc_per_node=2, current_ip="10.0.0.1",
        start_port=6170)
    assert cluster.pods_endpoints() == ["10.0.0.1", "10.0.0.2"]
    assert [t.rank for p in cluster.pods for t in p.trainers] == [0, 1, 2, 3]
    assert cluster.trainers_endpoints()[3] == "10.0.0.2:6171"
    assert len(set(find_free_ports(8))) == 8


if __name__ == "__main__" and sys.argv[1:2] == ["--job"]:
    _job(sys.argv[2], int(sys.argv[3]))
