"""The 1F1B pipeline of the PyTorch/CUDA port on the host, against the JAX
reference's ``PipelineEngine`` (``compiled=False``) and its serial
``PipelineParallel`` (micro-batch accumulation), as in the reference's
own tests (tests/test_hybrid_parallel.py:344-480).

Ranks are gloo processes, each running this file as a script
(``--worker``), one stage a rank; one spawn of 2 ranks (pp 2) and one of
4 (dp 2 x pp 2, then pp 2 x mp 2) carry every multi-rank check, and the
reference runs only in the test process:

- the unit order and the segmentation (pure functions) against the
  reference's, and the stash bound S - s;
- the reference test's mini-GPT under SGD, accumulate_steps 4, 3 steps,
  at pp 2 and at dp 2 x pp 2: losses and every final weight;
- eval_batch with a loss and without; a GradScaler with the global-norm
  clip over both stages; a disabled scaler against no scaler; BatchNorm's
  running statistics through the engine; a tied layer whose gradient is
  summed over the stages that hold it (against a reference model with the
  same tie, since the reference's PipelineLayer reads no forward_func);
  dropout through the recompute against the same stage without it;
- a tensor-parallel GPT (2 layers, hidden 64) as a PipelineLayer at
  pp 2 x mp 2: 3 AdamW steps' losses against the reference's serial GPT
  at 5e-4 relative (__graft_entry__.py:151-155), replicated parameters
  and the tied embedding's two copies bitwise equal;
- the raises: a batch that accumulate_steps does not divide, num_stages
  against the pipe degree and the layer count, the generation fence, and
  a signature that changes mid-run (its header is sent again);
- ``CompiledStageProgram`` off the card: its keys, counters and eager
  route (the capture itself runs on the card).

The weights and every loss are f32 and held at rtol 1e-5 (the reference's
own pipeline test holds its losses at 2e-4).
"""
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
RTOL, ATOL = 1e-5, 1e-6
MICRO, STEPS, LR = 4, 3, 0.1
GPT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=64, dropout=0.0)
GPT_STEPS, GPT_BATCH, GPT_SEQ, GPT_MICRO = 3, 4, 16, 2
LOSS_RTOL = 5e-4                       # __graft_entry__.py:151-155
SCALER_INIT, CLIP = 2.0 ** 8, 1.0


# -- inputs, shared by the ranks and the test process ------------------------

def _data(steps=STEPS, seq=6):
    rng = np.random.RandomState(13)
    return [(rng.randint(0, 32, (16, seq)).astype("int64"),
             rng.randint(0, 32, (16, seq)).astype("int64"))
            for _ in range(steps)]


def _bn_data():
    rng = np.random.RandomState(0)
    return (rng.randn(8, 8).astype("f4") + 3.0,
            rng.randint(0, 4, (8, 1)).astype("int64"))


def _gpt_stream():
    rng = np.random.RandomState(3)
    shape = (GPT_STEPS, GPT_BATCH, GPT_SEQ)
    return (rng.randint(0, GPT_CFG["vocab_size"], shape).astype("int64"),
            rng.randint(0, GPT_CFG["vocab_size"], shape).astype("int64"))


def _port_descs(pt, tied=False):
    nn, kw = pt.nn, {"device": "cpu"}

    def block():
        return nn.Sequential(nn.Linear(16, 16, **kw), nn.Tanh())
    if not tied:
        return [nn.Embedding(32, 16, **kw), block(), block(),
                nn.Linear(16, 32, **kw)]
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        LayerDesc, SharedLayerDesc)
    return [SharedLayerDesc("emb", nn.Embedding, None, "weight", 32, 16,
                            **kw),
            LayerDesc(block), LayerDesc(block),
            SharedLayerDesc("emb", nn.Embedding,
                            lambda m, x: x @ m.weight.t(), "weight", 32, 16,
                            **kw)]


def _ce(F):
    return lambda out, y: F.cross_entropy(out, y)


# -- the ranks -------------------------------------------------------------

def _fleet(hybrid, micro=MICRO):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {**strategy.hybrid_configs, **hybrid}
    strategy.pipeline_configs = {"accumulate_steps": micro}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet, fleet.get_hybrid_communicate_group()


def _stage_model(pt, descs, arrays, loss_fn, **kw):
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    pl = PipelineLayer(descs, num_stages=2, loss_fn=loss_fn, **kw)
    pt.load_numpy_state_dict(pl, {k: arrays[k] for k in pl.state_dict()})
    return pl


def _weights(pl):
    return {k: v.tolist() for k, v in pl.state_dict().items()}


def _run(pt, fleet, pl, data, opt=None, scaler=None, rows=slice(None)):
    model = fleet.distributed_model(pl)
    opt = opt or fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=LR, parameters=pl.parameters()))
    losses = [float(model.train_batch(
        (torch.tensor(x[rows]), torch.tensor(y[rows])), opt, scaler=scaler))
        for x, y in data]
    return model, losses


def _pp2(out, arrays):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.resilience.watchdog import StaleGeneration
    fleet, hcg = _fleet({"pp_degree": 2})
    out["stage"] = hcg.get_stage_id()
    # 1F1B parity, through CompiledStageProgram (the default) and eagerly
    for tag, flag in (("1f1b", True), ("1f1b_eager", False)):
        pt.set_flags({"FLAGS_compiled_step": flag})
        pl = _stage_model(pt, _port_descs(pt), arrays["mini"], _ce(F))
        model, losses = _run(pt, fleet, pl, _data())
        out[f"{tag}_losses"], out[f"{tag}_weights"] = losses, _weights(pl)
        st = model._engine.stats()
        out[f"{tag}_stats"] = {k: st[k] for k in (
            "compiled", "compiled_stages", "max_stashed", "units",
            "headers")}
    pt.set_flags({"FLAGS_compiled_step": True})
    out["names"] = sorted(pl.state_dict())
    # eval_batch with and without the loss, on the initial weights
    pl = _stage_model(pt, _port_descs(pt), arrays["mini"], _ce(F))
    model = fleet.distributed_model(pl)
    x, y = (torch.tensor(a) for a in _data(1)[0])
    out["eval_loss"] = float(model.eval_batch((x, y)))
    preds = model.eval_batch((x, y), compute_loss=False)
    out["eval_preds"] = None if preds is None else preds.tolist()
    # GradScaler and the global-norm clip over both stages; a disabled
    # scaler against none
    for tag, scaler, clip in (
            ("scaler", pt.amp.GradScaler(init_loss_scaling=SCALER_INIT),
             pt.nn.ClipGradByGlobalNorm(CLIP)),
            ("disabled", pt.amp.GradScaler(enable=False), None),
            ("noscaler", None, None)):
        fleet, _ = _fleet({"pp_degree": 2}, micro=2)
        pl = _stage_model(pt, _port_descs(pt), arrays["mini"], _ce(F))
        opt = fleet.distributed_optimizer(pt.optimizer.SGD(
            learning_rate=LR, parameters=pl.parameters(), grad_clip=clip))
        _, losses = _run(pt, fleet, pl, _data(1) * 2, opt=opt,
                         scaler=scaler)
        out[f"{tag}_losses"], out[f"{tag}_weights"] = losses, _weights(pl)
    # BatchNorm's running statistics move once a micro-batch
    pl = _stage_model(pt, [pt.nn.Linear(8, 8, device="cpu"),
                           pt.nn.BatchNorm1D(8, device="cpu"),
                           pt.nn.Linear(8, 4, device="cpu")],
                      arrays["bn"], _ce(F))
    model = fleet.distributed_model(pl)
    opt = pt.optimizer.SGD(learning_rate=0.05, parameters=pl.parameters())
    xb, yb = (torch.tensor(a) for a in _bn_data())
    out["bn_loss"] = float(model.train_batch((xb, yb), opt))
    out["bn_state"] = _weights(pl)
    # a tied layer on both stages
    fleet, _ = _fleet({"pp_degree": 2})
    pl = _stage_model(pt, _port_descs(pt, tied=True), arrays["tied"],
                      _ce(F))
    model, losses = _run(pt, fleet, pl, _data(2))
    out["tied_losses"], out["tied_weights"] = losses, _weights(pl)
    out["tied_shared"] = [(k, g.nranks) for k, _, g in pl._shared]
    # dropout through the recompute: the rerun draws the forward's masks
    out["dropout"] = _dropout_grads(pt, fleet, arrays["mini"])
    # a signature that changes mid-run: its header is sent again
    pl = _stage_model(pt, _port_descs(pt), arrays["mini"], _ce(F))
    model, losses = _run(pt, fleet, pl, _data(1) + _data(1, seq=4))
    out["resig_losses"] = losses
    out["resig_headers"] = model._engine.stats()["headers"]
    # the raises: a batch accumulate_steps does not divide; the fence
    with_raise = {}
    try:
        model.train_batch((torch.zeros(6, 6, dtype=torch.int64),
                           torch.zeros(6, 6, dtype=torch.int64)),
                          pt.optimizer.SGD(parameters=pl.parameters()))
    except ValueError as e:
        with_raise["ragged"] = str(e)
    calls = []

    def moved():
        calls.append(1)
        return 0 if len(calls) == 1 else 1
    model._engine._generation = moved
    try:
        model.train_batch(tuple(torch.tensor(a) for a in _data(1)[0]),
                          pt.optimizer.SGD(parameters=pl.parameters()))
    except StaleGeneration as e:
        with_raise["fence"] = str(e)
    out["raises"] = with_raise


def _dropout_grads(pt, fleet, arrays):
    """The mini-GPT with dropout 0.5 after the embedding (stage 0): one
    engine batch's gradients of this stage, and the same micro-batches
    through the whole model built on this rank, a forward with autograd
    and its backward, no recompute, from a generator at the same seed.
    The rerun must draw the forward's masks for the two to agree."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer

    def descs():
        d = _port_descs(pt)
        d.insert(1, pt.nn.Dropout(0.5, generator=torch.Generator()
                                  .manual_seed(5)))
        return d
    moved = {}
    for k, v in arrays.items():
        i, rest = k[len("run_function."):].split(".", 1)
        moved[f"run_function.{int(i) + (int(i) > 0)}.{rest}"] = v
    pl = _stage_model(pt, descs(), moved, _ce(F))
    model = fleet.distributed_model(pl)
    x, y = (torch.tensor(a) for a in _data(1)[0])
    model._engine.train_batch(x, y)
    whole = PipelineLayer(descs(), num_stages=1, loss_fn=_ce(F))
    pt.load_numpy_state_dict(whole, moved)
    M = model._engine.M
    for xm, ym in zip(x.chunk(M), y.chunk(M)):
        (F.cross_entropy(whole(xm), ym) / M).backward()
    plain = dict(whole.named_parameters())
    return {k: float((p.grad - plain[k].grad).abs().max())
            for k, p in pl.named_parameters()}


def _dp_pp(out, arrays):
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.nn.functional as F
    fleet, hcg = _fleet({"dp_degree": 2, "pp_degree": 2})
    d = hcg.get_data_parallel_rank()
    out["coords"] = [d, hcg.get_stage_id()]
    pl = _stage_model(pt, _port_descs(pt), arrays["mini"], _ce(F))
    _, losses = _run(pt, fleet, pl, _data(), rows=slice(8 * d, 8 * d + 8))
    g = torch.tensor(losses)
    dist.all_reduce(g, op=dist.ReduceOp.AVG,
                    group=hcg.get_data_parallel_group())
    out["dp_losses"], out["dp_weights"] = g.tolist(), _weights(pl)


class _GPTStages:
    """A GPT as pipeline descriptions from the port's GPT modules: the
    token table (shared with the head), positions, the blocks on
    ``(x, pending)``, the final LayerNorm, the tied head."""

    @staticmethod
    def descs(pt, cfg, device="cpu"):
        from paddle_tpu_torch.distributed.collective import _c_identity
        from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
        from paddle_tpu_torch.ops.fused_residual_ln import fused_residual_ln
        from paddle_tpu_torch.text.models.gpt import GPTBlock
        nn, F = pt.nn, pt.nn.functional

        class Positions(nn.Embedding):
            def forward(self, x):
                pos = torch.arange(x.shape[1], device=x.device)[None, :]
                return x + super().forward(pos), None

        class Block(GPTBlock):
            def forward(self, xp):
                return super().forward(*xp)

        class Final(nn.LayerNorm):
            def forward(self, xp):
                x, pending = xp
                if pending is None:
                    return super().forward(x)
                return fused_residual_ln(x, pending, self.weight, self.bias,
                                         epsilon=self._epsilon)

        def head(table, h):
            group = mpu._model_group()
            return F.linear(_c_identity(h, group), table.weight.t())
        kw = {"device": device}
        wte = mpu.VocabParallelEmbedding
        return ([mpu.SharedLayerDesc("wte", wte, None, "weight",
                                     cfg.vocab_size, cfg.hidden_size, **kw),
                 mpu.LayerDesc(Positions, cfg.max_position_embeddings,
                               cfg.hidden_size, **kw)]
                + [mpu.LayerDesc(Block, cfg, **kw)
                   for _ in range(cfg.num_layers)]
                + [mpu.LayerDesc(Final, cfg.hidden_size, **kw),
                   mpu.SharedLayerDesc("wte", wte, head, "weight",
                                       cfg.vocab_size, cfg.hidden_size,
                                       **kw)])

    @staticmethod
    def names(arrays, layers):
        """The GPT's state under the pipeline's names."""
        out = {}
        for k, v in arrays.items():
            if k == "gpt.wte.weight":
                out["run_function.0.weight"] = v
            elif k == "gpt.wpe.weight":
                out["run_function.1.weight"] = v
            elif k.startswith("gpt.h."):
                i, rest = k[len("gpt.h."):].split(".", 1)
                out[f"run_function.{2 + int(i)}.{rest}"] = v
            elif k.startswith("gpt.ln_f."):
                out[f"run_function.{2 + layers}.{k[len('gpt.ln_f.'):]}"] = v
        return out

    @staticmethod
    def loss(mp_group=None):
        from paddle_tpu_torch.distributed.fleet.meta_parallel import \
            ParallelCrossEntropy
        ce = ParallelCrossEntropy(mp_group=mp_group)
        return lambda logits, y: ce(logits.float(), y).mean()


def _pp_mp(out, arrays):
    import hashlib

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.text.models.gpt import GPTConfig
    fleet, hcg = _fleet({"pp_degree": 2, "mp_degree": 2}, micro=GPT_MICRO)
    out["tp_coords"] = [hcg.get_stage_id(), hcg.get_model_parallel_rank()]
    cfg = GPTConfig(tensor_parallel=True, **GPT_CFG)
    pl = _stage_model(pt, _GPTStages.descs(pt, cfg),
                      _GPTStages.names(arrays["gpt"], cfg.num_layers),
                      _GPTStages.loss())
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=pl.parameters()))
    xs, ys = _gpt_stream()
    losses, shas = [], []
    for i in range(GPT_STEPS):
        losses.append(float(model.train_batch(
            (torch.tensor(xs[i]), torch.tensor(ys[i])), opt)))
        h = hashlib.sha1()
        for _, p in sorted(pl.named_parameters()):
            if getattr(p, "tp_split", None) is None:
                h.update(p.detach().numpy().tobytes())
        shas.append(h.hexdigest())
    out["tp_losses"], out["tp_replicated_sha"] = losses, shas
    wte = pl.run_function[0].weight
    out["tp_wte_sha"] = hashlib.sha1(wte.detach().numpy().tobytes()) \
        .hexdigest()
    st = model._engine.stats()
    out["tp_stats"] = {k: st[k] for k in ("compiled", "compiled_stages",
                                          "eager_reason")}


def _worker(world):
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()
    rank = dist.get_rank()
    with open(os.path.join(os.environ["DIST_TMP"], "arrays.json")) as f:
        arrays = {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
                  for k, d in json.load(f).items()}
    out = {"rank": rank}
    if world == 2:
        _pp2(out, arrays)
    else:
        _dp_pp(out, arrays)
        _pp_mp(out, arrays)
    with open(os.path.join(os.environ["DIST_TMP"], f"rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


# -- the test process: the reference -----------------------------------------

def _arrays(layer):
    return {k: np.asarray(v._val, np.float32)
            for k, v in layer.state_dict().items()}


def _ref_descs():
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    paddle.seed(21)

    def block():
        return nn.Sequential(nn.Linear(16, 16), nn.Tanh())
    return [nn.Embedding(32, 16), block(), block(), nn.Linear(16, 32)]


def _ref_pipe(descs, stages, micro):
    """The reference's PipelineParallel over ``descs``; at two stages its
    engine is the eager ``PipelineEngine(compiled=False)``."""
    import paddle_tpu.nn.functional as F
    from paddle_tpu.distributed import fleet as rfleet
    from paddle_tpu.distributed.fleet.meta_parallel import (
        PipelineLayer, PipelineParallel)
    from paddle_tpu.distributed.fleet.pipeline_engine import PipelineEngine
    strategy = rfleet.DistributedStrategy()
    strategy.pipeline_configs = {"accumulate_steps": micro}
    model = PipelineLayer(descs, num_stages=stages,
                          loss_fn=lambda o, y: F.cross_entropy(o, y))
    pp = PipelineParallel(model, None, strategy)
    if stages > 1:
        pp._engine = PipelineEngine(model, num_microbatches=micro,
                                    compiled=False)
    return model, pp


def _ref_train(model, pp, data, scaler=None, clip=None, lr=LR):
    import paddle_tpu as paddle
    opt = paddle.optimizer.SGD(learning_rate=lr,
                               parameters=model.parameters(),
                               grad_clip=clip)
    losses = [float(pp.train_batch((paddle.to_tensor(x.astype("int32")),
                                    paddle.to_tensor(y)), opt,
                                   scaler=scaler))
              for x, y in data]
    return losses, _arrays(model)


def _ref_tied(arrays, data):
    """The tied model written out in the reference: the embedding's table
    is the head's; micro-batch accumulation with SGD."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as F

    class Tied(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = nn.Embedding(32, 16)
            self.b1 = nn.Sequential(nn.Linear(16, 16), nn.Tanh())
            self.b2 = nn.Sequential(nn.Linear(16, 16), nn.Tanh())

        def forward(self, x):
            h = self.b2(self.b1(self.emb(x)))
            return paddle.matmul(h, self.emb.weight, transpose_y=True)
    net = Tied()
    names = {"emb.weight": "run_function.0.weight"}
    for i, b in ((1, "b1"), (2, "b2")):
        for leaf in ("weight", "bias"):
            names[f"{b}.0.{leaf}"] = f"run_function.{i}.0.{leaf}"
    net.set_state_dict({k: paddle.to_tensor(arrays[v])
                        for k, v in names.items()})
    opt = paddle.optimizer.SGD(learning_rate=LR,
                               parameters=net.parameters())
    losses = []
    for x, y in data:
        total = 0.0
        for m in range(MICRO):
            rows = slice(4 * m, 4 * m + 4)
            loss = F.cross_entropy(net(paddle.to_tensor(
                x[rows].astype("int32"))), paddle.to_tensor(y[rows]))
            (loss / MICRO).backward()
            total += float(loss)
        opt.step()
        opt.clear_grad()
        losses.append(total / MICRO)
    return losses, {names[k]: v for k, v in _arrays(net).items()}


def _ref_gpt_losses():
    import paddle_tpu as paddle
    from paddle_tpu.text.models.gpt import GPTConfig, GPTForCausalLM
    paddle.seed(0)
    ref = GPTForCausalLM(GPTConfig(**GPT_CFG))
    arrays = _arrays(ref)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=ref.parameters())
    losses = []
    for x, y in zip(*_gpt_stream()):
        loss = ref(paddle.to_tensor(x.astype("int32")),
                   labels=paddle.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return arrays, losses


def _reference():
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as F
    from paddle_tpu.amp import GradScaler
    res, arrays = {}, {}
    model, pp = _ref_pipe(_ref_descs(), 2, MICRO)
    arrays["mini"] = _arrays(model)
    res["1f1b"] = _ref_train(model, pp, _data())
    model, pp = _ref_pipe(_ref_descs(), 1, MICRO)
    res["serial"] = _ref_train(model, pp, _data())
    model, pp = _ref_pipe(_ref_descs(), 2, MICRO)
    x, y = _data(1)[0]
    res["eval_loss"] = float(pp.eval_batch((paddle.to_tensor(
        x.astype("int32")), paddle.to_tensor(y))))
    res["eval_preds"] = np.asarray(pp._engine.eval_batch(
        x.astype("int32"), compute_loss=False)._val)
    for tag, scaler, clip in (
            ("scaler", GradScaler(init_loss_scaling=SCALER_INIT),
             nn.ClipGradByGlobalNorm(CLIP)),
            ("noscaler", None, None)):
        model, pp = _ref_pipe(_ref_descs(), 2, 2)
        res[tag] = _ref_train(model, pp, _data(1) * 2, scaler=scaler,
                              clip=clip)
    paddle.seed(3)
    model, pp = _ref_pipe([nn.Linear(8, 8), nn.BatchNorm1D(8),
                           nn.Linear(8, 4)], 2, 2)
    arrays["bn"] = _arrays(model)
    xb, yb = _bn_data()
    opt = paddle.optimizer.SGD(learning_rate=0.05,
                               parameters=model.parameters())
    res["bn_loss"] = float(pp.train_batch((paddle.to_tensor(xb),
                                           paddle.to_tensor(yb)), opt))
    res["bn_state"] = _arrays(model)
    arrays["tied"] = {k: v for k, v in arrays["mini"].items()
                      if not k.startswith("run_function.3")}
    res["tied"] = _ref_tied(arrays["tied"], _data(2))
    model, pp = _ref_pipe(_ref_descs(), 2, MICRO)
    res["resig"] = _ref_train(model, pp, _data(1) + _data(1, seq=4))[0]
    arrays["gpt"], res["gpt_losses"] = _ref_gpt_losses()
    return res, arrays


def _spawn(world, tmp, timeout=300):
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
    res = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


@pytest.fixture(scope="module")
def reference():
    return _reference()


def _launch(world, tmp, arrays):
    with open(os.path.join(tmp, "arrays.json"), "w") as f:
        json.dump({k: {n: v.tolist() for n, v in d.items()}
                   for k, d in arrays.items()}, f)
    return _spawn(world, tmp)


@pytest.fixture(scope="module")
def two(reference, tmp_path_factory):
    return _launch(2, tmp_path_factory.mktemp("pp2"), reference[1])


@pytest.fixture(scope="module")
def four(reference, tmp_path_factory):
    return _launch(4, tmp_path_factory.mktemp("pp4"), reference[1])


def _merged(ranks, key):
    """The stages' weights under one dict (a shared name from either)."""
    out = {}
    for r in ranks:
        out.update(r[key])
    return out


def _assert_weights(got, want, **tol):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **(tol or dict(rtol=RTOL,
                                                            atol=ATOL)),
                                   err_msg=k)


# -- pure functions ---------------------------------------------------------

@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("M", [1, 2, 4, 8])
def test_unit_order_matches_the_reference(S, M):
    from paddle_tpu.distributed.fleet.pipeline_engine import \
        PipelineEngine as RefEngine

    from paddle_tpu_torch.distributed.fleet.pipeline_engine import \
        unit_order
    ref = RefEngine.__new__(RefEngine)
    ref.S, ref.M = S, M
    want = ref._unit_order()
    got = unit_order(S, M)
    assert [list(q) for q in got] == [list(q) for q in want]
    for s, q in enumerate(got):
        stashed = peak = 0
        for unit in q:
            stashed += 1 if unit == "F" else -1
            peak = max(peak, stashed)
        assert stashed == 0 and peak <= S - s, (s, list(q))


@pytest.mark.parametrize("k", [2, 3])
def test_segmentation_cuts_where_the_reference_does(k):
    import paddle_tpu as paddle
    import paddle_tpu.nn as rnn
    from paddle_tpu.distributed.fleet import pipeline_engine as ref

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet import pipeline_engine as port
    sizes = [(32, 16), (16, 16), (16, 64), (64, 16), (16, 16), (16, 32)]
    paddle.seed(0)
    rl = [rnn.Linear(a, b) for a, b in sizes] + [rnn.Tanh()]
    pl = [pt.nn.Linear(a, b, device="cpu") for a, b in sizes] + \
        [pt.nn.Tanh()]
    items = list(range(7))
    assert [len(s) for s in port._segment_uniform(items, k)] == \
        [len(s) for s in ref._segment_uniform(items, k)]
    assert [len(s) for s in port._segment_by_params(pl, k)] == \
        [len(s) for s in ref._segment_by_params(rl, k)]


def test_stage_counts_are_checked():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineLayer, PipelineParallel)
    with pytest.raises(ValueError, match="exceeds layer count"):
        PipelineLayer([pt.nn.Tanh()], num_stages=2)
    # no pipe axis of two ranks: built whole, and the engine refuses it
    pl = PipelineLayer([pt.nn.Tanh(), pt.nn.Tanh()], num_stages=2)
    assert pl.stage_id is None and len(pl.run_function) == 2
    with pytest.raises(ValueError, match="must equal the 'pipe' mesh axis"):
        PipelineParallel(pl, None)


def test_compiled_stage_program_keys_and_counters_on_the_host():
    """On the host a built stage program runs its body: the keys, the
    build and the cache hits are counted as on the card."""
    from paddle_tpu_torch.jit.compiled_step import (
        CompiledStageProgram, compile_stats, reset_compile_stats)
    calls = []

    def body(x, y):
        calls.append(tuple(x.shape))
        return x * 2 + y
    prog = CompiledStageProgram(body, label="pp.s0.fwd")
    reset_compile_stats()
    a, b = torch.ones(2, 3), torch.zeros(2, 3)
    for _ in range(4):
        torch.testing.assert_close(prog(a, b), a * 2)
    prog(torch.ones(5, 3), torch.zeros(5, 3))
    st = prog.stats()
    assert st["signatures"] == 2 and st["built"] == 1 and st["hits"] == 2
    assert st["captured"] == 0
    assert compile_stats()["compiles"] == 1
    assert compile_stats()["cache_hits"] == 2
    assert len(calls) == 5       # every call ran the body: no CPU graphs


# -- 1F1B against the reference ----------------------------------------------

def test_1f1b_matches_the_reference_engine_and_serial_steps(two, reference):
    res = reference[0]
    for tag in ("1f1b", "1f1b_eager"):
        for r in range(2):
            np.testing.assert_allclose(two[r][f"{tag}_losses"],
                                       res["1f1b"][0], rtol=RTOL)
            np.testing.assert_allclose(two[r][f"{tag}_losses"],
                                       res["serial"][0], rtol=RTOL)
        got = _merged(two, f"{tag}_weights")
        _assert_weights(got, res["1f1b"][1])
        _assert_weights(got, res["serial"][1])
    assert two[0]["1f1b_stats"]["compiled_stages"] == [0, 1]
    assert two[0]["1f1b_eager_stats"]["compiled_stages"] == []


def test_stages_hold_their_segment_under_global_names(two, reference):
    assert [two[r]["stage"] for r in range(2)] == [0, 1]
    assert two[0]["names"] == ["run_function.0.weight",
                               "run_function.1.0.bias",
                               "run_function.1.0.weight"]
    assert set(two[0]["names"]) | set(two[1]["names"]) == \
        set(reference[1]["mini"])


def test_stash_stays_within_s_minus_s(two):
    for r in range(2):
        st = two[r]["1f1b_stats"]
        assert st["max_stashed"] <= 2 - r
        assert st["units"] == 2 * MICRO * STEPS


def test_eval_batch_with_and_without_the_loss(two, reference):
    res = reference[0]
    for r in range(2):
        np.testing.assert_allclose(two[r]["eval_loss"], res["eval_loss"],
                                   rtol=RTOL)
    assert two[0]["eval_preds"] is None
    np.testing.assert_allclose(two[1]["eval_preds"], res["eval_preds"],
                               rtol=RTOL, atol=ATOL)


def test_grad_scaler_and_global_norm_clip_over_both_stages(two, reference):
    losses, weights = reference[0]["scaler"]
    for r in range(2):
        np.testing.assert_allclose(two[r]["scaler_losses"], losses,
                                   rtol=RTOL)
    _assert_weights(_merged(two, "scaler_weights"), weights)


def test_disabled_scaler_equals_no_scaler(two, reference):
    assert _merged(two, "disabled_weights") == \
        _merged(two, "noscaler_weights")
    _assert_weights(_merged(two, "noscaler_weights"),
                    reference[0]["noscaler"][1])


def test_bn_running_stats_move_through_the_engine(two, reference):
    res = reference[0]
    for r in range(2):
        np.testing.assert_allclose(two[r]["bn_loss"], res["bn_loss"],
                                   rtol=RTOL)
    got = _merged(two, "bn_state")
    _assert_weights(got, res["bn_state"])
    assert not np.allclose(got["run_function.1._mean"],
                           reference[1]["bn"]["run_function.1._mean"])


def test_tied_layer_gradient_is_summed_over_its_stages(two, reference):
    losses, weights = reference[0]["tied"]
    for r in range(2):
        assert two[r]["tied_shared"] == [["emb", 2]]
        np.testing.assert_allclose(two[r]["tied_losses"], losses,
                                   rtol=RTOL)
    # both copies of the table stay bitwise equal
    assert two[0]["tied_weights"]["run_function.0.weight"] == \
        two[1]["tied_weights"]["run_function.0.weight"]
    _assert_weights(_merged(two, "tied_weights"), weights)


def test_recompute_draws_the_forwards_dropout_masks(two):
    """Each stage's gradients through the engine (forward without
    autograd, a rerun in the backward) equal the same model's without
    recompute, dropout 0.5 on stage 0 drawing from one seed."""
    for r in range(2):
        gaps = two[r]["dropout"]
        assert gaps and max(gaps.values()) < 1e-6, gaps


def test_a_new_signature_sends_its_header_again(two, reference):
    for r in range(2):
        np.testing.assert_allclose(two[r]["resig_losses"],
                                   reference[0]["resig"], rtol=RTOL)
    # one header a signature in each direction: 2 sent, 2 received
    assert two[0]["resig_headers"] == {"next": [2, 2]}
    assert two[1]["resig_headers"] == {"prev": [2, 2]}


def test_ragged_batch_and_generation_fence_raise(two):
    for r in range(2):
        assert "not divisible by accumulate_steps" in \
            two[r]["raises"]["ragged"]
        assert "stale generation 0" in two[r]["raises"]["fence"]


# -- four ranks ---------------------------------------------------------------

def test_dp2_pp2_matches_the_reference(four, reference):
    res = reference[0]
    assert sorted(tuple(r["coords"]) for r in four) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in four:
        np.testing.assert_allclose(r["dp_losses"], res["1f1b"][0],
                                   rtol=RTOL)
    for d in range(2):
        ranks = [r for r in four if r["coords"][0] == d]
        _assert_weights(_merged(ranks, "dp_weights"), res["1f1b"][1])
        _assert_weights(_merged(ranks, "dp_weights"), res["serial"][1])


def test_tp_gpt_in_the_pipeline_follows_the_serial_steps(four, reference):
    want = reference[0]["gpt_losses"]
    assert sorted(tuple(r["tp_coords"]) for r in four) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in four:
        gaps = [abs(a - b) / abs(b) for a, b in zip(r["tp_losses"], want)]
        assert len(gaps) == GPT_STEPS and max(gaps) < LOSS_RTOL, gaps
        # under mp > 1 the stages run eagerly, and say why
        assert r["tp_stats"]["compiled_stages"] == []
        assert "mp_degree 2" in (r["tp_stats"]["eager_reason"] or "")
    by = {tuple(r["tp_coords"]): r for r in four}
    for s in range(2):
        assert by[s, 0]["tp_replicated_sha"] == by[s, 1]["tp_replicated_sha"]
    # the tied table's shards: each model rank's the same on both stages
    for m in range(2):
        assert by[0, m]["tp_wte_sha"] == by[1, m]["tp_wte_sha"]


# -- entry point of a rank -------------------------------------------------

if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[2]))
