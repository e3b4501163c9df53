"""Fleet's hybrid parallelism of the PyTorch/CUDA port on the host, against
the JAX reference's serial models with the same weights.

Ranks are real processes joined by gloo (``init_parallel_env`` over a
free localhost port), each running this file as a script (``--worker``);
one spawn of 2 ranks (mp 2, then sharding 2) and one of 4 (dp 2 x mp 2,
then dp 2 x sharding 2) carry every check, and the ranks write their
observations as JSON for the test process to compare. The reference runs
only in the test process, and the reference's TP is GSPMD over full
parameters, so its serial model is the parity target, as in its own
tests (tests/test_hybrid_parallel.py:175-214, __graft_entry__.py:120-158):

- the four TP layers in a classifier (vocab-parallel embedding,
  column-parallel, row-parallel, column-parallel head with
  ``gather_output=False``, ``ParallelCrossEntropy``): loss and every
  gradient; ``gather_output=True`` and a row-parallel layer that splits
  its input, against the full matmul;
- a TP GPT in f32 (2 layers, hidden 64, 4 heads, vocab 256) under
  ``fleet.init``/``distributed_model``/``distributed_optimizer``: 3
  AdamW steps' losses at mp 2 and at dp 2 x mp 2 (5e-4 relative, as
  __graft_entry__.py:151-155), the first step's gathered gradients, the
  replicated parameters bitwise equal across ranks; prefill plus 4
  cached greedy steps token for token; a global-norm clip and a
  per-parameter norm clip under TP against the serial clips; the shard
  and gather of the reference's full arrays, bitwise;
- ZeRO-1 with Adam and with bf16 parameters and f32 masters against the
  reference's unsharded runs, each rank holding state only for its
  partition;
- ``ParallelCrossEntropy`` takes the local vocabulary shard, where the
  reference's takes the gathered logits (ROADMAP C-ref-22);
- a GradScaler under TP and under ZeRO-1 with an inf planted in one
  rank's gradient shard: every rank skips that step and halves its scale,
  and the clean step after it gives the reference's SGD step.
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
GPT_CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_position_embeddings=64, dropout=0.0)
GPT_STEPS, GPT_BATCH, GPT_SEQ = 3, 4, 16
DECODE_PROMPT, DECODE_STEPS = (2, 8), 4
CLIP_NORM, CLIP_LR = 0.05, 0.5
CLS = dict(vocab=32, dim=16, hidden=32)
CLS_SHAPE = (8, 6)
PCE_ROWS, PCE_CLASSES = 6, 8
LOSS_RTOL = 5e-4                       # __graft_entry__.py:151-155
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_hybrid_parallel.py:206
ZERO_TOL = dict(rtol=1e-5, atol=1e-7)  # tests/test_hybrid_parallel.py:290
SCALER_INIT, SCALER_LR = 1024.0, 0.1


# -- the ranks -------------------------------------------------------------

def _fleet(hybrid):
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {**strategy.hybrid_configs, **hybrid}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet, fleet.get_hybrid_communicate_group()


def _full_grads(model):
    from paddle_tpu_torch.framework.io_utils import unshard
    out = {}
    for name, p in model.named_parameters():
        split = getattr(p, "tp_split", None)
        g = unshard(p.grad, split) if split is not None else p.grad
        out[name] = g.tolist()
    return out


def _members(group):
    return [group.global_rank(i) for i in range(group.nranks)]


def _sha(tensors):
    import hashlib
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


class _TPClassifier(torch.nn.Module):
    """tests/test_hybrid_parallel.py's classifier with the head's
    ``gather_output=False``: the port's ParallelCrossEntropy takes the
    local vocabulary shard."""

    def __init__(self):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
            VocabParallelEmbedding)
        v, d, h = CLS["vocab"], CLS["dim"], CLS["hidden"]
        self.emb = VocabParallelEmbedding(v, d, device="cpu")
        self.fc1 = ColumnParallelLinear(d, h, gather_output=False,
                                        device="cpu")
        self.fc2 = RowParallelLinear(h, d, input_is_parallel=True,
                                     device="cpu")
        self.head = ColumnParallelLinear(d, v, gather_output=False,
                                         device="cpu")
        self.loss_fn = ParallelCrossEntropy()

    def forward(self, ids, labels):
        h = torch.relu(self.fc1(self.emb(ids)))
        return self.loss_fn(self.head(self.fc2(h)), labels).mean()


def _tp_layers(out, arrays):
    """The classifier's loss and gathered grads; gather_output=True and a
    row-parallel layer splitting its input against the full matmul."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear)
    model = _TPClassifier()
    pt.load_numpy_state_dict(model, arrays)
    ids, labels = _cls_data()
    loss = model(torch.tensor(ids), torch.tensor(labels))
    loss.backward()
    out["cls_loss"] = loss.item()
    out["cls_grads"] = _full_grads(model)
    rng = np.random.RandomState(12)
    x = torch.tensor(rng.randn(3, 5, 16).astype("float32"))
    w = torch.tensor(rng.randn(16, 8).astype("float32"))
    b = torch.tensor(rng.randn(8).astype("float32"))
    col = ColumnParallelLinear(16, 8, gather_output=True, device="cpu")
    row = RowParallelLinear(16, 8, input_is_parallel=False, device="cpu")
    errs = {}
    for name, layer, wt in (("col", col, w), ("row", row, w)):
        pt.load_numpy_state_dict(layer, {"weight": wt, "bias": b})
        xi = x.clone().requires_grad_()
        y = layer(xi)
        (y * torch.arange(8.0)).sum().backward()
        xr = x.clone().requires_grad_()
        yr = xr @ wt + b
        (yr * torch.arange(8.0)).sum().backward()
        errs[name] = [float((y - yr).abs().max().detach()),
                      float((xi.grad - xr.grad).abs().max()),
                      list(y.shape)]
    out["layer_errs"] = errs


def _pce(out, group):
    """The local shard of the logits through ParallelCrossEntropy: row
    losses and this shard's logit gradient."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        ParallelCrossEntropy
    logits, labels = _pce_data()
    n = PCE_CLASSES // group.nranks
    x = torch.tensor(logits[:, group.rank * n:(group.rank + 1) * n],
                     requires_grad=True)
    loss = ParallelCrossEntropy(ignore_index=-1)(x, torch.tensor(labels))
    loss.sum().backward()
    out["pce_loss"] = loss.tolist()
    out["pce_grad"] = x.grad.tolist()


def _gpt(arrays, hcg, **extra):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(tensor_parallel=True, **GPT_CFG,
                                     **extra), device="cpu")
    pt.load_numpy_state_dict(model, arrays)
    return model


def _replicated(model):
    return [p for p in model.parameters()
            if getattr(p, "tp_split", None) is None]


def _gpt_steps(out, arrays, fleet, hcg):
    """3 AdamW steps through fleet's entry points on this data rank's
    rows; the global losses, the first step's gathered gradients, the
    replicated parameters' SHA-1 after every step and the round trip of
    the full arrays."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import ReduceOp, all_reduce
    model = _gpt(arrays, hcg)
    full = pt.full_state_dict(model)
    out["round_trip"] = sorted(full) == sorted(arrays) and all(
        np.array_equal(full[k].numpy(), arrays[k]) for k in arrays)
    out["local_shapes"] = {k: list(v.shape)
                           for k, v in model.state_dict().items()}
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.AdamW(
        learning_rate=1e-3, parameters=model.parameters()))
    dp, d = hcg.get_data_parallel_world_size(), hcg.get_data_parallel_rank()
    per = GPT_BATCH // dp
    xs, ys = _gpt_stream()
    losses, shas = [], []
    for i in range(GPT_STEPS):
        loss = dist_model(torch.tensor(xs[i, d * per:(d + 1) * per]),
                          labels=torch.tensor(ys[i, d * per:(d + 1) * per]))
        loss.backward()
        if i == 0:
            out["gpt_grads"] = _full_grads(model)
        opt.step()
        opt.clear_grad()
        g = loss.detach().reshape(1).clone()
        all_reduce(g, op=ReduceOp.AVG, group=hcg.get_data_parallel_group())
        losses.append(g.item())
        shas.append(_sha(_replicated(model)))
    out["gpt_losses"] = losses
    out["replicated_sha"] = shas
    out["full_sha"] = _sha(pt.full_state_dict(model).values())
    out["wrapped"] = [type(dist_model).__name__, type(opt).__name__]


def _wrap_broadcast(out, fleet, rank):
    """A TP GPT whose initial weights differ by rank: after
    distributed_model the replicated parameters are rank 0's on every
    rank (SHA-1), the shards still each rank's own."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(tensor_parallel=True, **GPT_CFG),
                           device="cpu",
                           generator=torch.Generator().manual_seed(rank))
    fleet.distributed_model(model)
    out["wrap_replicated_sha"] = _sha(_replicated(model))
    out["wrap_shard_sha"] = _sha(p for p in model.parameters()
                                 if getattr(p, "tp_split", None) is not None)


def _decode(out, arrays, hcg):
    """Greedy prefill and DECODE_STEPS cached steps under TP."""
    model = _gpt(arrays, hcg)
    model.eval()
    ids = torch.tensor(_decode_prompt())
    toks = []
    with torch.no_grad():
        logits, caches = model(ids, caches=model.gpt.init_decode_caches())
        for _ in range(DECODE_STEPS):
            nxt = logits[:, -1].argmax(-1)
            toks.append(nxt.tolist())
            logits, caches = model(nxt[:, None], caches=caches)
    out["decode_tokens"] = toks
    out["decode_cache_heads"] = caches[0][0].shape[2]


def _clip(out, arrays, fleet, hcg, clip="ClipGradByGlobalNorm",
          key="clip_delta"):
    """One SGD step under ``clip`` through fleet: the full weights'
    change."""
    import paddle_tpu_torch as pt
    model = _gpt(arrays, hcg)
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=CLIP_LR, parameters=model.parameters(),
        grad_clip=getattr(pt.nn, clip)(CLIP_NORM)))
    xs, ys = _gpt_stream()
    dist_model(torch.tensor(xs[0]), labels=torch.tensor(ys[0])).backward()
    opt.step()
    after = pt.full_state_dict(model)
    out[key] = {k: (after[k].numpy() - arrays[k]).tolist()
                for k in arrays}


def _scaler_steps(out, tag, net, loss_fn, opt, planted, rank):
    """Two GradScaler steps through fleet's optimizer, the first with an
    inf planted in ``planted``'s gradient on rank 1 only (after the
    gradients were reduced): whether that step left every weight as it
    was, the scale after each step, the full weights after both."""
    import paddle_tpu_torch as pt
    scaler = pt.amp.GradScaler(init_loss_scaling=SCALER_INIT)
    before = _sha(net.parameters())
    scales = []
    for i in range(2):
        scaler.scale(loss_fn()).backward()
        if i == 0 and rank == 1:
            planted.grad.view(-1)[0] = float("inf")
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        scales.append(float(scaler.get_loss_scaling()))
        if i == 0:
            out[f"{tag}_skip_unchanged"] = _sha(net.parameters()) == before
    out[f"{tag}_scales"] = scales
    out[f"{tag}_weights"] = {k: v.tolist()
                             for k, v in pt.full_state_dict(net).items()}


def _scaler_tp(out, arrays, fleet, rank):
    """The TP classifier under a GradScaler, the inf in rank 1's shard of
    fc1's column-split weight."""
    import paddle_tpu_torch as pt
    model = _TPClassifier()
    pt.load_numpy_state_dict(model, arrays)
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=SCALER_LR, parameters=model.parameters()))
    ids, labels = (torch.tensor(a) for a in _cls_data())
    _scaler_steps(out, "scaler_tp", model,
                  lambda: dist_model(ids, labels), opt, model.fc1.weight,
                  rank)


def _scaler_zero(out, arrays, fleet, rank):
    """The MLP under ZeRO-1 and a GradScaler, the inf in the gradient of
    a parameter rank 1 owns (the second), on rank 1 only."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    net = _mlp(pt, False)
    pt.load_numpy_state_dict(net, arrays)
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=SCALER_LR, parameters=net.parameters()))
    xs, ys = _zero_data()
    x, y = torch.tensor(xs[0]), torch.tensor(ys[0])
    _scaler_steps(out, "scaler_zero", net,
                  lambda: F.cross_entropy(model(x), y), opt,
                  list(net.parameters())[1], rank)


def _mlp(pt, bf16):
    gen = pt.make_generator(9)
    net = pt.nn.Sequential(pt.nn.Linear(8, 32, device="cpu", generator=gen),
                           pt.nn.ReLU(),
                           pt.nn.Linear(32, 4, device="cpu", generator=gen))
    return net.bfloat16() if bf16 else net


def _adam_steps(pt, net, model, opt, bf16, rows=slice(None)):
    import paddle_tpu_torch.nn.functional as F
    for x, y in zip(*_zero_data()):
        x, y = torch.tensor(x[rows]), y[rows]
        logits = model(x.bfloat16() if bf16 else x)
        F.cross_entropy(logits.float(), torch.tensor(y)).backward()
        opt.step()
        opt.clear_grad()
    return {k: v.float().tolist() for k, v in net.state_dict().items()}


def _zero(out, arrays, fleet, hcg, tag):
    """ZeRO-1 through fleet: Adam in f32, then bf16 parameters with f32
    masters, every rank on the reference test's full batch; the weights
    after 3 steps, the same steps' weights without fleet, and which
    parameters hold state on this rank."""
    import paddle_tpu_torch as pt
    for bf16 in (False, True):
        key = f"{tag}_{'mp' if bf16 else 'f32'}"
        net = _mlp(pt, bf16)
        pt.load_numpy_state_dict(net, arrays)
        out[key + "_plain"] = _adam_steps(pt, net, net, pt.optimizer.Adam(
            learning_rate=1e-2, parameters=net.parameters(),
            multi_precision=bf16), bf16)
        net = _mlp(pt, bf16)
        pt.load_numpy_state_dict(net, arrays)
        model = fleet.distributed_model(net)
        opt = fleet.distributed_optimizer(pt.optimizer.Adam(
            learning_rate=1e-2, parameters=net.parameters(),
            multi_precision=bf16))
        out[key + "_weights"] = _adam_steps(pt, net, model, opt, bf16)
        inner = opt._inner._inner
        params = list(net.parameters())
        index = {id(p): i for i, p in enumerate(params)}
        out[key + "_owned"] = [index[id(p)]
                               for p in opt._inner.owned_parameters]
        out[key + "_state"] = {
            name: sorted(i for i, p in enumerate(params) if id(p) in accs)
            for name, accs in inner._accumulators.items()}
        out[key + "_masters"] = [
            i for i, p in enumerate(params)
            if id(p) in inner._accumulators.get("master_weight", {})]
        out[key + "_wrapped"] = [type(model).__name__, type(opt).__name__,
                                 type(opt._inner).__name__]
    # each rank on its rows of the batch: the gradients must be reduced
    group = hcg.get_dp_sharding_parallel_group()
    per = 8 // group.nranks
    net = _mlp(pt, False)
    pt.load_numpy_state_dict(net, arrays)
    model = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(pt.optimizer.Adam(
        learning_rate=1e-2, parameters=net.parameters()))
    out[f"{tag}_split_weights"] = _adam_steps(
        pt, net, model, opt, False,
        slice(group.rank * per, (group.rank + 1) * per))


def _worker(world):
    import paddle_tpu_torch.distributed as dist
    dist.init_parallel_env()
    rank = dist.get_rank()
    with open(os.path.join(os.environ["DIST_TMP"], "arrays.json")) as f:
        arrays = {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
                  for k, d in json.load(f).items()}
    out = {"rank": rank, "world": dist.get_world_size()}
    if world == 2:
        fleet, hcg = _fleet({"mp_degree": 2})
        out["hcg"] = [hcg.get_parallel_mode(),
                      hcg.get_model_parallel_rank(),
                      _members(hcg.get_model_parallel_group()),
                      _members(hcg.get_data_parallel_group())]
        _tp_layers(out, arrays["cls"])
        _pce(out, hcg.get_model_parallel_group())
        _gpt_steps(out, arrays["gpt"], fleet, hcg)
        _wrap_broadcast(out, fleet, rank)
        _decode(out, arrays["gpt"], hcg)
        _clip(out, arrays["gpt"], fleet, hcg)
        _clip(out, arrays["gpt"], fleet, hcg, "ClipGradByNorm",
              "clip_norm_delta")
        _scaler_tp(out, arrays["cls"], fleet, rank)
        fleet, hcg = _fleet({"sharding_degree": 2})
        _zero(out, arrays["mlp"], fleet, hcg, "zero")
        _scaler_zero(out, arrays["mlp"], fleet, rank)
    else:
        fleet, hcg = _fleet({"dp_degree": 2, "mp_degree": 2})
        out["hcg"] = [hcg.get_parallel_mode(),
                      hcg.get_data_parallel_rank(),
                      hcg.get_model_parallel_rank(),
                      _members(hcg.get_data_parallel_group()),
                      _members(hcg.get_model_parallel_group()),
                      _members(hcg.get_dp_sharding_parallel_group())]
        _gpt_steps(out, arrays["gpt"], fleet, hcg)
        fleet, hcg = _fleet({"dp_degree": 2, "sharding_degree": 2})
        out["hcg_zero"] = [hcg.get_parallel_mode(),
                           _members(hcg.get_sharding_parallel_group()),
                           _members(hcg.get_dp_sharding_parallel_group())]
        _zero(out, arrays["mlp"], fleet, hcg, "zero_dp")
    with open(os.path.join(os.environ["DIST_TMP"], f"rank{rank}.json"),
              "w") as f:
        json.dump(out, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


# -- inputs, shared by the ranks and the test process ------------------------

def _gpt_stream():
    rng = np.random.RandomState(3)
    shape = (GPT_STEPS, GPT_BATCH, GPT_SEQ)
    return (rng.randint(0, GPT_CFG["vocab_size"], shape).astype("int32"),
            rng.randint(0, GPT_CFG["vocab_size"], shape).astype("int64"))


def _decode_prompt():
    return np.random.RandomState(8).randint(
        0, GPT_CFG["vocab_size"], DECODE_PROMPT).astype("int32")


def _cls_data():
    rng = np.random.RandomState(11)
    return (rng.randint(0, CLS["vocab"], CLS_SHAPE).astype("int32"),
            rng.randint(0, CLS["vocab"], CLS_SHAPE).astype("int64"))


def _pce_data():
    rng = np.random.RandomState(4)
    labels = rng.randint(0, PCE_CLASSES, PCE_ROWS).astype("int64")
    labels[2] = -1                      # an ignored row
    return rng.randn(PCE_ROWS, PCE_CLASSES).astype("float32"), labels


def _zero_data():
    rng = np.random.RandomState(2)
    return ([rng.randn(8, 8).astype("f4") for _ in range(3)],
            [rng.randint(0, 4, (8, 1)).astype("int64") for _ in range(3)])


# -- the test process: the reference's serial runs ---------------------------

def _arrays(layer):
    return {k: np.asarray(v._val, np.float32)
            for k, v in layer.state_dict().items()}


def _grads(layer):
    return {k: np.asarray(v.grad._val) for k, v in layer.state_dict().items()
            if v.grad is not None}


def _ref_classifier():
    """The reference test's serial classifier (tensor_parallel=False):
    embedding, two linears with a ReLU between, the head; its loss is the
    mean cross-entropy."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as F
    from paddle_tpu.tensor.math import mean

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            v, d, h = CLS["vocab"], CLS["dim"], CLS["hidden"]
            self.emb = nn.Embedding(v, d)
            self.fc1 = nn.Linear(d, h)
            self.fc2 = nn.Linear(h, d)
            self.head = nn.Linear(d, v)

        def forward(self, ids, labels):
            h = self.fc2(F.relu(self.fc1(self.emb(ids))))
            return mean(F.cross_entropy(self.head(h), labels,
                                        reduction="none"))
    paddle.seed(5)
    return Net()


def _ref_gpt():
    import paddle_tpu as paddle
    from paddle_tpu.text.models.gpt import GPTConfig as RefConfig
    from paddle_tpu.text.models.gpt import GPTForCausalLM as RefGPT
    paddle.seed(0)
    return RefGPT(RefConfig(**GPT_CFG))


def _reference():
    """Every serial run the ranks are held to, and the arrays they load."""
    import paddle_tpu as paddle
    import paddle_tpu.nn as nn
    import paddle_tpu.nn.functional as F
    res = {}
    cls = _ref_classifier()
    arrays = {"cls": _arrays(cls)}
    ids, labels = _cls_data()
    loss = cls(paddle.to_tensor(ids), paddle.to_tensor(labels))
    loss.backward()
    res["cls_loss"], res["cls_grads"] = float(loss), _grads(cls)

    ref = _ref_gpt()
    arrays["gpt"] = _arrays(ref)
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=ref.parameters())
    losses = []
    for i, (x, y) in enumerate(zip(*_gpt_stream())):
        loss = ref(paddle.to_tensor(x), labels=paddle.to_tensor(y))
        loss.backward()
        if i == 0:
            res["gpt_grads"] = _grads(ref)
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    res["gpt_losses"] = losses

    ref = _ref_gpt()
    ref.eval()
    logits, caches = ref(paddle.to_tensor(_decode_prompt()),
                         caches=ref.gpt.init_decode_caches())
    toks = []
    for _ in range(DECODE_STEPS):
        nxt = np.asarray(logits._val)[:, -1].argmax(-1)
        toks.append(nxt.tolist())
        logits, caches = ref(paddle.to_tensor(nxt[:, None].astype("int32")),
                             caches=caches)
    res["decode_tokens"] = toks

    ref = _ref_gpt()
    opt = paddle.optimizer.SGD(learning_rate=CLIP_LR,
                               parameters=ref.parameters(),
                               grad_clip=nn.ClipGradByGlobalNorm(CLIP_NORM))
    xs, ys = _gpt_stream()
    ref(paddle.to_tensor(xs[0]), labels=paddle.to_tensor(ys[0])).backward()
    opt.step()
    res["clip_delta"] = {k: v - arrays["gpt"][k]
                         for k, v in _arrays(ref).items()}
    ref = _ref_gpt()
    opt = paddle.optimizer.SGD(learning_rate=CLIP_LR,
                               parameters=ref.parameters(),
                               grad_clip=nn.ClipGradByNorm(CLIP_NORM))
    ref(paddle.to_tensor(xs[0]), labels=paddle.to_tensor(ys[0])).backward()
    opt.step()
    res["clip_norm_delta"] = {k: v - arrays["gpt"][k]
                              for k, v in _arrays(ref).items()}
    # the unclipped step's norm, so that the clip is known to bind
    ref = _ref_gpt()
    ref(paddle.to_tensor(xs[0]), labels=paddle.to_tensor(ys[0])).backward()
    res["grad_norm"] = float(np.sqrt(sum(
        (g.astype(np.float64) ** 2).sum() for g in _grads(ref).values())))

    for bf16 in (False, True):
        paddle.seed(9)
        net = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 4))
        if not bf16:
            arrays["mlp"] = _arrays(net)
        else:
            net.set_state_dict({k: paddle.to_tensor(v)
                                for k, v in arrays["mlp"].items()})
            net.bfloat16()
        opt = paddle.optimizer.Adam(learning_rate=1e-2,
                                    parameters=net.parameters(),
                                    multi_precision=bf16)
        for x, y in zip(*_zero_data()):
            x = paddle.to_tensor(x)
            out = net(x.astype("bfloat16") if bf16 else x)
            F.cross_entropy(out.astype("float32"),
                            paddle.to_tensor(y)).backward()
            opt.step()
            opt.clear_grad()
        res[f"mlp_{'mp' if bf16 else 'f32'}"] = _arrays(net)
    # the MLP's gradients on the first batch, for the GradScaler's step
    net = nn.Sequential(nn.Linear(8, 32), nn.ReLU(), nn.Linear(32, 4))
    net.set_state_dict({k: paddle.to_tensor(v)
                        for k, v in arrays["mlp"].items()})
    xs, ys = _zero_data()
    F.cross_entropy(net(paddle.to_tensor(xs[0])),
                    paddle.to_tensor(ys[0])).backward()
    res["mlp_grads"] = _grads(net)

    from paddle_tpu.distributed.fleet.meta_parallel import \
        ParallelCrossEntropy as RefPCE
    logits, labels = _pce_data()
    x = paddle.to_tensor(logits)
    x.stop_gradient = False
    per = RefPCE(ignore_index=-1)(x, paddle.to_tensor(labels))
    per.sum().backward()
    res["pce_loss"] = np.asarray(per._val)
    res["pce_grad"] = np.asarray(x.grad._val)
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
    return _launch(2, tmp_path_factory.mktemp("tp2"), reference[1])


@pytest.fixture(scope="module")
def four(reference, tmp_path_factory):
    return _launch(4, tmp_path_factory.mktemp("tp4"), reference[1])


# -- the tests ---------------------------------------------------------------

def test_hybrid_group_axes_are_this_ranks_coordinates(two, four):
    for r in range(2):
        assert two[r]["hcg"] == ["tensor", r, [0, 1], [r]]
    for r in range(4):
        d, m = divmod(r, 2)
        assert four[r]["hcg"] == ["tensor", d, m, [m, m + 2],
                                  [2 * d, 2 * d + 1], [m, m + 2]]
        assert four[r]["hcg_zero"] == ["sharding", [2 * d, 2 * d + 1],
                                       [0, 1, 2, 3]]


def test_tp_layers_match_the_serial_classifier(two, reference):
    ref = reference[0]
    for r in range(2):
        np.testing.assert_allclose(two[r]["cls_loss"], ref["cls_loss"],
                                   rtol=1e-5)
        assert set(two[r]["cls_grads"]) == set(ref["cls_grads"])
        for k, g in ref["cls_grads"].items():
            np.testing.assert_allclose(two[r]["cls_grads"][k], g,
                                       **GRAD_TOL, err_msg=k)


def test_gather_output_and_input_split_match_the_full_matmul(two):
    for r in range(2):
        for name in ("col", "row"):
            err_y, err_x, shape = two[r]["layer_errs"][name]
            assert shape == [3, 5, 8], name
            assert err_y < 1e-5 and err_x < 1e-5, (name, err_y, err_x)


def test_parallel_cross_entropy_takes_the_local_shard(two, reference):
    """ROADMAP C-ref-22: the port's layer, given each rank's half of the
    classes, gives the reference's layer's loss on the gathered logits;
    its logit gradient is the rank's half of the reference's."""
    ref = reference[0]
    for r in range(2):
        np.testing.assert_allclose(two[r]["pce_loss"], ref["pce_loss"],
                                   rtol=1e-6, atol=1e-6)
        assert two[r]["pce_loss"][2] == 0.0     # the ignored row
        half = PCE_CLASSES // 2
        np.testing.assert_allclose(two[r]["pce_grad"],
                                   ref["pce_grad"][:, r * half:(r + 1) * half],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", [2, 4], ids=["mp2", "dp2xmp2"])
def test_tp_gpt_losses_follow_the_serial_steps(world, two, four, reference):
    res = two if world == 2 else four
    want = reference[0]["gpt_losses"]
    for r in range(world):
        assert res[r]["wrapped"] == ["TensorParallel",
                                     "HybridParallelOptimizer"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(res[r]["gpt_losses"],
                                                    want)]
        assert len(gaps) == GPT_STEPS and max(gaps) < LOSS_RTOL, gaps


@pytest.mark.parametrize("world", [2, 4], ids=["mp2", "dp2xmp2"])
def test_tp_gpt_first_grads_match_the_serial_grads(world, two, four,
                                                   reference):
    res = two if world == 2 else four
    ref = reference[0]["gpt_grads"]
    for r in range(world):
        assert set(res[r]["gpt_grads"]) == set(ref)
        for k, g in ref.items():
            np.testing.assert_allclose(res[r]["gpt_grads"][k], g,
                                       **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize("world", [2, 4], ids=["mp2", "dp2xmp2"])
def test_replicated_parameters_stay_bitwise_equal(world, two, four):
    res = two if world == 2 else four
    for r in range(1, world):
        assert res[r]["replicated_sha"] == res[0]["replicated_sha"]
        assert res[r]["full_sha"] == res[0]["full_sha"]


def test_wrap_broadcasts_the_replicated_parameters(two):
    assert two[0]["wrap_replicated_sha"] == two[1]["wrap_replicated_sha"]
    assert two[0]["wrap_shard_sha"] != two[1]["wrap_shard_sha"]


@pytest.mark.parametrize("world", [2, 4], ids=["mp2", "dp2xmp2"])
def test_shard_and_gather_round_trip_bitwise(world, two, four):
    res = two if world == 2 else four
    h, v = GPT_CFG["hidden_size"], GPT_CFG["vocab_size"]
    for r in range(world):
        assert res[r]["round_trip"] is True
        shapes = res[r]["local_shapes"]
        assert shapes["gpt.wte.weight"] == [v // 2, h]
        assert shapes["gpt.h.0.attn.qkv.weight"] == [h, 3 * h // 2]
        assert shapes["gpt.h.0.attn.qkv.bias"] == [3 * h // 2]
        assert shapes["gpt.h.0.attn.out_proj.weight"] == [h // 2, h]
        assert shapes["gpt.h.0.attn.out_proj.bias"] == [h]
        assert shapes["gpt.h.0.mlp.fc1.weight"] == [h, 2 * h]
        assert shapes["gpt.h.0.mlp.fc2.weight"] == [2 * h, h]
        assert shapes["gpt.wpe.weight"] == [GPT_CFG[
            "max_position_embeddings"], h]


def test_qkv_shard_takes_each_ranks_heads(reference):
    """The qkv split is per block: rank r's columns are its heads of q,
    of k and of v, not a contiguous half (which would hand rank 0 all of
    q and half of k)."""
    from types import SimpleNamespace

    from paddle_tpu_torch.framework.io_utils import _shard
    w = reference[1]["gpt"]["gpt.h.0.attn.qkv.weight"]
    h = GPT_CFG["hidden_size"]
    heads = w.reshape(h, 3, GPT_CFG["num_heads"], h // GPT_CFG["num_heads"])
    for r in range(2):
        split = SimpleNamespace(axis=1, blocks=3, rank=r, nranks=2)
        got = _shard(torch.tensor(w), split).numpy()
        want = heads[:, :, 2 * r:2 * r + 2].reshape(h, -1)
        np.testing.assert_array_equal(got, want)


def test_tp_prefill_and_cached_decode_token_for_token(two, reference):
    for r in range(2):
        assert two[r]["decode_tokens"] == reference[0]["decode_tokens"]
        # each rank's KV cache keeps its heads
        assert two[r]["decode_cache_heads"] == GPT_CFG["num_heads"] // 2


def test_global_norm_clip_under_tp_matches_the_serial_clip(two, reference):
    ref = reference[0]
    assert ref["grad_norm"] > 4 * CLIP_NORM      # the clip binds
    for r in range(2):
        for k, want in ref["clip_delta"].items():
            np.testing.assert_allclose(two[r]["clip_delta"][k], want,
                                       rtol=1e-4, atol=1e-7, err_msg=k)


def test_clip_by_norm_under_tp_clips_each_parameter_by_its_full_norm(
        two, reference):
    """ROADMAP C5: each parameter clipped by its full norm, a shard's
    squares summed over the model group; held to the reference's serial
    ClipGradByNorm step (no update moves further than lr x clip_norm)."""
    ref = reference[0]
    moved = [np.abs(d).max() for d in ref["clip_norm_delta"].values()]
    assert max(moved) <= CLIP_LR * CLIP_NORM * (1 + 1e-5)
    for r in range(2):
        for k, want in ref["clip_norm_delta"].items():
            np.testing.assert_allclose(two[r]["clip_norm_delta"][k], want,
                                       rtol=1e-4, atol=1e-7, err_msg=k)


# the reference test's bf16 tolerance (tests/test_hybrid_parallel.py:329):
# the packages round bf16 matmuls apart, before any sharding
ZERO_BF16_TOL = dict(rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("world", [2, 4], ids=["sharding2", "dp2xsharding2"])
@pytest.mark.parametrize("mode", ["f32", "mp"])
def test_zero1_matches_the_reference_unsharded_adam(world, mode, two, four,
                                                    reference):
    """Against the reference's unsharded run (f32 at its test's 1e-5 /
    1e-7; bf16 with f32 masters at its test's bf16 tolerance), and
    against the port's own unsharded steps to the bit."""
    res = two if world == 2 else four
    tag = "zero" if world == 2 else "zero_dp"
    want = reference[0][f"mlp_{mode}"]
    tol = ZERO_TOL if mode == "f32" else ZERO_BF16_TOL
    for r in range(world):
        assert res[r][f"{tag}_{mode}_wrapped"] == [
            "ShardingParallel", "HybridParallelOptimizer",
            "ShardingOptimizerWrapper"]
        got = res[r][f"{tag}_{mode}_weights"]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, **tol, err_msg=k)
            np.testing.assert_array_equal(
                got[k], res[r][f"{tag}_{mode}_plain"][k], err_msg=k)


@pytest.mark.parametrize("world", [2, 4], ids=["sharding2", "dp2xsharding2"])
def test_zero1_on_split_batches_matches_the_whole_batch(world, two, four,
                                                        reference):
    """Each rank on its rows of the reference's batch: the gradients
    reduced over the sharding (and data) ranks give the reference's
    unsharded f32 steps on the whole batch."""
    res = two if world == 2 else four
    tag = "zero" if world == 2 else "zero_dp"
    for r in range(world):
        for k, v in reference[0]["mlp_f32"].items():
            np.testing.assert_allclose(res[r][f"{tag}_split_weights"][k], v,
                                       **ZERO_TOL, err_msg=k)


@pytest.mark.parametrize("world", [2, 4], ids=["sharding2", "dp2xsharding2"])
@pytest.mark.parametrize("mode", ["f32", "mp"])
def test_zero1_state_lives_only_with_its_owner(world, mode, two, four):
    res = two if world == 2 else four
    tag = f"{'zero' if world == 2 else 'zero_dp'}_{mode}"
    # greedy by size over 4 parameters (256, 32, 128, 4 elements)
    owners = {0: [0], 1: [1, 2, 3]}
    for r in range(world):
        owned = res[r][f"{tag}_owned"]
        assert owned == owners[r % 2]
        for name, idx in res[r][f"{tag}_state"].items():
            assert idx == owned, (name, idx)
        assert res[r][f"{tag}_masters"] == (owned if mode == "mp" else [])


@pytest.mark.parametrize("lane", ["tp", "zero"])
def test_grad_scaler_skips_on_every_rank_together(lane, two, reference):
    """One rank alone sees the inf (in its shard under TP, among the
    gradients it owns under ZeRO-1): the ranks reduce found_inf, so every
    rank skips that step with its weights bitwise as they were and halves
    its scale (the reference's decr_ratio 0.5), and the clean step after
    it is the reference's serial SGD step."""
    arrays, grads = (reference[1]["cls"], reference[0]["cls_grads"]) \
        if lane == "tp" else (reference[1]["mlp"], reference[0]["mlp_grads"])
    for r in range(2):
        assert two[r][f"scaler_{lane}_skip_unchanged"] is True
        assert two[r][f"scaler_{lane}_scales"] == [SCALER_INIT / 2,
                                                  SCALER_INIT / 2]
        got = two[r][f"scaler_{lane}_weights"]
        assert set(got) == set(arrays)
        for k, w in arrays.items():
            np.testing.assert_allclose(got[k], w - SCALER_LR * grads[k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert two[0][f"scaler_{lane}_weights"] == \
        two[1][f"scaler_{lane}_weights"]


# -- entry point of a rank -------------------------------------------------

if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[2]))
