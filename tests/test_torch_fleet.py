"""fleet's host-side surface of the PyTorch/CUDA port against the JAX
reference, in one process (world size 1): the strategy, the topology,
the hybrid communicate group's axes and groups, gradient merge (dense and
sparse), ``PipelineLayer``/``LayerDesc`` built whole with
``PipelineParallel``'s micro-batch ``train_batch``, the RNG tracker, the
ZeRO-1 partition, the tensor-parallel GPT at model degree 1, and the
raises that name later ROADMAP A10 items. The multi-process checks are
in tests/test_torch_tensor_parallel.py."""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.nn.functional as RF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as PF
from paddle_tpu.distributed import fleet as rfleet
from paddle_tpu_torch.distributed import fleet as pfleet
from paddle_tpu_torch.distributed.fleet import meta_parallel as pmp

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_process_state():
    """fleet.init at world size 1 marks the process group initialised and
    installs its mesh; other tests of this process expect neither."""
    from paddle_tpu_torch.distributed import env, mesh
    saved = dict(env._STATE), dict(mesh._STATE)
    yield
    env._STATE.update(saved[0])
    mesh._STATE.update(saved[1])


def _state(layer):
    return {k: np.asarray(v._val, np.float32)
            for k, v in layer.state_dict().items()}


def _load(layer, arrays):
    pt.load_numpy_state_dict(layer, {k: torch.tensor(v)
                                     for k, v in arrays.items()})
    return layer


def _ref_mlp(seed=4):
    ref.seed(seed)
    return ref.nn.Sequential(ref.nn.Linear(8, 32), ref.nn.ReLU(),
                             ref.nn.Linear(32, 4))


def _port_mlp(arrays):
    net = pt.nn.Sequential(pt.nn.Linear(8, 32, device="cpu"), pt.nn.ReLU(),
                           pt.nn.Linear(32, 4, device="cpu"))
    return _load(net, arrays)


def _batches(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 8).astype("f4"),
             rng.randint(0, 4, (8, 1)).astype("int64")) for _ in range(n)]


# -- the strategy, the topology, the group ------------------------------------

def test_strategy_keeps_every_field_of_the_reference():
    r, p = rfleet.DistributedStrategy(), pfleet.DistributedStrategy()
    assert vars(r) == vars(p)
    assert repr(p) == repr(r)


def test_topology_matches_the_reference():
    dims = (2, 1, 3, 4)
    r = rfleet.CommunicateTopology(("data", "pipe", "sharding", "model"),
                                   dims)
    p = pfleet.CommunicateTopology(("data", "pipe", "sharding", "model"),
                                   dims)
    assert p.get_hybrid_group_names() == r.get_hybrid_group_names()
    for axis in ("data", "pipe", "sharding", "model"):
        assert p.get_dim(axis) == r.get_dim(axis)
    assert p.world_size() == r.world_size() == 24


def test_hybrid_group_at_world_size_one():
    fleet = pfleet.Fleet().init(is_collective=True)
    hcg = fleet.get_hybrid_communicate_group()
    assert hcg.get_parallel_mode() == "data"
    assert hcg.mesh.axis_names == ("data", "pipe", "sharding", "model")
    for axis in ("data", "model", "pipe", "sharding"):
        assert getattr(hcg, f"get_{axis}_parallel_world_size")() == 1
    for name in ("data", "model", "pipe", "sharding"):
        group = getattr(hcg, f"get_{name}_parallel_group")()
        assert group is hcg.mesh.group(name) and group.nranks == 1
    assert hcg.get_data_parallel_rank() == hcg.get_model_parallel_rank() \
        == hcg.get_stage_id() == hcg.get_sharding_parallel_rank() == 0
    assert hcg.get_dp_sharding_parallel_group().nranks == 1
    model = fleet.distributed_model(_port_mlp(_state(_ref_mlp())))
    assert type(model).__name__ == "DataParallel"
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters()))
    assert type(opt).__name__ == "SGD"


@pytest.mark.parametrize("dims,mode", [
    ((1, 2, 1, 1), "pipeline"), ((1, 2, 2, 2), "pipeline"),
    ((1, 1, 2, 2), "sharding"), ((2, 1, 1, 2), "tensor"),
    ((4, 1, 1, 1), "data")])
def test_parallel_mode_follows_the_reference_order(dims, mode):
    """The reference's precedence: pipeline, sharding, tensor, data (the
    degrees set by hand: building the group needs the ranks)."""
    hcg = object.__new__(pfleet.HybridCommunicateGroup)
    (hcg._dp_degree, hcg._pp_degree, hcg._sharding_degree,
     hcg._mp_degree) = dims
    assert hcg.get_parallel_mode() == mode


@pytest.mark.parametrize("field,value", [
    ("recompute", True), ("amp", True), ("amp_configs", {"level": "O2"}),
    ("lamb", True), ("nccl_comm_num", 2)])
def test_init_warns_of_fields_fleet_does_not_act_on(field, value):
    """The reference stores these fields and acts on none of them; the
    port's fleet.init says so, naming what to use instead."""
    strategy = pfleet.DistributedStrategy()
    setattr(strategy, field, value)
    with pytest.warns(UserWarning, match=f"DistributedStrategy.{field} is "
                                         f"stored but fleet does not act"):
        pfleet.Fleet().init(strategy=strategy)


def test_init_with_the_default_strategy_does_not_warn():
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pfleet.Fleet().init(strategy=pfleet.DistributedStrategy())


def test_sequence_parallel_degree_raises_naming_its_item():
    """ROADMAP C-ref-24: fleet builds no sep axis from sep_degree; the
    message names the mesh call that lays out sequence_parallel's
    ranks."""
    strategy = pfleet.DistributedStrategy()
    strategy.hybrid_configs["sep_degree"] = 2
    with pytest.raises(NotImplementedError,
                       match=r"sequence_parallel ranks with .*build_mesh"):
        pfleet.Fleet().init(strategy=strategy)


def test_module_level_entry_points():
    assert pfleet.worker_index() == 0 and pfleet.worker_num() == 1
    assert pfleet.is_first_worker() and pfleet.is_worker()
    assert pfleet.worker_endpoints() == ["127.0.0.1:0"]
    assert pfleet.Role.WORKER == rfleet.Role.WORKER == 1
    assert pfleet.Role.ALL == rfleet.Role.ALL
    util = pfleet.UtilBase()
    assert util.get_file_shard(["a", "b", "c"]) == \
        rfleet.UtilBase().get_file_shard(["a", "b", "c"])
    np.testing.assert_array_equal(util.all_reduce(np.arange(3)),
                                  np.arange(3))


def test_slot_data_generator_formats_as_the_reference():
    sample = [("words", [3, 1, 4]), ("label", [1])]
    assert pfleet.MultiSlotDataGenerator()._format(sample) == \
        rfleet.MultiSlotDataGenerator()._format(sample) == "3 3 1 4 1 1"


# -- gradient merge ---------------------------------------------------------------

@pytest.mark.parametrize("k_steps,avg", [(2, True), (2, False), (3, True)])
def test_gradient_merge_matches_the_reference(k_steps, avg):
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        GradientMergeOptimizer as RefGM
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        GradientMergeOptimizer
    rm = _ref_mlp()
    pm = _port_mlp(_state(rm))
    ropt = RefGM(ref.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=rm.parameters()),
                 k_steps=k_steps, avg=avg)
    popt = GradientMergeOptimizer(pt.optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=pm.parameters()),
        k_steps=k_steps, avg=avg)
    for x, y in _batches(2 * k_steps):
        RF.cross_entropy(rm(ref.to_tensor(x)), ref.to_tensor(y)).backward()
        ropt.step()
        ropt.clear_grad()
        PF.cross_entropy(pm(torch.tensor(x)), torch.tensor(y)).backward()
        popt.step()
        popt.clear_grad()
    got = {k: v.numpy() for k, v in pm.state_dict().items()}
    for k, v in _state(rm).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert all(p.grad is None for p in pm.parameters())


def test_gradient_merge_of_sparse_gradients_matches_the_reference():
    """An Embedding(sparse=True) table: the merged sparse gradient is
    scaled in its value block and applied once, as the reference does."""
    from paddle_tpu.distributed.fleet.meta_optimizers import \
        GradientMergeOptimizer as RefGM
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        GradientMergeOptimizer
    ref.seed(3)
    remb = ref.nn.Embedding(16, 4, sparse=True)
    pemb = _load(pt.nn.Embedding(16, 4, sparse=True, device="cpu"),
                 _state(remb))
    ropt = RefGM(ref.optimizer.SGD(learning_rate=0.5,
                                   parameters=remb.parameters()), k_steps=2)
    popt = GradientMergeOptimizer(pt.optimizer.SGD(
        learning_rate=0.5, parameters=pemb.parameters()), k_steps=2)
    rng = np.random.RandomState(1)
    for step in range(4):
        ids = rng.randint(0, 16, (3, 5)).astype("int64")
        w = rng.randn(3, 5, 4).astype("f4")
        (remb(ref.to_tensor(ids)) * ref.to_tensor(w)).sum().backward()
        ropt.step()
        ropt.clear_grad()
        (pemb(torch.tensor(ids)) * torch.tensor(w)).sum().backward()
        if step % 2 == 1:
            assert pemb.weight.grad.is_sparse
        popt.step()
        popt.clear_grad()
    np.testing.assert_allclose(pemb.weight.detach().numpy(),
                               _state(remb)["weight"], rtol=1e-6, atol=1e-6)


def test_gradient_merge_wired_from_the_strategy():
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import \
        GradientMergeOptimizer
    strategy = pfleet.DistributedStrategy()
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 2, "avg": True}
    fleet = pfleet.Fleet().init(strategy=strategy)
    model = _port_mlp(_state(_ref_mlp(1)))
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters()))
    assert isinstance(opt, GradientMergeOptimizer)
    before = model[0].weight.detach().clone()
    x, y = torch.ones(4, 8), torch.zeros(4, 1, dtype=torch.int64)
    PF.cross_entropy(model(x), y).backward()
    opt.step()
    opt.clear_grad()
    assert torch.equal(model[0].weight, before)
    assert model[0].weight.grad is not None
    PF.cross_entropy(model(x), y).backward()
    opt.step()
    opt.clear_grad()
    assert not torch.equal(model[0].weight, before)
    assert model[0].weight.grad is None


# -- the pipeline wrapper, built whole ----------------------------------------------

def _pipe_descs(P, seed, device):
    nn = P.nn
    kw = {"device": device} if device else {}

    def block():
        return nn.Sequential(nn.Linear(16, 16, **kw), nn.Tanh())
    P.seed(seed)
    return [nn.Embedding(32, 16, **kw), block(), block(),
            nn.Linear(16, 32, **kw)]


def _pipe_data(steps=3):
    rng = np.random.RandomState(13)
    return [(rng.randint(0, 32, (16, 6)).astype("int32"),
             rng.randint(0, 32, (16, 6)).astype("int64"))
            for _ in range(steps)]


@pytest.mark.parametrize("micro", [1, 4])
def test_pipeline_train_batch_matches_the_reference(micro):
    from paddle_tpu.distributed.fleet.meta_parallel import (
        PipelineLayer as RefPL, PipelineParallel as RefPP)
    rstrategy, pstrategy = (rfleet.DistributedStrategy(),
                            pfleet.DistributedStrategy())
    rstrategy.pipeline_configs = pstrategy.pipeline_configs = {
        "accumulate_steps": micro}
    rmodel = RefPL(_pipe_descs(ref, 21, None), num_stages=1,
                   loss_fn=lambda out, y: RF.cross_entropy(out, y))
    pmodel = pmp.PipelineLayer(
        [pmp.LayerDesc(lambda d=d: d) for d in _pipe_descs(pt, 0, "cpu")],
        num_stages=1, loss_fn=lambda out, y: PF.cross_entropy(out, y))
    _load(pmodel, _state(rmodel))
    rpp = RefPP(rmodel, None, rstrategy)
    ppp = pmp.PipelineParallel(pmodel, None, pstrategy)
    ropt = ref.optimizer.SGD(learning_rate=0.1,
                             parameters=rmodel.parameters())
    popt = pt.optimizer.SGD(learning_rate=0.1,
                            parameters=pmodel.parameters())
    for x, y in _pipe_data():
        lr_ = float(rpp.train_batch((ref.to_tensor(x), ref.to_tensor(y)),
                                    ropt))
        lp = float(ppp.train_batch((torch.tensor(x), torch.tensor(y)),
                                   popt))
        np.testing.assert_allclose(lp, lr_, rtol=1e-5)
    got = {k: v.numpy() for k, v in pmodel.state_dict().items()}
    for k, v in _state(rmodel).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    x, y = _pipe_data(1)[0]
    np.testing.assert_allclose(
        float(ppp.eval_batch((torch.tensor(x), torch.tensor(y)))),
        float(rpp.eval_batch((ref.to_tensor(x), ref.to_tensor(y)))),
        rtol=1e-5)


def test_shared_layer_desc_builds_once():
    calls = []

    def make():
        calls.append(1)
        return pt.nn.Linear(4, 4, device="cpu")
    layer = pmp.PipelineLayer([
        pmp.SharedLayerDesc("tied", make), pt.nn.Tanh(),
        pmp.SharedLayerDesc("tied", make,
                            forward_func=lambda m, x: x @ m.weight.t())])
    assert calls == [1]
    assert len(list(layer.parameters())) == 2
    out = layer(torch.ones(2, 4))
    tied = layer.run_function[0]
    want = torch.tanh(tied(torch.ones(2, 4))) @ tied.weight.t()
    torch.testing.assert_close(out, want)


def test_pipeline_stages_raise_naming_their_item():
    """Stages are checked where they are declared: more stages than
    layers, and a pipe axis whose ranks a model built whole cannot
    split (tests/test_torch_pipeline.py runs the stages)."""
    with pytest.raises(ValueError, match="exceeds layer count"):
        pmp.PipelineLayer([pt.nn.Tanh()], num_stages=2)

    class TwoStages:
        def get_pipe_parallel_world_size(self):
            return 2
    with pytest.raises(ValueError, match="needs a PipelineLayer with "
                                         "num_stages=2"):
        pmp.PipelineParallel(pt.nn.Tanh(), TwoStages())


# -- ZeRO-1's partition and its refusal -------------------------------------------

def test_zero_partition_is_greedy_by_size():
    from paddle_tpu_torch.distributed.fleet.sharding_optimizer import \
        partition_parameters
    ps = [torch.zeros(n) for n in (256, 32, 128, 4, 300, 8)]
    parts = partition_parameters(ps, 2)
    assert [[p.numel() for p in part] for part in parts] == \
        [[256, 8], [32, 128, 4, 300]]
    assert partition_parameters(ps, 1) == [ps]


def test_zero3_raises_naming_spec_layout():
    """ZeRO-3 no longer raises: it shards through spec_layout's code
    (which the wrapper's docstring names); at one rank every parameter
    stays whole and the wrapper steps as the plain optimizer."""
    from paddle_tpu_torch.distributed.fleet import sharding_optimizer
    net = _port_mlp(_state(_ref_mlp()))
    shapes = [tuple(p.shape) for p in net.parameters()]
    opt = sharding_optimizer.ShardingOptimizerWrapper(
        pt.optimizer.Adam(parameters=net.parameters()), shard_params=True)
    assert "spec_layout" in sharding_optimizer.__doc__
    assert opt.shards_params and opt.owned_parameters == list(
        net.parameters())
    assert [tuple(p.shape) for p in net.parameters()] == shapes
    assert not any(hasattr(p, "fsdp_split") for p in net.parameters())


def test_zero_at_one_rank_is_the_plain_optimizer():
    from paddle_tpu_torch.distributed.fleet.sharding_optimizer import \
        ShardingOptimizerWrapper
    arrays = _state(_ref_mlp())
    a, b = _port_mlp(arrays), _port_mlp(arrays)
    oa = ShardingOptimizerWrapper(pt.optimizer.Adam(
        learning_rate=1e-2, parameters=a.parameters()))
    ob = pt.optimizer.Adam(learning_rate=1e-2, parameters=b.parameters())
    assert len(oa.owned_parameters) == 4
    for x, y in _batches(3):
        for m, o in ((a, oa), (b, ob)):
            PF.cross_entropy(m(torch.tensor(x)), torch.tensor(y)).backward()
            o.step()
            o.clear_grad()
    for (k, va), (_, vb) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert torch.equal(va, vb), k


# -- the tensor-parallel layers at model degree 1 ---------------------------------

def test_tp_gpt_at_degree_one_matches_the_reference_tp_gpt():
    """GPTConfig(tensor_parallel=True) without a model axis holds every
    parameter and equals the reference's tensor-parallel GPT."""
    from paddle_tpu.text.models.gpt import GPTConfig as RC
    from paddle_tpu.text.models.gpt import GPTForCausalLM as RG
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               max_position_embeddings=32, dropout=0.0,
               tensor_parallel=True)
    ref.seed(2)
    rm = RG(RC(**cfg))
    pm = _load(GPTForCausalLM(GPTConfig(**cfg), device="cpu"), _state(rm))
    rng = np.random.RandomState(5)
    x = rng.randint(0, 64, (2, 12)).astype("int32")
    y = rng.randint(0, 64, (2, 12)).astype("int64")
    rl = rm(ref.to_tensor(x), labels=ref.to_tensor(y))
    rl.backward()
    pl = pm(torch.tensor(x), labels=torch.tensor(y))
    pl.backward()
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5)
    grads = {k: v.grad for k, v in pm.named_parameters()}
    for k, v in rm.state_dict().items():
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(v.grad._val),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert type(pm.gpt.h[0].attn.qkv).__name__ == "ColumnParallelLinear"
    assert type(pm.gpt.wte).__name__ == "VocabParallelEmbedding"
    assert all(getattr(p, "tp_split", None) is None for p in pm.parameters())


def test_parallel_cross_entropy_at_degree_one_is_cross_entropy():
    rng = np.random.RandomState(4)
    x = torch.tensor(rng.randn(5, 7).astype("f4"), requires_grad=True)
    y = torch.tensor([1, 6, -100, 0, 3])
    loss = pmp.ParallelCrossEntropy()(x, y)
    want = PF.cross_entropy(x, y, reduction="none")
    torch.testing.assert_close(loss, want)
    g1, = torch.autograd.grad(loss.sum(), x)
    g2, = torch.autograd.grad(want.sum(), x)
    torch.testing.assert_close(g1, g2)


def test_rng_tracker_states():
    tracker = pmp.RNGStatesTracker()
    tracker.add("a", 7)
    with pytest.raises(ValueError):
        tracker.add("a", 8)
    with tracker.rng_state("a") as gen:
        first = torch.rand(3, generator=gen)
    want = torch.rand(3, generator=torch.Generator().manual_seed(7))
    assert torch.equal(first, want)
    with pytest.raises(ValueError):
        with tracker.rng_state("missing"):
            pass
    pmp.model_parallel_random_seed(11, device="cpu")
    t = pmp.get_rng_state_tracker()
    assert t.generator("global_seed").initial_seed() == 11
    # model rank 0 of 1: the base seed + 1024 + the rank
    assert t.generator().initial_seed() == 11 + 1024
    t.reset()
    assert t.generator(default="x") == "x"


def _tracker_masks(pkg):
    """Dropout masks drawn with no generator named, around and inside
    ``rng_state`` blocks of one package's tracker (state "a": seed 7 in
    two trackers, seed 8 in a third), and the default stream's draws
    with no block."""
    if pkg == "reference":
        from paddle_tpu.distributed.fleet.meta_parallel import \
            RNGStatesTracker
        x, reseed = ref.ones([256]), ref.seed

        def draw():
            return np.asarray(RF.dropout(x, 0.5)._val) != 0
    else:
        RNGStatesTracker = pmp.RNGStatesTracker
        x, reseed = torch.ones(256), pt.seed

        def draw():
            return PF.dropout(x, 0.5).numpy() != 0
    reseed(0)
    plain = [draw(), draw()]
    reseed(0)
    trackers = [RNGStatesTracker() for _ in range(3)]
    for t, s in zip(trackers, (7, 7, 8)):
        t.add("a", s)
    out = {"plain": plain}
    with trackers[0].rng_state("a"):
        out["first"] = draw()
    out["after"] = draw()
    with trackers[0].rng_state("a"):
        out["second"] = draw()
    out["after2"] = draw()
    with trackers[1].rng_state("a"):
        out["same_seed"] = draw()
    with trackers[2].rng_state("a"):
        out["other_seed"] = draw()
    return out


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_rng_state_block_draws_the_named_state(pkg):
    """The reference's tracker makes the named state the default one
    inside the block (meta_parallel.py:64-76), so a dropout that names no
    generator, as model code writes it, draws from the named state; the
    port's does the same: the same properties hold in both packages."""
    m = _tracker_masks(pkg)
    # the block consumes nothing of the default stream
    assert np.array_equal(m["after"], m["plain"][0])
    assert np.array_equal(m["after2"], m["plain"][1])
    # inside, the named state: reproducible from its seed, advancing
    # across blocks, and apart from the default stream and other seeds
    assert np.array_equal(m["first"], m["same_seed"])
    assert not np.array_equal(m["first"], m["second"])
    assert not np.array_equal(m["first"], m["other_seed"])
    assert not np.array_equal(m["first"], m["plain"][0])
