"""The port's CUDA kernels and its GPT serving and training paths on a card.

Marked ``cuda``: every test here needs an NVIDIA card and the CUDA
toolkit, and skips without them. They import torch and the port only, so
they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, kernel against its plain version on the same inputs. bf16 B1,
B2 and B3 run on the tensor cores, where P and dS are rounded to bf16 as
mma operands (unit roundoff 2^-9 per term) and the outputs to bf16: their
O, dK, dV and dQ are held to a relative L2 gap of at most 2^-7 and at most
twice the gap of PyTorch's own attention (which rounds at the same places)
plus 2^-10; an elementwise bound is not sound there, since sums with
cancellation land near zero. B1's bf16 O also keeps a max-abs bound of
2e-2 (values below 2). f32 outputs (the CUDA-core variants) differ by
summation order only (O 2e-5); LSE is f32 in both (1e-4). Every f32 grad
is held elementwise to |err| <= 1e-4 + 1e-4 * |plain|: summation order
over up to 1024 terms with cancellation in dS, and values near zero. Each
test also checks which variant ran (``launch_counts``).

The serving slice: a Predictor on the card keeps one CUDA graph per
input signature; its replies equal a direct replay of that graph to the
bit and an eager f32 forward within 1e-4 relative + 1e-5 (summation order
between the captured and the eager launches); a capture that syncs with
the host raises and nothing falls back to eager; evicting a bf16 entry
frees its graph; two replicas share the graphs under four client threads;
and the decode backend's graphs stream the host's tokens.

The conv net slice (cuDNN, f32 with TF32 off) is held against the same
code on the host: conv2d and the poolings elementwise to 1e-4 relative +
1e-4 (the padded exclusive average pool among them, whose torch backward
is wrong on channels_last CUDA tensors), the fused conv + BN op's grads to 1e-4 of the largest, a ResNet-18
step in f64 to 1e-12 (loss, statistics) and 1e-10 (grads, relative L2),
and its eval logits in f32 to 1e-4.

The training API slice: ``fit`` on a card network hands the step only
CUDA batches (with and without the prefetcher, captured and eager); the
prefetcher's side-stream copy is ordered before the step reads it, even
when the copy is held back on its stream; a spawned DataLoader worker
sees no CUDA device while its parent holds a context; and ``Model.save``
and ``load`` round-trip a LeNet's parameters and Adam state on the card
to the bit.

The pipeline slice: a stage's forward and recompute backward as
CompiledStagePrograms, each captured on its second call, replay the
eager bodies' outputs and add the same gradients into the stage's
accumulators (chip_smoke.py's pipeline group runs the engine itself).

Serving over the wire: a replica added with a predictor of its own while
four client threads keep the others busy captures one graph per bucket
before it takes traffic, replays B1 by kernel name and answers within
f32 summation order of the eager forward; a reply over SocketFrontend
from the card equals the eager forward, and CUDA-tensor results are
copied to the host before they are framed.

The layouts slice: ring attention's block entry points (B1's f32 O and
LSE; B2 and B3 under a given LSE and D) against their plain versions,
the math block off the kernels' contract, the LSE merge against
logsumexp of the whole row; and two rank processes on the card running
a ring on {"sep": 2} and a ZeRO-3 step on {"sharding": 2}.
"""
import threading

import pytest
import torch

import numpy as np

import paddle_tpu_torch as pt
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import launch_counts
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
BWD_RTOL, BWD_ATOL = 1e-4, 1e-4
TC_REL_L2, TC_SDPA_FACTOR, TC_SDPA_SLACK = 2 ** -7, 2.0, 2 ** -10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no host mode (its "
                    "plain version is tested against the reference in "
                    "test_torch_flash_attention.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda")
    return qkv.to(dtype).unbind(dim=2)


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _assert_tc_close(got, want, library, name):
    """The tensor-core rule: relative L2 gap to the plain version within
    2^-7 and within twice the library's own gap + 2^-10."""
    gap, lib_gap = _rel_l2(got, want), _rel_l2(library, want)
    assert gap <= TC_REL_L2, (name, gap)
    assert gap <= TC_SDPA_FACTOR * lib_gap + TC_SDPA_SLACK, \
        (name, gap, lib_gap)


def _sdpa(q, k, v, causal, scale, do=None):
    """PyTorch's own attention on (B, S, H, D) inputs: its output, or with
    ``do`` its (dq, dk, dv)."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(do is not None)
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=scale)
    if do is None:
        return out.transpose(1, 2)
    grads = torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    return [g.transpose(1, 2) for g in grads]


def _variant_counts(kernel):
    return {v: launch_counts[f"{kernel}.{v}"] for v in (fa.TC, fa.SIMT)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [256, 512])
def test_kernel_matches_plain(card, s, causal, d, dtype):
    q, k, v = _qkv(2, s, 4, d, dtype, seed=s + d + causal)
    scale = d ** -0.5
    before = launch_counts[fa.KERNEL_NAME]
    variants = _variant_counts(fa.KERNEL_NAME)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert launch_counts[fa.KERNEL_NAME] == before + 1
    variants[fa.variant(dtype)] += 1
    assert _variant_counts(fa.KERNEL_NAME) == variants
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                        scale)
    assert out.dtype == dtype and out.is_contiguous()
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    if dtype == torch.bfloat16:
        _assert_tc_close(out, ref_out, _sdpa(q, k, v, causal, scale), "o")


def test_kernel_takes_grad_requiring_inputs(card):
    q, k, v = _qkv(1, 256, 2, 64, torch.float32, seed=0)
    q.requires_grad_(True)
    before = launch_counts[fa.KERNEL_NAME]
    out, _ = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts[fa.KERNEL_NAME] == before + 1
    assert not out.requires_grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [256, 512])
def test_bwd_kernels_match_plain(card, s, causal, d, dtype):
    q, k, v = _qkv(2, s, 4, d, dtype, seed=s + d + causal + 7)
    g = torch.Generator(device="cuda").manual_seed(s + d)
    do = torch.randn((2, s, 4, d), generator=g, device="cuda").to(dtype)
    scale = d ** -0.5
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    kernels = (fa.DKV_KERNEL, fa.DQ_KERNEL)
    before = [launch_counts[n] for n in kernels]
    variants = {n: _variant_counts(n) for n in kernels}
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert [launch_counts[n] for n in kernels] == [c + 1 for c in before]
    for n in kernels:
        variants[n][fa.variant(dtype)] += 1
        assert _variant_counts(n) == variants[n], n
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                            scale)
    library = _sdpa(q, k, v, causal, scale, do)
    for a, b, lib, name in zip(got, want, library, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.is_contiguous(), name
        if dtype == torch.bfloat16:
            _assert_tc_close(a, b, lib, name)
            continue
        err = (a.float() - b.float()).abs()
        bound = BWD_ATOL + BWD_RTOL * b.float().abs()
        assert bool((err <= bound).all()), (name, err.max().item())


@pytest.mark.parametrize("causal", [False, True])
def test_misaligned_bf16_inputs_match_aligned(card, causal):
    """A bf16 view 2 bytes past its allocation cannot be read 16 bytes at
    a time: the wrapper copies it, and forward and backward equal those of
    an aligned copy of the same values, on the tensor-core variants."""
    b, s, h, d = 2, 256, 4, 64
    g = torch.Generator(device="cuda").manual_seed(11 + causal)
    flat = torch.randn(4 * b * s * h * d + 1, generator=g,
                       device="cuda").to(torch.bfloat16)
    q, k, v, do = flat[1:].view(4, b, s, h, d).unbind(0)
    assert all(t.data_ptr() % 16 != 0 for t in (q, k, v, do))
    aligned = [t.clone() for t in (q, k, v, do)]
    assert all(t.data_ptr() % 16 == 0 for t in aligned)
    scale = d ** -0.5
    tc_before = [_variant_counts(n)[fa.TC] for n in fa.KERNEL_NAMES]
    results = []
    for qq, kk, vv, dd in ((q, k, v, do), aligned):
        out, lse = fa.flash_attention_fwd(qq, kk, vv, causal, scale)
        grads = fa.flash_attention_bwd(qq, kk, vv, out, lse, dd, causal,
                                       scale)
        results.append((out, lse, *grads))
    torch.cuda.synchronize()
    assert [_variant_counts(n)[fa.TC] for n in fa.KERNEL_NAMES] == \
        [c + 2 for c in tc_before]
    for x, y in zip(*results):
        assert torch.equal(x, y)


def _tiny(device, seed=0):
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=512, dropout=0.0)
    model = GPTForCausalLM(cfg, device=device,
                           generator=torch.Generator().manual_seed(seed))
    return model.eval()


def _greedy(model, ids, steps):
    logits, caches = model(ids, caches=model.gpt.init_decode_caches())
    tok = logits[:, -1].argmax(-1, keepdim=True)
    toks = [tok]
    for _ in range(steps):
        step, caches = model(tok, caches=caches)
        tok = step[:, -1].argmax(-1, keepdim=True)
        toks.append(tok)
    return logits, torch.cat(toks, dim=1)


def _set_flash(model, on):
    for block in model.gpt.h:
        block.attn.use_flash = on


def test_gpt_kernel_path_matches_math_path_and_host(card):
    model = _tiny(card)
    host = _tiny("cpu")
    ids = torch.randint(0, 256, (2, 256),
                        generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        launch_counts.clear()
        k_logits, k_toks = _greedy(model, ids.to(card), 8)
        assert launch_counts[fa.KERNEL_NAME] == 2
        _set_flash(model, False)
        m_logits, m_toks = _greedy(model, ids.to(card), 8)
        h_logits, h_toks = _greedy(host, ids, 8)
    torch.testing.assert_close(k_logits, m_logits, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(k_logits.cpu(), h_logits, rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(k_toks, m_toks) and torch.equal(k_toks.cpu(), h_toks)


def test_gpt_medium_full_width_f32_greedy_tokens(card):
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024, num_layers=24,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    model = GPTForCausalLM(cfg, device=card,
                           generator=torch.Generator().manual_seed(0))
    model.eval()
    ids = torch.randint(0, cfg.vocab_size, (4, 512),
                        generator=torch.Generator().manual_seed(1)).to(card)
    with torch.inference_mode():
        launch_counts.clear()
        k_logits, k_toks = _greedy(model, ids, 16)
        assert launch_counts[fa.KERNEL_NAME] == cfg.num_layers
        _set_flash(model, False)
        m_logits, m_toks = _greedy(model, ids, 16)
    assert (k_logits - m_logits).abs().max().item() <= 1e-3
    assert torch.equal(k_toks, m_toks)


def _train_grads(model, ids, labels):
    loss = model(ids, labels=labels)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def test_gpt_training_step_kernel_path_matches_math_path(card):
    """One f32 training step of a small GPT: loss and every parameter's
    grad through B1/B2/B3 against the math path (summation order only),
    then AdamW steps from the same weights stay together."""
    import paddle_tpu_torch as pt
    model = _tiny(card).train()
    ids = torch.randint(0, 256, (2, 257),
                        generator=torch.Generator().manual_seed(2)).to(card)
    x, y = ids[:, :-1], ids[:, 1:]
    launch_counts.clear()
    k_loss, k_grads = _train_grads(model, x, y)
    assert [launch_counts[n] for n in fa.KERNEL_NAMES] == [2, 2, 2]
    # f32 runs the CUDA-core variants of B1, B2 and B3
    assert [launch_counts[fa.variant_counter(n, torch.float32)]
            for n in fa.KERNEL_NAMES] == [2, 2, 2]
    _set_flash(model, False)
    m_loss, m_grads = _train_grads(model, x, y)
    assert sum(launch_counts[n] for n in fa.KERNEL_NAMES) == 6
    assert abs(k_loss - m_loss) <= 1e-5 * abs(m_loss)
    for name, g in k_grads.items():
        rel = ((g - m_grads[name]).norm() / m_grads[name].norm()).item()
        assert rel <= 1e-4, (name, rel)
    losses = {}
    for flash in (True, False):
        model = _tiny(card).train()
        _set_flash(model, flash)
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
        losses[flash] = []
        for _ in range(3):
            loss = model(x, labels=y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses[flash].append(loss.item())
    assert max(abs(a - b) for a, b in zip(losses[True], losses[False])) \
        <= 1e-4


# -- the compiled step: to_static as a CUDA graph -----------------------------

def _adamw_step(model, opt, scaler=None):
    import paddle_tpu_torch as pt

    @pt.jit.to_static
    def step(x, y):
        loss = model(x, labels=y)
        if scaler is None:
            loss.backward()
            opt.step()
        else:
            scaler.scale(loss).backward()
            scaler.step(opt)
            scaler.update()
        opt.clear_grad()
        return loss.float()
    return step


def _stream_batches(card, n, seed=3):
    ids = torch.randint(0, 256, (n, 2, 257),
                        generator=torch.Generator().manual_seed(seed))
    return ids[:, :, :-1].to(card), ids[:, :, 1:].to(card)


def test_captured_steps_match_eager_steps(card):
    """A small f32 GPT, 3 steps through to_static (a discovery pass, the
    capture and its replay, a replay) against 3 eager steps from the same
    weights: the same kernels in the same order, so losses and parameters
    agree to 1e-6 relative (expected: equal)."""
    import paddle_tpu_torch as pt
    xs, ys = _stream_batches(card, 3)
    runs = {}
    for compiled in (False, True):
        pt.set_flags({"FLAGS_compiled_step": compiled})
        try:
            model = _tiny(card).train()
            opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                     parameters=model.parameters())
            step = _adamw_step(model, opt)
            launch_counts.clear()
            losses = [step(xs[i], ys[i]) for i in range(3)]
            runs[compiled] = (torch.stack(losses).cpu(),
                              [p.detach().clone() for p in model.parameters()],
                              step)
        finally:
            pt.set_flags({"FLAGS_compiled_step": True})
    (e_loss, e_params, _), (c_loss, c_params, step) = runs[False], runs[True]
    prog, = step.programs.values()
    assert prog.graph is not None and prog.built and prog.hits == 1
    torch.testing.assert_close(c_loss, e_loss, rtol=1e-6, atol=0)
    for a, b in zip(c_params, e_params):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # a returned loss is a copy: the next replay does not overwrite it
    assert c_loss[1] != c_loss[2]


def test_run_steps_replays_the_graph(card):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    xs, ys = _stream_batches(card, 4, seed=5)
    outs = []
    for k_steps in (True, False):
        model = _tiny(card).train()
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
        step = CompiledTrainStep(_adamw_step(model, opt))
        reset_compile_stats()
        if k_steps:
            outs.append(step.run_steps(xs, ys).cpu())
            assert compile_stats()["compiles"] == 1
            assert compile_stats()["cache_hits"] == 2
        else:
            outs.append(torch.stack([step(xs[i], ys[i])
                                     for i in range(4)]).cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=0)


def test_dropout_under_capture_draws_new_masks(card):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F
    x = torch.ones(64, 256, device=card)
    gens = [None, torch.Generator(device=card).manual_seed(1)]
    for gen in gens:
        if gen is not None and not hasattr(torch.cuda.CUDAGraph,
                                           "register_generator_state"):
            continue
        fn = pt.jit.to_static(lambda t, g=gen: F.dropout(t, 0.1,
                                                         generator=g))
        outs = [fn(x) for _ in range(4)]
        prog, = fn.programs.values()
        assert prog.graph is not None
        for o in outs:
            zeros = (o == 0).float().mean().item()
            assert 0.05 < zeros < 0.15, zeros
        # the capture's replay and the next replays: new masks each time
        assert not torch.equal(outs[1], outs[2])
        assert not torch.equal(outs[2], outs[3])


def test_dropout_from_a_cpu_generator_refuses_capture(card):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F
    gen = torch.Generator().manual_seed(0)
    fn = pt.jit.to_static(lambda t: F.dropout(t, 0.1, generator=gen))
    x = torch.ones(8, 8, device=card)
    fn(x)                                       # discovery: eager
    with pytest.raises(RuntimeError, match="CUDA graph"):
        fn(x)


def test_grad_scaler_skips_an_inf_step_under_capture(card):
    """The scaler's decisions are device selects: a captured step whose
    grads are not finite leaves every parameter and accumulator as it
    was and halves the scale."""
    import paddle_tpu_torch as pt
    model = _tiny(card).train()
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    step = _adamw_step(model, opt, scaler)
    xs, ys = _stream_batches(card, 4, seed=7)
    for i in range(3):
        step(xs[i], ys[i])
    assert step.programs[next(iter(step.programs))].graph is not None
    before = [p.detach().clone() for p in model.parameters()]
    accs = [t.clone() for by in opt._accumulators.values()
            for t in by.values()]
    scale = float(scaler._scale)
    # an inf in the embedding makes every grad downstream of it non-finite
    with torch.no_grad():
        model.gpt.wte.weight[ys[3][0, 0]] = float("inf")
        before[0] = model.gpt.wte.weight.detach().clone()
    step(xs[3], ys[3])
    assert bool(scaler._found_inf) and float(scaler._scale) == scale / 2
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a.detach(), b)
    for a, b in zip([t for by in opt._accumulators.values()
                     for t in by.values()], accs):
        assert torch.equal(a, b)


def test_capture_that_syncs_with_the_host_raises(card):
    import paddle_tpu_torch as pt

    @pt.jit.to_static
    def step(x):
        y = x * 2
        if y.sum().item() > 0:          # a host sync: cannot be captured
            y = y + 1
        return y
    x = torch.ones(4, device=card)
    assert torch.equal(step(x), torch.full((4,), 3.0, device=card))
    for _ in range(2):         # and again: a failed capture never runs eagerly
        with pytest.raises(RuntimeError, match="CUDA graph"):
            step(x)
    # the device is still usable
    assert torch.equal(x + 1, torch.full((4,), 2.0, device=card))


def test_amp_recompute_step_captures_and_relaunches_b1(card):
    """bf16 autocast with recompute through to_static: B1 runs twice per
    layer in the graph (forward and rerun), the tensor-core variants run,
    and the captured losses equal the eager ones."""
    import paddle_tpu_torch as pt
    xs, ys = _stream_batches(card, 3, seed=9)
    losses = {}
    for compiled in (False, True):
        pt.set_flags({"FLAGS_compiled_step": compiled})
        try:
            cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                            num_heads=2, max_position_embeddings=512,
                            dropout=0.0, recompute=True)
            model = GPTForCausalLM(
                cfg, device=card,
                generator=torch.Generator().manual_seed(0)).train()
            opt = pt.optimizer.AdamW(
                learning_rate=1e-3, parameters=model.parameters(),
                grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))

            @pt.jit.to_static
            def step(x, y):
                with pt.amp.auto_cast(dtype="bfloat16"):
                    loss = model(x, labels=y)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss
            launch_counts.clear()
            losses[compiled] = torch.stack(
                [step(xs[i], ys[i]) for i in range(3)]).cpu()
            # eager: 3 steps; captured: discovery + capture (the replay
            # launches nothing from Python) + nothing
            n = 3 if not compiled else 2
            assert launch_counts[fa.variant_counter(
                fa.KERNEL_NAME, torch.bfloat16)] == 2 * 2 * n
            assert launch_counts[fa.variant_counter(
                fa.DQ_KERNEL, torch.bfloat16)] == 2 * n
        finally:
            pt.set_flags({"FLAGS_compiled_step": True})
    torch.testing.assert_close(losses[True], losses[False], rtol=1e-6,
                               atol=0)


# -- outer gradients through a captured forward (C1), the lr tensor's
# device (C2), and BERT on the non-causal kernels ------------------------------

def _rel_l2_grads(model, ref):
    return {n: ((p.grad - ref[n]).norm() / ref[n].norm()).item()
            for n, p in model.named_parameters()}


def test_forward_only_to_static_gives_eager_grads(card):
    """A forward-only to_static GPT under an outer backward, 3 calls (a
    discovery pass, the capture of forward and backward with a replay of
    each, replays): every grad equals eager's (f32, 1e-5 relative L2) and
    none is zero; the program holds a captured backward."""
    import paddle_tpu_torch as pt
    xs, ys = _stream_batches(card, 3, seed=11)
    eager, static = _tiny(card).train(), _tiny(card).train()
    fwd = pt.jit.to_static(lambda x, y: static(x, labels=y))
    for i in range(3):
        loss = eager(xs[i], labels=ys[i])
        loss.backward()
        want = {n: p.grad.clone() for n, p in eager.named_parameters()}
        eager.zero_grad(set_to_none=True)
        fwd(xs[i], ys[i]).backward()
        for name, rel in _rel_l2_grads(static, want).items():
            assert rel <= 1e-5, (i, name, rel)
        assert all(p.grad.abs().sum() > 0 for p in static.parameters())
        static.zero_grad(set_to_none=True)
    prog, = fwd.programs.values()
    assert prog.graph is not None and prog.bwd_graph is not None
    assert not prog.internal_backward
    # a second call before the backward of the first: its buffers are gone
    first = fwd(xs[0], ys[0])
    fwd(xs[1], ys[1])
    with pytest.raises(RuntimeError, match="most recent call"):
        first.backward()


def test_differentiating_a_captured_train_step_raises(card):
    import paddle_tpu_torch as pt
    model = _tiny(card).train()
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    step = _adamw_step(model, opt)
    xs, ys = _stream_batches(card, 3, seed=12)
    for i in range(3):
        loss = step(xs[i], ys[i])
        with pytest.raises(RuntimeError, match="runs its own backward"):
            (2.0 * loss).backward()
    prog, = step.programs.values()
    assert prog.graph is not None and prog.internal_backward


def test_lr_follows_the_model_to_the_card_under_capture(card):
    """An optimizer built on host parameters, the model then moved to the
    card, a LinearWarmup scheduler, the step captured: the lr read back
    after each replay is the scheduler's."""
    import paddle_tpu_torch as pt
    model = _tiny("cpu").train()
    sched = pt.optimizer.lr.LinearWarmup(learning_rate=1e-3, warmup_steps=4,
                                         start_lr=1e-4, end_lr=1e-3)
    opt = pt.optimizer.AdamW(learning_rate=sched,
                             parameters=model.parameters())
    model.to(card)
    assert opt._learning_rate.device.type == "cpu"

    @pt.jit.to_static
    def step(x, y):
        loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return opt._learning_rate * 1.0
    xs, ys = _stream_batches(card, 5, seed=13)
    for i in range(5):
        want = float(torch.tensor(sched(), dtype=torch.float32))
        assert step(xs[i], ys[i]).item() == want, (i, want)
        sched.step()
    assert opt._learning_rate.is_cuda and sched._lr_tensor is opt._lr
    assert step.programs[next(iter(step.programs))].graph is not None


def test_bert_kernel_path_matches_math_path(card):
    """A small f32 BERT at s = 256, head dim 64, no mask: loss and every
    grad through B1/B2/B3 non-causal against the math path. The key
    projections' bias grads are zero in exact arithmetic (the softmax over
    the keys ignores a shift common to a query's logits), so a relative
    gap there compares noise with noise: on each path they must stay below
    1e-4 of their weight grad's norm instead."""
    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForSequenceClassification)
    cfg = dict(vocab_size=120, hidden_size=128, num_layers=2, num_heads=2,
               intermediate_size=256, max_position=256, dropout=0.0)
    ids = torch.randint(0, 120, (2, 256),
                        generator=torch.Generator().manual_seed(14)).to(card)
    labels = torch.tensor([0, 1], device=card)
    runs = {}
    for flash in (True, False):
        model = BertForSequenceClassification(
            BertConfig(**cfg, use_flash_attention=flash), device=card,
            generator=torch.Generator().manual_seed(0)).train()
        launch_counts.clear()
        runs[flash] = _train_grads(model, ids, labels)
        assert [launch_counts[fa.variant_counter(n, torch.float32)]
                for n in fa.KERNEL_NAMES] == ([2, 2, 2] if flash
                                              else [0, 0, 0])
    (k_loss, k_grads), (m_loss, m_grads) = runs[True], runs[False]
    assert abs(k_loss - m_loss) <= 1e-5 * abs(m_loss)
    for name, g in k_grads.items():
        if name.endswith("self_attn.k_proj.bias"):
            weight = name[:-len("bias")] + "weight"
            for grads in (k_grads, m_grads):
                share = (grads[name].norm() / grads[weight].norm()).item()
                assert share <= 1e-4, (name, share)
            continue
        rel = ((g - m_grads[name]).norm() / m_grads[name].norm()).item()
        assert rel <= 1e-4, (name, rel)


@pytest.mark.parametrize("causal", [False, True])
def test_tc_forward_also_writes_the_unrounded_output(card, causal):
    """The training path's B1 launch (tensor cores) writes O in f32 beside
    the bf16 O: one launch, the bf16 O and LSE unchanged, the f32 O
    rounding to the bf16 one and within the tensor-core bound of the f32
    plain version."""
    q, k, v = _qkv(2, 512, 4, 64, torch.bfloat16, seed=21)
    before = _variant_counts(fa.KERNEL_NAME)
    out, lse, out32 = fa.flash_attention_fwd_for_grad(q, k, v, causal, 0.125)
    after = _variant_counts(fa.KERNEL_NAME)
    assert after[fa.TC] == before[fa.TC] + 1
    assert out32.dtype == torch.float32
    assert torch.equal(out, out32.to(torch.bfloat16))
    plain_out, plain_lse = fa.flash_attention_fwd(q, k, v, causal, 0.125)
    assert torch.equal(plain_out, out) and torch.equal(plain_lse, lse)
    want, _ = fa._fwd_plain(q, k, v, causal, 0.125)
    assert _rel_l2(out32, want) <= TC_REL_L2


# --- the conv net slice ---------------------------------------------------

# f32, TF32 off: cuDNN and the host sum a wgrad's 420 products per weight
# in other orders
CONV_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("padding,stride", [(1, 1), (1, 2), ("SAME", 2),
                                            ([0, 1, 1, 0], 1)])
def test_conv2d_and_pools_on_card_match_host(card, fmt, padding, stride):
    import paddle_tpu_torch.nn.functional as F
    g = torch.Generator().manual_seed(31)
    shape = (2, 8, 15, 14) if fmt == "NCHW" else (2, 15, 14, 8)
    x = torch.randn(shape, generator=g)
    w = torch.randn((16, 8, 3, 3), generator=g) * 0.2
    b = torch.randn(16, generator=g)
    results = []
    for dev in ("cpu", card):
        xd, wd, bd = (t.clone().to(dev).requires_grad_() for t in (x, w, b))
        out = F.conv2d(xd, wd, bd, stride=stride, padding=padding,
                       data_format=fmt)
        pooled = [F.max_pool2d(out, 3, 2, 1, data_format=fmt),
                  F.avg_pool2d(out, 3, 2, padding, data_format=fmt),
                  F.adaptive_avg_pool2d(out, (3, 5), data_format=fmt)]
        sum(p.square().sum() for p in pooled).backward()
        results.append([t.detach().cpu() for t in (out, *pooled, xd.grad,
                                                    wd.grad, bd.grad)])
        if dev != "cpu" and fmt == "NHWC":
            assert out.permute(0, 3, 1, 2).is_contiguous(
                memory_format=torch.channels_last)
    for host, got in zip(*results):
        torch.testing.assert_close(got, host, **CONV_TOL)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("act_input", [False, True])
def test_fused_conv_bn_on_card_matches_unfused_and_host(card, fmt,
                                                        act_input):
    """The Function's cuDNN dgrad/wgrad and f32 BN backward on the card:
    its forward equals the unfused composition's, its grads and running
    statistics match the unfused ones and the host's."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops.fused_conv_bn import fused_conv_bn
    g = torch.Generator().manual_seed(32)
    shape = (4, 16, 14, 14) if fmt == "NCHW" else (4, 14, 14, 16)
    x = torch.randn(shape, generator=g) * 2 + 0.5
    w = torch.randn((32, 16, 3, 3), generator=g) * 0.2
    gam = torch.rand(32, generator=g) + 0.5
    bet = torch.randn(32, generator=g) * 0.1
    runs = {}
    for dev, fused in (("cpu", True), (card, True), (card, False)):
        xd, wd, gd, bd = (t.clone().to(dev).requires_grad_()
                          for t in (x, w, gam, bet))
        rm = torch.zeros(32, device=dev)
        rv = torch.ones(32, device=dev)
        if fused:
            y = fused_conv_bn(xd, wd, gd, bd, rm, rv, training=True,
                              stride=2, padding=1, data_format=fmt,
                              act_input=act_input)
        else:
            z = F.conv2d(F.relu(xd) if act_input else xd, wd, stride=2,
                         padding=1, data_format=fmt)
            y = F.batch_norm(z, rm, rv, gd, bd, training=True,
                             data_format=fmt)
        torch.tanh(y * 0.1).sum().backward()
        runs[(str(dev), fused)] = [t.detach().cpu() for t in (
            y, xd.grad, wd.grad, gd.grad, bd.grad, rm, rv)]
    card_fused = runs[(str(card), True)]
    assert torch.equal(card_fused[0], runs[(str(card), False)][0])
    for want in (runs[(str(card), False)], runs[("cpu", True)]):
        for got, ref in zip(card_fused, want):
            gap = ((got - ref).abs().max() / ref.abs().max()).item()
            assert gap <= 1e-4, gap


def test_resnet18_step_on_card_matches_host(card):
    """ResNet-18 (NHWC, the space-to-depth stem, fused conv + BN) at 2 x 64
    x 64: loss, every grad and the moved running statistics, in f64 (cuDNN
    runs f64 convs), where card and host agree to rounding whatever the
    draw. In f32 a ReLU input within rounding of 0 can flip its mask
    between two orders of summation and move the early layers' grads by
    ~1e-2 (it does for this draw); chip_smoke's vision_reference holds an
    f32 step on a draw without such a flip."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision.models import resnet18
    g = torch.Generator().manual_seed(33)
    x = torch.randn((2, 64, 64, 3), generator=g, dtype=torch.float64)
    y = torch.tensor([1, 7])
    runs = []
    for dev in ("cpu", card):
        model = resnet18(num_classes=10, data_format="NHWC",
                         stem="space_to_depth", device=dev,
                         generator=pt.make_generator(0)).double()
        loss = F.cross_entropy(model(x.to(dev)), y.to(dev))
        loss.backward()
        runs.append((loss.item(),
                     {n: p.grad.cpu() for n, p in model.named_parameters()},
                     {n: b.cpu() for n, b in model.named_buffers()}))
    (h_loss, h_grads, h_stats), (c_loss, c_grads, c_stats) = runs
    assert abs(c_loss - h_loss) <= 1e-12 * abs(h_loss)
    for name, want in h_grads.items():
        assert _rel_l2(c_grads[name], want) <= 1e-10, name
    for name, want in h_stats.items():
        gap = ((c_stats[name] - want).abs().max() / want.abs().max()).item()
        assert gap <= 1e-12, name


def test_resnet_paths_never_sync_the_host(card):
    """After a first call (which reads the degenerate-gamma guard's verdict
    once per parameter), a ResNet-18 training step and its eval forward,
    fused and not, run with no host sync: torch's sync debug mode raises
    on any."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.vision.models import resnet18
    x = torch.randn((4, 64, 64, 3), device=card).bfloat16()
    y = torch.randint(0, 10, (4,), device=card)
    for fused in (True, False):
        model = resnet18(num_classes=10, data_format="NHWC",
                         stem="space_to_depth", fused_conv_bn=fused,
                         device=card).bfloat16()
        opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())

        def train_step():
            loss = F.cross_entropy(model.train()(x).float(), y)
            loss.backward()
            opt.step()
            opt.clear_grad()

        def eval_forward():
            with torch.no_grad():
                model.eval()(x)
        train_step()
        eval_forward()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            train_step()
            eval_forward()
        finally:
            torch.cuda.set_sync_debug_mode("default")


def test_resnet_step_captures_and_moves_running_stats(card):
    """A bf16 ResNet-18 step (NHWC, fused conv + BN) under to_static: the
    capture takes cuDNN's convolutions and the in-place running-statistic
    updates, so every replay moves the statistics and the loss falls on a
    repeated batch; no flash kernel is launched."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.vision.models import resnet18
    model = resnet18(num_classes=10, data_format="NHWC",
                     stem="space_to_depth", device=card,
                     generator=pt.make_generator(1))
    model.bfloat16()
    opt = pt.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                parameters=model.parameters())

    @pt.jit.to_static
    def step(x, y):
        loss = pt.nn.functional.cross_entropy(model(x).float(), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    compiled = CompiledTrainStep(step, label="resnet18")
    g = torch.Generator(device="cuda").manual_seed(34)
    x = torch.randn((8, 64, 64, 3), generator=g, device=card).bfloat16()
    y = torch.randint(0, 10, (8,), generator=g, device=card)
    launch_counts.clear()
    reset_compile_stats()
    means, losses = [], []
    for _ in range(6):
        losses.append(compiled(x, y).item())
        means.append(model.layer4[1].bn2._mean.float().clone())
    assert compile_stats()["compiles"] == 1
    assert step.programs[next(iter(step.programs))].graph is not None
    assert all(not torch.equal(a, b) for a, b in zip(means, means[1:]))
    assert losses[-1] < losses[0], losses
    assert all(launch_counts[n] == 0 for n in fa.KERNEL_NAMES)


def test_resnet_eval_fold_on_card_matches_bn_eval(card):
    """Eval on the fused op's folded statistics against BatchNorm in eval,
    both in f32 on the card, and against the host."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import resnet18
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator()
                    .manual_seed(35))
    outs = []
    for dev, fused in ((card, True), (card, False), ("cpu", True)):
        model = resnet18(num_classes=10, data_format="NHWC",
                         fused_conv_bn=fused, device=dev,
                         generator=pt.make_generator(2))
        model.train()
        with torch.no_grad():
            model(x.to(dev))      # move the running statistics
        model.eval()
        with torch.no_grad():
            outs.append(model(x.to(dev)).cpu())
    for other in outs[1:]:
        torch.testing.assert_close(outs[0], other, rtol=1e-4, atol=1e-4)


# -- the serving slice: a CUDA graph per signature ---------------------------

def _bert_predictor(card, bf16=False, **config):
    """A predictor over a 2-layer BERT at head dim 64 (the flash path at
    s = 256) on the card."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForSequenceClassification)
    model = BertForSequenceClassification(
        BertConfig(vocab_size=120, hidden_size=128, num_layers=2,
                   num_heads=2, intermediate_size=256, max_position=256,
                   dropout=0.0, **config), num_classes=2, device="cpu",
        generator=pt.make_generator(3))
    cfg = infer.Config()
    cfg.set_layer(model)
    if bf16:
        cfg.enable_low_precision(infer.DataType.BFLOAT16)
    return infer.create_predictor(cfg), model


def test_predictor_captures_one_graph_per_bucket(card):
    """A server's executor over a predictor on the card: one graph per
    bucket (compiles <= buckets), B1 in each (captured, not replayed by
    Python), replies equal to the bit to a direct replay of the graph, and
    within f32 summation order of the eager forward."""
    import numpy as np

    from paddle_tpu_torch.serving import BucketedExecutor
    pred, model = _bert_predictor(card)
    assert next(model.parameters()).is_cuda and not model.training
    ex = BucketedExecutor(pred)
    launch_counts.clear()
    ex.warmup((((256,), "int64"),), [1, 2, 4])
    # per bucket: an eager warm-up and the capture, 2 layers each
    assert launch_counts[fa.KERNEL_NAME] == 3 * 2 * 2
    assert ex.compile_count == 3 and len(pred._jit_cache) == 3
    ids = np.random.RandomState(0).randint(0, 120, (4, 256)).astype("int64")
    launch_counts.clear()
    [got] = ex.run([ids])
    assert launch_counts[fa.KERNEL_NAME] == 0 and ex.compile_count == 3
    prog = pred._jit_cache[(((4, 256), "int64"),)]
    prog.graph.graph.replay()
    torch.cuda.synchronize()
    assert np.array_equal(got, prog.graph.static_out[0].cpu().numpy())
    with torch.no_grad():
        eager = model(torch.tensor(ids, device=card)).cpu().numpy()
    np.testing.assert_allclose(got, eager, rtol=1e-4, atol=1e-5)


def test_predictor_capture_that_syncs_raises_without_fallback(card):
    import numpy as np

    import paddle_tpu_torch.inference as infer

    class Syncs(torch.nn.Module):
        def forward(self, x):
            if x.sum().item() > 0:       # a host sync: cannot be captured
                x = x + 1
            return x * 2

    cfg = infer.Config()
    cfg.set_layer(Syncs())
    pred = infer.create_predictor(cfg)
    x = np.ones((2, 4), "float32")
    for _ in range(2):     # and again: nothing falls back to eager
        with pytest.raises(RuntimeError, match="CUDA graph"):
            pred.run([x])
    assert pred._jit_cache == {}


def test_bf16_float_entry_eviction_frees_its_graph(card):
    import gc
    import weakref

    import numpy as np

    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch.serving import BucketedExecutor
    layer = torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.ReLU())
    cfg = infer.Config()
    cfg.set_layer(layer)
    cfg.enable_low_precision(infer.DataType.BFLOAT16)
    pred = infer.create_predictor(cfg)
    ex = BucketedExecutor(pred, max_cached=1)
    x = np.random.RandomState(1).randn(8, 64).astype("float32")
    [out] = ex.run([x])
    entry = pred._jit_cache[(((8, 64), "float32"),)]
    assert entry.graph.static_in[0].dtype == torch.bfloat16
    with torch.no_grad():
        want = layer.to(torch.bfloat16)(
            torch.tensor(x, device=card).to(torch.bfloat16)).float()
    # the same bf16 GEMM and ReLU, eager against captured
    np.testing.assert_allclose(out, want.cpu().numpy(), rtol=2 ** -7,
                               atol=1e-3)
    gone = weakref.ref(entry.graph)
    del entry
    ex.run([x[:4]])
    gc.collect()
    assert gone() is None
    assert list(pred._jit_cache) == [(((4, 64), "float32"),)]


def test_replicas_share_graphs_under_concurrent_load(card):
    """Two replicas of a threaded server share one graph per bucket;
    four client threads get each its own rows' logits."""
    import threading

    import numpy as np

    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig
    pred, model = _bert_predictor(card)
    cfg = infer.Config()
    cfg.set_layer(model)
    srv = InferenceServer(cfg, ServingConfig(
        max_batch_size=4, replicas=2,
        warmup_signatures=[(((256,), "int64"),)]))
    reps = srv.scheduler.replicas
    assert reps[0].executor.predictor._jit_cache is \
        reps[1].executor.predictor._jit_cache
    srv.start()
    rng = np.random.RandomState(2)
    rows = rng.randint(0, 120, (16, 256)).astype("int64")
    got = {}

    def client(k):
        for i in range(k, 16, 4):
            got[i] = srv.infer([rows[i:i + 1]], timeout=60.0)[0]

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    srv.stop()
    assert not any(t.is_alive() for t in threads) and len(got) == 16
    with torch.no_grad():
        eager = model(torch.tensor(rows, device=card)).cpu().numpy()
    np.testing.assert_allclose(np.concatenate([got[i] for i in range(16)]),
                               eager, rtol=1e-4, atol=1e-5)
    assert srv.stats()["compiles"] == 2 * 3    # warm-up only


def test_decode_step_graphs_match_the_host(card):
    """The compiled decode backend on the card: one graph per (bucket,
    signature), the same streams as on the host, with speculation too."""
    from paddle_tpu_torch.serving.decode import (CompiledDecodeBackend,
                                                 DecodeConfig, DecodeEngine,
                                                 MirrorDraft)
    runs = {}
    for dev in ("cpu", card):
        for k in (0, 3):
            backend = CompiledDecodeBackend(max_running=4, device=dev)
            eng = DecodeEngine(backend, DecodeConfig(
                max_running=4, max_new_tokens=6, spec_k=k,
                draft=MirrorDraft(corrupt_every=2) if k else None))
            streams = [eng.join(p) for p in ([1, 2, 3, 4, 5], [3, 1, 4],
                                             [1, 2, 3, 4, 5])]
            for _ in range(40):
                eng.step()
            runs[(str(dev), k)] = [list(s.tokens) for s in streams]
            assert backend.step.compile_count <= len(backend.buckets)
            assert eng.pool.free() == eng.pool.num_blocks
            if str(dev) != "cpu":
                progs = list(backend.step._programs.values()) + \
                    list(backend.vstep._programs.values())
                assert progs and all(p is not None for p in progs)
    assert runs[("cpu", 0)][0] == [30, 66, 139, 286, 581, 1172]
    assert len({str(v) for v in runs.values()}) == 1


# -- the training API slice -------------------------------------------------

class _Devices(torch.nn.Module):
    """A linear layer that records the device of every input it sees."""

    def __init__(self):
        super().__init__()
        self.fc = pt.nn.Linear(4, 3, device="cuda")
        self.seen = set()

    def forward(self, x):
        self.seen.add(x.device.type)
        return self.fc(x)


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("compiled", [True, False])
def test_fit_on_a_card_network_gets_only_cuda_batches(card, prefetch,
                                                      compiled):
    rng = np.random.RandomState(0)
    ds = pt.io.TensorDataset([rng.randn(40, 4).astype("float32"),
                              rng.randint(0, 3, 40).astype("int64")])
    pt.set_flags({"FLAGS_input_prefetch": prefetch,
                  "FLAGS_compiled_step": compiled})
    try:
        net = _Devices()
        model = pt.Model(net).prepare(
            pt.optimizer.SGD(learning_rate=0.1, parameters=net.parameters()),
            pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
        model.fit(ds, batch_size=8, epochs=2, verbose=0,
                  steps_per_execution=2)
        model.evaluate(ds, batch_size=8, verbose=0)
        model.predict(ds, batch_size=8)
    finally:
        pt.set_flags({"FLAGS_input_prefetch": True,
                      "FLAGS_compiled_step": True})
    assert net.seen == {"cuda"}


def test_prefetch_copy_is_ordered_before_the_step_reads_it(card,
                                                           monkeypatch):
    """Each staged batch's copy waits behind a ~10 ms spin on the side
    stream; the consumer reads it at once on its own stream and must see
    the batch's values, not the buffer's earlier contents."""
    from paddle_tpu_torch.hapi.prefetch import InputPrefetcher
    real = InputPrefetcher._stage

    def held_back(self, v):
        torch.cuda._sleep(20_000_000)  # on the prefetcher's side stream
        return real(self, v)
    monkeypatch.setattr(InputPrefetcher, "_stage", held_back)
    batches = [[torch.full((256, 1024), float(i))] for i in range(6)]
    pf = InputPrefetcher(batches, lambda b: (b, []), device=card)
    got, seen = [], []

    def consume():  # in a thread of its own, so the test bounds its wait
        while True:
            # blocking-ok: a daemon thread the test joins with a deadline
            item = pf.get()
            if item is InputPrefetcher.DONE:
                return
            (x,), _ = item
            seen.append(x.is_cuda)
            got.append((x * 1).mean().item())
    consumer = threading.Thread(target=consume, daemon=True)
    try:
        consumer.start()
        consumer.join(timeout=60)
        assert not consumer.is_alive(), "no batch staged within 60 s"
    finally:
        pf.close()
    assert all(seen) and got == [float(i) for i in range(6)]


class _CudaProbe(Dataset):
    """What a worker process sees of CUDA."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        import os
        return np.array([torch.cuda.is_available(),
                         torch.cuda.is_initialized(),
                         os.environ.get("CUDA_VISIBLE_DEVICES") == ""],
                        dtype=np.int64)


def test_a_spawned_worker_does_not_touch_cuda(card):
    torch.ones(1, device=card)  # the parent holds a context
    dl = pt.io.DataLoader(_CudaProbe(), batch_size=2, num_workers=2,
                          use_multiprocess=True)
    rows = torch.cat(list(dl)).tolist()
    assert rows == [[0, 0, 1]] * 4
    assert torch.cuda.is_initialized()


def test_model_save_and_load_round_trip_on_the_card(card, tmp_path):
    from paddle_tpu_torch.vision.datasets import MNIST
    from paddle_tpu_torch.vision.models import LeNet

    def model(seed):
        net = LeNet(device="cuda", generator=pt.make_generator(seed))
        return pt.Model(net).prepare(
            pt.optimizer.Adam(learning_rate=1e-3,
                              parameters=net.parameters()),
            pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    a = model(0)
    data = pt.io.Subset(MNIST(mode="train"), list(range(512)))
    a.fit(data, batch_size=64, epochs=1, verbose=0)
    a.save(str(tmp_path / "m"))
    b = model(1)
    b.load(str(tmp_path / "m"))
    for x, y in zip(a.network.state_dict().values(),
                    b.network.state_dict().values()):
        assert y.is_cuda and torch.equal(x, y)
    sa, sb = a._optimizer.state_dict(), b._optimizer.state_dict()
    assert sorted(sa) == sorted(sb)
    for k, v in sa.items():
        if isinstance(v, torch.Tensor):
            assert sb[k].is_cuda and torch.equal(v.reshape(-1),
                                                 sb[k].reshape(-1))
    assert a.evaluate(data, batch_size=128, verbose=0) == \
        b.evaluate(data, batch_size=128, verbose=0)


# -- the script surface (PR 10): the optimizers, sparse embedding gradients,
# recompute with dropout under capture, the tensor API -------------------------

OPTIMIZER_RUNS = {
    "SGD": dict(learning_rate=0.1),
    "Momentum": dict(learning_rate=0.1, momentum=0.9, multi_precision=True),
    "Adam": dict(learning_rate=0.01, multi_precision=True),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.1, multi_precision=True,
                  lr_ratio=lambda p: 0.5),
    "Adagrad": dict(learning_rate=0.1),
    "Adadelta": dict(learning_rate=1.0),
    "Adamax": dict(learning_rate=0.01),
    "RMSProp": dict(learning_rate=0.01, momentum=0.9, centered=True),
    "Lamb": dict(learning_rate=0.01),
    "Lars": dict(learning_rate=0.1),
    "LarsMomentum": dict(learning_rate=0.1, momentum=0.8),
    "Ftrl": dict(learning_rate=0.1, l1=0.01, l2=0.01),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("key", sorted(OPTIMIZER_RUNS))
def test_optimizer_on_card_matches_host(card, key, dtype):
    """Each optimizer (its multi-tensor passes) under L2Decay(0.01) and
    ClipGradByGlobalNorm(0.5) on the card and on the host from the same
    parameters and grads: 3 steps in f32, parameters and every
    accumulator within relative L2 1e-6; one step in bf16, within one
    bf16 ulp of the operands (2^-7 of the larger of the results and the
    value before the step: where p - u cancels, one ulp of u is many ulps
    of the result)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.regularizer import L2Decay
    kw = dict(OPTIMIZER_RUNS[key])
    if dtype == torch.float32:
        kw.pop("multi_precision", None)
    if key not in ("AdamW", "Lamb"):
        kw["weight_decay"] = L2Decay(0.01)
    rng = np.random.RandomState(4)
    shapes = [(64, 48), (48,), (300, 17)]
    inits = [torch.tensor(rng.randn(*s).astype("float32")).to(dtype)
             for s in shapes]
    grads = [[torch.tensor(rng.randn(*s).astype("float32")).to(dtype)
              for s in shapes]
             for _ in range(3 if dtype == torch.float32 else 1)]
    out = {}
    for device in ("cuda", "cpu"):
        params = [pt.Parameter(t.to(device, copy=True)) for t in inits]
        for i, p in enumerate(params):
            p.name = f"p{i}"
        opt = getattr(pt.optimizer, key)(
            parameters=params, grad_clip=pt.nn.ClipGradByGlobalNorm(0.5),
            **kw)
        for step_grads in grads:
            for p, g in zip(params, step_grads):
                p.grad = g.to(device, copy=True)
            opt.step()
            opt.clear_grad()
        out[device] = {**{p.name: p.detach().cpu() for p in params},
                       **{k: v.detach().cpu()
                          for k, v in opt.state_dict().items()}}
    assert sorted(out["cuda"]) == sorted(out["cpu"])
    before = {f"p{i}": t.float().abs() for i, t in enumerate(inits)}
    for k, want in out["cpu"].items():
        got = out["cuda"][k]
        if want.dtype == torch.bfloat16:
            scale = torch.maximum(got.float().abs(), want.float().abs())
            if k in before:
                scale = torch.maximum(scale, before[k])
            gap = ((got.float() - want.float()).abs()
                   / scale.clamp_min(1e-30)).max().item()
            assert gap <= 2 ** -7, (key, k, gap)
        else:
            assert _rel_l2(got.reshape(-1), want.reshape(-1)) <= 1e-6, \
                (key, k)


def test_captured_optimizer_keeps_its_addresses(card):
    """A captured step's multi-tensor update writes parameters, masters
    and accumulators in place: their addresses stay across replays and
    the replayed steps equal eager ones."""
    import paddle_tpu_torch as pt
    losses, ptrs = {}, []
    for compiled in (False, True):
        pt.set_flags({"FLAGS_compiled_step": compiled})
        try:
            torch.manual_seed(0)
            lin = pt.nn.Linear(32, 8, device=card)
            opt = pt.optimizer.Lamb(learning_rate=0.01,
                                    parameters=lin.parameters())

            @pt.jit.to_static
            def step(x):
                loss = (lin(x) ** 2).mean()
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss
            x = torch.ones(4, 32, device=card)
            got = []
            for _ in range(5):
                got.append(step(x).item())
                if compiled:
                    ptrs.append([p.data_ptr() for p in lin.parameters()]
                                + sorted(t.data_ptr() for t in
                                         opt.state_dict().values()))
            losses[compiled] = got
        finally:
            pt.set_flags({"FLAGS_compiled_step": True})
    assert all(p == ptrs[1] for p in ptrs[1:])
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-6)


def test_sparse_embedding_on_card(card):
    """sparse=True on the card: one gradient row per id; SGD's sparse
    step equals the dense one; lazy Adam leaves untouched rows bitwise
    and equals the host's."""
    import paddle_tpu_torch as pt
    ids = torch.tensor([[1, 5, 5, 9], [2, 9, 0, 5]])
    tables = {}
    for device, sparse, name in (("cuda", True, "SGD"),
                                 ("cuda", False, "SGD"),
                                 ("cuda", True, "Adam"),
                                 ("cpu", True, "Adam")):
        emb = pt.nn.Embedding(12, 16, sparse=sparse, device=device,
                              generator=torch.Generator().manual_seed(1))
        w0 = emb.weight.detach().clone()
        kw = dict(lazy_mode=True) if name == "Adam" else {}
        opt = getattr(pt.optimizer, name)(learning_rate=0.1,
                                          parameters=emb.parameters(), **kw)
        for _ in range(3):
            (emb(ids.to(device)) ** 2).sum().backward()
            g = emb.weight.grad
            assert g.is_sparse == sparse
            if sparse:
                assert g._values().shape[0] == ids.numel()
            opt.step()
            opt.clear_grad()
        tables[(device, sparse, name)] = (emb.weight.detach().cpu(),
                                          w0.cpu())
    s, d = tables[("cuda", True, "SGD")], tables[("cuda", False, "SGD")]
    assert (s[0] - d[0]).abs().max().item() <= 1e-6
    card_adam, host_adam = tables[("cuda", True, "Adam")], \
        tables[("cpu", True, "Adam")]
    untouched = [3, 4, 6, 7, 8, 10, 11]
    assert torch.equal(card_adam[0][untouched], card_adam[1][untouched])
    assert _rel_l2(card_adam[0], host_adam[0]) <= 1e-6


def test_recompute_with_dropout_under_capture(card):
    """A GPT with dropout 0.1 from a CUDA generator and recompute, its
    step captured: each replay's loss and grads equal the same captured
    step without recompute from the same generator state, and the second
    replay draws new masks."""
    import paddle_tpu_torch as pt
    xs, ys = _stream_batches(card, 1, seed=5)
    runs = {}
    for remat in (False, True):
        cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                        num_heads=2, max_position_embeddings=512,
                        dropout=0.1, recompute=remat)
        model = GPTForCausalLM(cfg, device=card,
                               generator=torch.Generator().manual_seed(0))
        gen = torch.Generator(device=card).manual_seed(3)
        for m in model.modules():
            if hasattr(m, "_generator"):
                m._generator = gen
        model.train()
        params = list(model.parameters())

        @pt.jit.to_static
        def step(x, y):
            for p in params:
                if p.grad is not None:
                    p.grad.zero_()
            loss = model(x, labels=y)
            loss.backward()
            return loss.float()
        step(xs[0], ys[0])
        out = []
        for _ in range(2):
            loss = step(xs[0], ys[0]).item()
            out.append((loss, [p.grad.detach().clone() for p in params]))
        runs[remat] = out
    for (lp, gp), (lr, gr) in zip(runs[False], runs[True]):
        assert abs(lr - lp) <= 1e-6 * abs(lp), (lr, lp)
        for a, b in zip(gr, gp):
            assert _rel_l2(a, b) <= 1e-5
    assert runs[True][0][0] != runs[True][1][0]


def _cases_match_host(cases):
    """Each case (tests/test_torch_*_cases.py) on the card against the
    host: f32 within 1e-6 (or the case's own host tolerance where
    larger), integers and bools exactly."""
    def run(c, device):
        pt.set_device(device)
        pt.seed(0)
        out = c.fn(pt, *[pt.to_tensor(a) for a in c.arrays])

        def numpy(o):
            if isinstance(o, (list, tuple)):
                return [numpy(v) for v in o]
            if isinstance(o, torch.Tensor):
                return o.detach().cpu().float().numpy() \
                    if o.dtype == torch.bfloat16 else o.detach().cpu().numpy()
            return np.asarray(o)
        out = numpy(out)
        return c.post(c.arrays, out) if c.post is not None else out

    def check(a, b, tol, cid):
        if isinstance(b, (list, tuple)):
            assert len(a) == len(b), cid
            for x, y in zip(a, b):
                check(x, y, tol, cid)
            return
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, cid
        if a.dtype.kind in "fc":
            np.testing.assert_allclose(a, b, err_msg=cid, equal_nan=True,
                                       **tol)
        else:
            np.testing.assert_array_equal(a, b, err_msg=cid)
    before = pt.get_device()
    try:
        for c in cases:
            tol = {"rtol": max(1e-6, c.tol.get("rtol", 0.0)),
                   "atol": max(1e-6, c.tol.get("atol", 0.0))}
            check(run(c, "gpu"), run(c, "cpu"), tol, c.id)
    finally:
        pt.set_device(before)


def test_tensor_api_cases_on_card_match_host(card):
    """Every case of tests/test_torch_tensor_cases.py on the card against
    the host: f32 within 1e-6 (a decomposition within its own host
    tolerance), integers and bools exactly."""
    from test_torch_tensor_cases import CASES
    _cases_match_host(CASES)


# -- the common surface (nn cases, MobileNetV2, the guard, the RNG state) ----
def test_nn_cases_on_card_match_host(card):
    """Every case of tests/test_torch_nn_cases.py on the card against the
    host: f32 within 1e-6 (interpolate and fold within their own host
    tolerance), integers and bools exactly, random draws by what their
    distribution guarantees."""
    from test_torch_nn_cases import CASES
    _cases_match_host(CASES)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_mobilenet_v2_step_on_card_matches_host(card, fmt):
    """MobileNetV2 (scale 0.25, 10 classes, classifier dropout 0) at 2 x
    64 x 64, one training step and the eval logits, card against host in
    f64 (in f32 a BN bias whose exact gradient is 0 gets rounding noise on
    both sides): loss and logits to 1e-12 relative, every grad within
    1e-10 of the model's grad norm."""
    from paddle_tpu_torch.vision.models import mobilenet_v2
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(2, 3, 64, 64))
    if fmt == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    y = torch.tensor(rng.randint(0, 10, (2,)))
    outs = []
    for device in ("cuda", "cpu"):
        model = mobilenet_v2(scale=0.25, num_classes=10, data_format=fmt,
                             device=device,
                             generator=pt.make_generator(6))
        model.classifier[0].p = 0.0
        model.to(dtype=torch.float64)
        loss = pt.nn.functional.cross_entropy(model(x.to(device)),
                                              y.to(device))
        loss.backward()
        model.eval()
        with torch.no_grad():
            logits = model(x.to(device)).cpu()
        outs.append((loss.item(), logits,
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (l0, e0, g0), (l1, e1, g1) = outs
    assert abs(l0 - l1) <= 1e-12 * abs(l1)
    assert ((e0 - e1).norm() / e1.norm()).item() <= 1e-12
    norm = torch.sqrt(sum((g ** 2).sum() for g in g1.values())).item()
    for n in g1:
        assert (g0[n] - g1[n]).norm().item() <= 1e-10 * norm, n


@pytest.mark.parametrize("write", ["set_state_dict", "load_state_dict",
                                   "zero_"])
def test_guard_after_a_write_through_a_captured_step(card, write):
    """ROADMAP C3 on the card: a step through fused_residual_ln captured
    by to_static and warm with an all-ones weight; after a write that
    zeroes channel 3 the next call builds a new program and its dw equals
    plain autograd's (not 0 at channel 3)."""
    from paddle_tpu_torch.ops import fused_residual_ln as rln
    g = torch.Generator(device="cuda").manual_seed(7)
    x, y, ct = (torch.randn((4, 64, 256), generator=g, device="cuda")
                for _ in range(3))
    ln = pt.nn.LayerNorm(256, device="cuda")

    @pt.jit.to_static
    def step(a, b, c):
        rln.fused_residual_ln(a, b, ln.weight, ln.bias).backward(c)
        dw = ln.weight.grad
        ln.weight.grad = None
        return dw
    for _ in range(3):
        step(x, y, ct)
    assert len(step.programs) == 1
    zeroed = torch.ones(256, device="cuda")
    zeroed[3] = 0.0
    if write == "set_state_dict":
        ln.set_state_dict({"weight": zeroed})
    elif write == "load_state_dict":
        ln.load_state_dict({"weight": zeroed, "bias": ln.bias.detach()})
    else:
        with torch.no_grad():
            ln.weight[3].zero_()
    got = [step(x, y, ct) for _ in range(3)][-1]
    assert len(step.programs) == 2
    w = ln.weight.detach().clone().requires_grad_()
    z = x + y
    out = (z - z.mean(-1, keepdim=True)) * torch.rsqrt(
        z.var(-1, correction=0, keepdim=True) + 1e-5) * w + ln.bias.detach()
    out.backward(ct)
    assert abs(got[3].item()) > 1e-3
    assert (got - w.grad).abs().max().item() <= \
        1e-5 * max(1.0, w.grad.abs().max().item())


def test_cuda_rng_state_round_trip_repeats_a_dropout_mask(card):
    """get_cuda_rng_state / set_cuda_rng_state over the default generators
    seed() seeds: a round trip repeats the next dropout mask; both refuse
    inside a capture."""
    x = torch.ones(4096, device="cuda")
    pt.seed(3)
    pt.nn.functional.dropout(x, 0.5)
    state = pt.get_cuda_rng_state()
    assert len(state) == torch.cuda.device_count()
    a = pt.nn.functional.dropout(x, 0.5)
    b = pt.nn.functional.dropout(x, 0.5)
    assert not torch.equal(a, b)
    pt.set_cuda_rng_state(state)
    assert torch.equal(pt.nn.functional.dropout(x, 0.5), a)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            pt.get_cuda_rng_state()
    torch.cuda.synchronize()


# -- the rest of nn (nn_rest cases, RNNs, beam search, the LSTM LM step) ------
def test_nn_rest_cases_on_card_match_host(card):
    """Every case of tests/test_torch_nn_rest_cases.py on the card against
    the host: f32 within 1e-6 (the transposed convs and the samplers
    within their own host tolerance, 1e-5), integers and bools exactly."""
    from test_torch_nn_rest_cases import CASES
    _cases_match_host(CASES)


@pytest.mark.parametrize("cls,out_tol,grad_tol", [
    ("LSTM", 1e-5, 1e-4), ("GRU", 1e-5, 1e-4), ("SimpleRNN", 2e-5, 5e-4)])
def test_rnn_on_card_matches_host(card, cls, out_tol, grad_tol):
    """A 2-layer bidirectional RNN through cuDNN against the same weights
    on the host, f32: outputs and final states within 1e-5, the input's
    and every weight's grad within 1e-4 (relative to 1 + |grad|). The
    tanh SimpleRNN within 2e-5 and 5e-4: cuDNN's tanh cell sits 8-9.6e-6
    (outputs) and 0.7-1.4e-4 (grads) from the f64 truth on an H100, where
    the host's f32 sits 2e-7 and 2-3e-6."""
    x = torch.randn(3, 7, 16, generator=torch.Generator().manual_seed(0))

    def run(device, state=None):
        layer = getattr(pt.nn, cls)(16, 16, num_layers=2,
                                    direction="bidirect", device=device,
                                    generator=pt.make_generator(1))
        if state is not None:
            layer.set_state_dict(state)
        xi = x.detach().to(device).requires_grad_()
        out, final = layer(xi)
        outs = [out, *(final if isinstance(final, tuple) else (final,))]
        sum((o * (i + 1.5)).sum() for i, o in enumerate(outs)).backward()
        grads = [xi.grad] + [p.grad for p in layer.parameters()]
        return ([o.detach().cpu() for o in outs],
                [g.cpu() for g in grads], layer.state_dict())
    host_out, host_grads, state = run("cpu")
    card_out, card_grads, _ = run("cuda", state)
    for a, b in zip(card_out, host_out):
        assert (a - b).abs().max().item() <= out_tol
    for a, b in zip(card_grads, host_grads):
        assert ((a - b).abs() / (1 + b.abs())).max().item() <= grad_tol


def test_beam_search_tie_rule_on_card_matches_host(card):
    """The top-k of tied scores keeps the lower index first on the card as
    on the host, and a beam search with a vocabulary smaller than the
    beam (ties among step 0's -1e9 beams) and finishing beams steps
    identically on both."""
    from paddle_tpu_torch.nn.decode import top_k_lower_index_first
    g = torch.Generator().manual_seed(2)
    scores = torch.randint(0, 4, (6, 4 * 37), generator=g).float() - 1e9
    for k in (1, 4, 9):
        host = top_k_lower_index_first(scores, k)
        dev = top_k_lower_index_first(scores.cuda(), k)
        assert torch.equal(dev[1].cpu(), host[1])
        assert torch.equal(dev[0].cpu(), host[0])

    def trace(device):
        table = torch.tensor([[0.0, 1.0, 1.0], [2.0, 0.5, 0.5],
                              [0.0, 0.0, 3.0]], device=device)

        class Table(pt.nn.Layer):
            def forward(self, ids, states):
                return table[ids.long()], states
        dec = pt.nn.BeamSearchDecoder(Table(), 0, 2, 4)
        inputs, states = dec.initialize(torch.zeros(2, 3, device=device))
        out = []
        for t in range(5):
            o, states, inputs, fin = dec.step(t, inputs, states)
            out += [o[0].cpu(), o[1].cpu(), fin.cpu()]
        return out
    for a, b in zip(trace("cuda"), trace("cpu")):
        assert torch.equal(a, b)


def test_lstm_lm_step_captured_on_card(card):
    """A two-layer LSTM language-model step (dropout 0, SGD + global-norm
    clip, (h, c) carried detached) captured by to_static: one CUDA graph,
    and its losses and final weights equal the eager steps' within 1e-5."""
    def run(compiled):
        pt.set_flags({"FLAGS_compiled_step": compiled})
        try:
            emb = pt.nn.Embedding(100, 32, device="cuda",
                                  generator=pt.make_generator(3))
            lstm = pt.nn.LSTM(32, 32, num_layers=2, device="cuda",
                              generator=pt.make_generator(4))
            proj = pt.nn.Linear(32, 100, device="cuda",
                                generator=pt.make_generator(5))
            params = [*emb.parameters(), *lstm.parameters(),
                      *proj.parameters()]
            opt = pt.optimizer.SGD(
                learning_rate=1.0, parameters=params,
                grad_clip=pt.nn.ClipGradByGlobalNorm(5.0))
            h = torch.zeros(2, 4, 32, device="cuda")
            c = torch.zeros(2, 4, 32, device="cuda")

            @pt.jit.to_static
            def step(x, y):
                out, (hn, cn) = lstm(emb(x), (h, c))
                loss = pt.nn.functional.cross_entropy(
                    proj(out).reshape([-1, 100]), y.reshape([-1]))
                loss.backward()
                opt.step()
                opt.clear_grad()
                with torch.no_grad():
                    h.copy_(hn)
                    c.copy_(cn)
                return loss
            g = torch.Generator(device="cuda").manual_seed(6)
            data = torch.randint(0, 100, (6, 4, 6), generator=g,
                                 device="cuda")
            losses = [step(d[:, :-1].contiguous(), d[:, 1:].contiguous())
                      for d in data]
            programs = list(step.programs.values()) if compiled else []
            return (torch.stack(losses).cpu(), proj.weight.detach().cpu(),
                    programs)
        finally:
            pt.set_flags({"FLAGS_compiled_step": True})
    captured, w_captured, programs = run(True)
    eager, w_eager, _ = run(False)
    assert len(programs) == 1 and programs[0].graph is not None
    assert torch.allclose(captured, eager, rtol=1e-5, atol=1e-5)
    assert torch.allclose(w_captured, w_eager, rtol=1e-5, atol=1e-5)


# -- the rest of paddle.vision and paddle.text (zoo) --------------------------
ZOO_CARD = ["alexnet", "vgg11_bn", "squeezenet1_0", "googlenet",
            "inception_v3", "densenet121", "resnext50_32x4d"]


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("family", ZOO_CARD)
def test_zoo_step_on_card_matches_host(card, family, fmt):
    """Each vision family of tests/test_torch_zoo_stages.py, one training
    step and the eval outputs, card against host in f64 (in f32 a max-pool
    near-tie or a BatchNorm over a few values makes the step
    ill-conditioned): loss and outputs to 1e-10 relative, every grad
    within 1e-9 of the model's grad norm. ResNeXt through the fused op."""
    from test_torch_zoo_stages import FAMILIES, loss_of, no_dropout, outputs
    ctor, kw, hw, batch = FAMILIES[family][:4]
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.randn(batch, 3, hw, hw))
    if fmt == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    y = torch.tensor(rng.randint(0, 10, (batch,)))
    runs = []
    for device in ("cuda", "cpu"):
        model = getattr(pt.vision.models, ctor)(
            num_classes=10, data_format=fmt, device=device,
            generator=pt.make_generator(8), **kw)
        no_dropout(model, pt)
        model.to(dtype=torch.float64)
        loss = loss_of(pt, model(x.to(device)), y.to(device))
        loss.backward()
        model.eval()
        with torch.no_grad():
            outs = [o.cpu() for o in outputs(model(x.to(device)))]
        runs.append((loss.item(), outs,
                     {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (l0, e0, g0), (l1, e1, g1) = runs
    assert abs(l0 - l1) <= 1e-10 * abs(l1)
    for a, b in zip(e0, e1):
        assert ((a - b).norm() / b.norm()).item() <= 1e-10
    norm = torch.sqrt(sum((g ** 2).sum() for g in g1.values())).item()
    for n in g1:
        assert (g0[n] - g1[n]).norm().item() <= 1e-9 * norm, n


def test_densenet_captured_steps_match_eager(card, request):
    """DenseNet-121 (10 classes, NHWC, f32) at 4 x 64 x 64: four
    Momentum(Nesterov) + L2Decay steps captured through CompiledTrainStep
    (one compile) give the eager steps' losses within 1e-4 relative,
    cuDNN held to its deterministic algorithms. The lr is 0.01: at 0.1
    the loss of these four images climbs 2.5 -> 16 in four steps, where
    the captured and eager runs part by 5e-4 on an H100."""
    import copy

    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    rng = np.random.RandomState(9)
    xs = torch.tensor(rng.randn(4, 4, 64, 64, 3).astype("float32")).cuda()
    ys = torch.tensor(rng.randint(0, 10, (4, 4))).cuda()
    model = pt.vision.models.densenet121(num_classes=10, data_format="NHWC",
                                         device="cuda",
                                         generator=pt.make_generator(2))
    twin = copy.deepcopy(model)

    def opt_for(m):
        return pt.optimizer.Momentum(
            learning_rate=0.01, momentum=0.9, use_nesterov=True,
            parameters=m.parameters(),
            weight_decay=pt.regularizer.L2Decay(1e-4))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    request.addfinalizer(lambda: setattr(torch.backends.cudnn,
                                         "deterministic", deterministic))
    eager_opt = opt_for(twin)
    eager = []
    for i in range(4):
        loss = pt.nn.functional.cross_entropy(twin(xs[i]), ys[i])
        loss.backward()
        eager_opt.step()
        eager_opt.clear_grad()
        eager.append(loss.item())
    opt = opt_for(model)

    @pt.jit.to_static
    def step(x, y):
        loss = pt.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    reset_compile_stats()
    got = CompiledTrainStep(step, label="densenet").run_steps(xs, ys)
    assert compile_stats()["compiles"] == 1
    for a, b in zip(got.tolist(), eager):
        assert abs(a - b) <= 1e-4 * abs(b), (got.tolist(), eager)


@pytest.mark.parametrize("name", ["squeezenet1_1", "googlenet"])
def test_zoo_predictor_on_card_matches_eager(card, name):
    """A vision family served by inference.Predictor in bf16 (one CUDA
    graph) at 4 x 96 x 96 NHWC: every output row within relative L2 2^-7
    of a bf16 eager forward (GoogLeNet's three outputs each)."""
    import copy

    import paddle_tpu_torch.inference as infer
    model = getattr(pt.vision.models, name)(
        num_classes=1000, data_format="NHWC", device="cuda",
        generator=pt.make_generator(3)).eval()
    images = np.random.RandomState(4).randn(4, 96, 96, 3).astype("float32")
    twin = copy.deepcopy(model).bfloat16()
    with torch.no_grad():
        out = twin(torch.from_numpy(images).cuda().bfloat16())
    eager = [o.float().cpu().numpy()
             for o in (out if isinstance(out, tuple) else (out,))]
    cfg = infer.Config()
    cfg.set_layer(model)
    cfg.enable_low_precision(infer.DataType.BFLOAT16)
    got = infer.create_predictor(cfg).run([images])
    assert len(got) == len(eager)
    for g, e in zip(got, eager):
        gaps = np.linalg.norm(g - e, axis=1) / np.linalg.norm(e, axis=1)
        assert np.all(gaps <= 2 ** -7), gaps


def test_vision_ops_on_card_match_host(card):
    """Every op of vision.ops and viterbi_decode at small sizes, card
    against host: floats within 1e-5 of the largest magnitude, indices,
    counts and paths identical; nms_padded captured in a CUDA graph
    replays the eager call's result."""
    from paddle_tpu_torch.text import viterbi_decode
    from paddle_tpu_torch.vision import ops
    rng = np.random.RandomState(11)

    def f32(*shape, scale=1.0):
        return torch.tensor((rng.randn(*shape) * scale).astype("float32"))
    xy = rng.rand(40, 2) * 30
    boxes = torch.tensor(np.concatenate(
        [xy, xy + rng.rand(40, 2) * 20 + 2], 1).astype("float32"))
    num = torch.tensor([15, 25], dtype=torch.int32)
    scores = torch.tensor(rng.permutation(40).astype("float32") / 40)
    cats = torch.tensor(rng.randint(0, 5, 40))
    cases = [
        (lambda x, b, n: ops.roi_align(x, b, n, 7, 0.5), [f32(2, 8, 28, 30),
                                                         boxes, num]),
        (lambda x, b, n: ops.roi_pool(x, b, n, 7, 0.5), [f32(2, 8, 28, 30),
                                                        boxes, num]),
        (lambda x, b, n: ops.psroi_pool(x, b, n, 3, 0.5),
         [f32(2, 18, 28, 30), boxes, num]),
        (lambda x, o, w, m: ops.deform_conv2d(x, o, w, padding=1,
                                              deformable_groups=2, mask=m),
         [f32(2, 8, 12, 14), f32(2, 36, 12, 14, scale=2.0), f32(6, 8, 3, 3),
          torch.rand(2, 18, 12, 14)]),
        (lambda b, s: ops.nms(b, 0.5, s), [boxes, scores]),
        (lambda b, s, c: ops.nms_padded(b, s, 0.5, 30, category_idxs=c),
         [boxes, scores, cats]),
        (lambda x, i: ops.yolo_box(x, i, [10, 13, 16, 30, 33, 23], 4),
         [f32(2, 27, 5, 6), torch.tensor([[160, 192], [96, 128]])]),
        (lambda p, t, n: viterbi_decode(p, t, n),
         [f32(5, 9, 4), f32(4, 4), torch.tensor([9, 3, 1, 7, 9])]),
    ]
    gt = np.zeros((2, 4, 4), "float32")
    gt[:, :3] = [[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.1, 0.1],
                 [0.1, 0.9, 0.3, 0.2]]
    cases.append((lambda x, b, lab: ops.yolo_loss(
        x, b, lab, [10, 13, 16, 30, 33, 23], [0, 1, 2], 4, 0.5, 32,
        use_label_smooth=True),
        [f32(2, 27, 4, 4), torch.tensor(gt),
         torch.tensor(rng.randint(0, 4, (2, 4)))]))
    for fn, args in cases:
        got = fn(*[a.cuda() for a in args])
        want = fn(*args)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.is_cuda
            if w.is_floating_point():
                gap = (g.cpu() - w).abs().max() / w.abs().max().clamp_min(1)
                assert gap.item() <= 1e-5, (fn.__name__, args[0].shape,
                                            gap.item())
            else:
                assert torch.equal(g.cpu(), w), (fn.__name__, g, w)
    args = [boxes.cuda(), scores.cuda(), cats.cuda()]
    eager = ops.nms_padded(*args[:2], 0.5, 30, category_idxs=args[2])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        ops.nms_padded(*args[:2], 0.5, 30, category_idxs=args[2])
    with torch.cuda.graph(graph, stream=side):
        captured = ops.nms_padded(*args[:2], 0.5, 30, category_idxs=args[2])
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))
    with pytest.raises(TypeError, match="nms_padded"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            ops.nms(args[0], 0.5, args[1])


def test_tokenizer_into_bert_predictor_on_card(card):
    """FasterTokenizer lands its ids on the card equal to the host's; a
    2-layer BERT (4 heads of 64) served in bf16 by inference.Predictor
    at 2 x 256 with no mask runs B1 once a layer in the warm-up and once
    in the capture, and its logits are within relative L2 2^-7 of a bf16
    eager forward."""
    import copy

    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch.text import FasterTokenizer, Vocab
    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForSequenceClassification)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        [chr(c) for c in range(ord("a"), ord("z") + 1)] + \
        ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)] + \
        ["the", "fox", "##es", "über", "你", "."]
    tok = FasterTokenizer(Vocab.from_dict({w: i for i, w in
                                           enumerate(words)}))
    docs = [" ".join(["The foxes jump, über 你好."] * 60)] * 2
    before = pt.get_device()
    pt.set_device("cpu")
    try:
        host = tok(docs, max_seq_len=256)
    finally:
        pt.set_device(before)
    ids, seg = tok(docs, max_seq_len=256)
    assert ids.is_cuda and ids.shape == (2, 256)
    assert torch.equal(ids.cpu(), host[0]) and torch.equal(seg.cpu(),
                                                           host[1])
    cfg = BertConfig(vocab_size=len(words), hidden_size=256, num_layers=2,
                     num_heads=4, intermediate_size=512, dropout=0.0)
    model = BertForSequenceClassification(
        cfg, device="cuda", generator=torch.Generator().manual_seed(1)).eval()
    with torch.no_grad():
        eager = copy.deepcopy(model).bfloat16()(ids, seg).float().cpu()
    icfg = infer.Config()
    icfg.set_layer(model)
    icfg.enable_low_precision(infer.DataType.BFLOAT16)
    launch_counts.clear()
    got = infer.create_predictor(icfg).run([ids.cpu().numpy(),
                                            seg.cpu().numpy()])[0]
    assert launch_counts[fa.KERNEL_NAMES[0]] == 2 * cfg.num_layers
    gaps = (torch.tensor(got) - eager).norm(dim=1) / eager.norm(dim=1)
    assert (gaps <= 2 ** -7).all(), gaps


# -- the autotuner and the tiles (ops/autotune.py) ----------------------------

@pytest.mark.parametrize("tile", fa.TILES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_every_tile_matches_plain(card, tile, causal, d):
    """Each instantiation of B1, B2 and B3 against the plain version,
    under the relative L2 gate a tile must keep to be timed."""
    q, k, v = _qkv(2, 512, 4, d, torch.bfloat16, 31)
    do = _qkv(2, 512, 4, d, torch.bfloat16, 32)[0].contiguous()
    scale = 1.0 / d ** 0.5
    out32, lse = fa._fwd_plain(q, k, v, causal, scale)
    want = fa.flash_attention_bwd_reference(q, k, v, out32, lse, do, causal,
                                            scale)
    lse, delta = lse.contiguous(), fa.bwd_delta(out32, do)
    got_o = fa._launch(q, k, v, causal, scale, tile=tile)[0]
    dk, dv = fa.launch_dkv(q, k, v, do, lse, delta, causal, scale, tile=tile)
    dq = fa.launch_dq(q, k, v, do, lse, delta, causal, scale, tile=tile)
    torch.cuda.synchronize()
    for got, ref in ((got_o, out32), (dq, want[0]), (dk, want[1]),
                     (dv, want[2])):
        gap = ((got.float() - ref.float()).norm() / ref.float().norm())
        assert gap.item() <= fa.TILE_GATE, (tile, gap.item())


def test_tuner_miss_under_capture_raises(card, tmp_path):
    """A capture cannot hold a timed search: a decision missing from the
    memo while a CUDA graph is being captured raises, naming the op and
    the signature, and nothing falls back."""
    from paddle_tpu_torch.ops import autotune
    prev = autotune.set_tuner(autotune.Autotuner(cache_dir=str(tmp_path)))
    try:
        q, k, v = (t.contiguous() for t in _qkv(1, 256, 2, 64,
                                                 torch.bfloat16, 33))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with pytest.raises(RuntimeError, match="flash_attention.*fwd|bh"):
            with torch.cuda.stream(side), torch.cuda.graph(graph,
                                                           stream=side):
                fa.flash_attention(q, k, v, causal=True, scale=0.125)
        # once decided eagerly, the capture hits the memo
        fa.flash_attention(q, k, v, causal=True, scale=0.125)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fa.flash_attention(q, k, v, causal=True, scale=0.125)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        assert autotune.counters()["mem_hits"] >= 1
    finally:
        autotune.set_tuner(prev)


# -- fleet's tensor parallelism on the card ---------------------------------

TP_GPT = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
              max_position_embeddings=256, dropout=0.0, tensor_parallel=True)
TP_BATCH, TP_SEQ = 2, 256          # s >= 256: attention takes B1-B3


def _tp_rank_run(device):
    """A TP GPT (mp 2) on ``device``: loss, the gathered grads, and the
    gathered weights after one SGD step through fleet's entry points
    (AdamW's first step would turn the rounding of the key bias's exact-0
    gradient into updates of lr); the counts of this rank's flash
    launches."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io_utils import unshard
    model = GPTForCausalLM(GPTConfig(**TP_GPT), device=device,
                           generator=torch.Generator().manual_seed(0))
    dist_model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        learning_rate=0.1, parameters=model.parameters()))
    rng = np.random.RandomState(7)
    x = torch.tensor(rng.randint(0, 256, (TP_BATCH, TP_SEQ)), device=device)
    y = torch.tensor(rng.randint(0, 256, (TP_BATCH, TP_SEQ)), device=device)
    launch_counts.clear()
    loss = dist_model(x, labels=y)
    loss.backward()
    grads = {}
    for n, p in model.named_parameters():
        split = getattr(p, "tp_split", None)
        grads[n] = (unshard(p.grad, split) if split is not None
                    else p.grad).cpu()
    launches = {k: launch_counts[k] for k in launch_counts
                if k.split(".")[0] in fa.KERNEL_NAMES}
    opt.step()
    return (loss.item(), grads,
            {k: v.cpu() for k, v in pt.full_state_dict(model).items()},
            launches)


def _tp_card_worker(out_path):
    """One of two ranks on the one card (gloo over CUDA tensors): the TP
    GPT on the card against the same ranks' run on the host."""
    import json

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env()
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs["mp_degree"] = 2
    fleet.init(strategy=strategy)
    card = _tp_rank_run("cuda")
    host = _tp_rank_run("cpu")

    def worst(a, b):
        return max(((a[k] - b[k]).abs() / (1e-4 + b[k].abs())).max().item()
                   for k in b)
    with open(out_path, "w") as f:
        json.dump({"loss": [card[0], host[0]],
                   "grad_worst": worst(card[1], host[1]),
                   "weight_worst": worst(card[2], host[2]),
                   "launches": card[3]}, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


def test_tp_gpt_on_card_matches_host(card, tmp_path):
    """A TP GPT (2 layers, hidden 256, 4 heads of 64: 2 a rank) at mp 2,
    two rank processes on the card: the loss within 1e-5 relative of the
    same ranks' host run, every gathered grad and the weights after one
    SGD step within 1e-4 + 1e-4 relative (f32, TF32 off); attention
    ran B1-B3 (the f32 CUDA-core variants) twice each on the card."""
    import json
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    here = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    procs = [subprocess.Popen(
        [sys.executable, here, "--tp-worker", str(tmp_path / f"r{r}.json")],
        cwd=repo, env={**os.environ, "PADDLE_TRAINER_ID": str(r),
                       "PADDLE_TRAINERS_NUM": "2",
                       "PADDLE_COORDINATOR_ADDR": addr,
                       "PYTHONPATH": repo},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (r, log[-3000:])
    for r in range(2):
        res = json.loads((tmp_path / f"r{r}.json").read_text())
        got, want = res["loss"]
        assert abs(got - want) <= 1e-5 * abs(want), res["loss"]
        assert res["grad_worst"] <= 1e-4, res
        assert res["weight_worst"] <= 1e-4, res
        for kernel in fa.KERNEL_NAMES:
            assert res["launches"].get(f"{kernel}.{fa.SIMT}", 0) == 2, res


# -- the layouts slice: ring attention's blocks, ZeRO-3 ------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_block_entry_points_match_plain_on_card(card, dtype, causal):
    """One block pair of ring attention on the card: B1's f32 O and LSE,
    and B2 and B3 under a given LSE and D, against their plain versions
    (f32 elementwise, bf16 by the tensor-core rule's 2^-7); a block off
    the kernels' contract (s = 96) takes the math block, counted."""
    from paddle_tpu_torch.ops import attention
    q, k, v = _qkv(1, 1024, 4, 64, dtype, 11)
    do = torch.randn(q.shape, device="cuda",
                     generator=torch.Generator(device="cuda")
                     .manual_seed(12)).to(dtype)
    scale = 0.125
    before = dict(attention.block_paths)
    launch_counts.clear()
    out, lse = attention.attention_block_fwd(q, k, v, causal, scale)
    want_o, want_l = fa._fwd_plain(q, k, v, causal, scale)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    delta = fa.bwd_delta(out, do)
    got = attention.attention_block_bwd(q, k, v, do, lse, delta, causal,
                                        scale)
    want = fa._bwd_plain(q, k, v, do, lse, delta, causal, scale)
    assert attention.block_paths["kernel"] - before["kernel"] == 2
    for kernel in fa.KERNEL_NAMES:
        assert launch_counts[fa.variant_counter(kernel, dtype)] == 1
    torch.testing.assert_close(lse, want_l, rtol=1e-4, atol=1e-4)
    pairs = [(out, want_o)] + list(zip(got, want))
    for g, w in pairs:
        if dtype == torch.float32:
            torch.testing.assert_close(g.float(), w, rtol=BWD_RTOL,
                                       atol=BWD_ATOL)
        else:
            assert _rel_l2(g, w) <= TC_REL_L2
    q, k, v = _qkv(1, 96, 4, 64, dtype, 13)
    attention.attention_block_fwd(q, k, v, causal, scale)
    assert attention.block_paths["math"] - before["math"] == 1


def test_ring_merged_lse_is_logsumexp_of_the_row(card):
    """Two blocks of keys merged by their LSEs (the ring's merge): the
    LSE is logsumexp of each whole row of scale * q . k, and the output
    the whole attention's (f32, the CUDA-core kernels)."""
    from paddle_tpu_torch.distributed.fleet.sequence_parallel import \
        merge_blocks
    q, k, v = _qkv(1, 512, 4, 64, torch.float32, 21)
    k2, v2 = _qkv(1, 512, 4, 64, torch.float32, 22)[:2]
    scale = 0.125
    parts = [fa.flash_attention_block_fwd(q, kk, vv, False, scale)
             for kk, vv in ((k, v), (k2, v2))]
    out, lse = merge_blocks(None, None, *parts[0])
    out, lse = merge_blocks(out, lse, *parts[1])
    keys = torch.cat([k, k2], dim=1)
    vals = torch.cat([v, v2], dim=1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, keys) * scale
    torch.testing.assert_close(lse, torch.logsumexp(scores, dim=-1),
                               rtol=1e-5, atol=1e-5)
    want = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), vals)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


def _layout_card_worker(out_path):
    """One of two ranks on the one card (gloo over CUDA tensors): a ring
    on {"sep": 2} at (1, 512, 4, 64) bf16 causal against one rank's B1,
    B2 and B3 over the whole; then a ZeRO-3 step on {"sharding": 2}
    (Model.prepare with SpecLayout(shard_params=True)) of a small f32 GPT
    against the same step of the whole model on this rank."""
    import json

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import sequence_parallel as sp
    from paddle_tpu_torch.distributed.mesh import build_mesh
    from paddle_tpu_torch.framework.io_utils import full_state_dict
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env()
    build_mesh({"sep": 2})
    q, k, v, do = (t.contiguous() for t in
                   _qkv(1, 512, 4, 64, torch.bfloat16, 31) + (_qkv(
                       1, 512, 4, 64, torch.bfloat16, 32)[0],))
    ts = [sp.split_sequence(t).clone().requires_grad_() for t in (q, k, v)]
    launch_counts.clear()
    o = sp.ring_attention(*ts, is_causal=True)
    o.backward(sp.split_sequence(do).contiguous())
    launches = {kk: launch_counts[kk] for kk in launch_counts
                if kk.split(".")[0] in fa.KERNEL_NAMES}
    _, lse, out32 = fa.flash_attention_fwd_for_grad(q, k, v, True, 0.125)
    ref = [out32] + list(fa.flash_attention_bwd(q, k, v, out32, lse, do,
                                                True, 0.125))
    got = [sp.gather_sequence(o.detach())] + [sp.gather_sequence(t.grad)
                                              for t in ts]
    gaps = [_rel_l2(g, w) for g, w in zip(got, ref)]
    build_mesh({"sharding": 2})
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randint(0, 256, (2, 256)), device="cuda")
    y = torch.tensor(rng.randint(0, 256, (2, 256)), device="cuda")
    cfg = dict(vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
               max_position_embeddings=256, dropout=0.0)

    def gpt():
        return GPTForCausalLM(GPTConfig(**cfg), device="cuda",
                              generator=torch.Generator().manual_seed(0))
    whole = gpt()
    wopt = pt.optimizer.AdamW(learning_rate=1e-3,
                              parameters=whole.parameters())
    wloss = whole(x, labels=y)
    wloss.backward()
    wopt.step()
    model = gpt()
    m = pt.Model(model)
    m.prepare(pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters()),
              loss=lambda loss: loss,
              spec_layout=dist.SpecLayout(shard_params=True))
    loss = m.train_batch([x, y])[0]
    got = full_state_dict(model)
    worst = max(((got[n] - p).abs() / (1e-4 + p.abs())).max().item()
                for n, p in whole.state_dict().items())
    with open(out_path, "w") as f:
        json.dump({"ring_gaps": gaps, "launches": launches,
                   "loss": [loss, wloss.item()], "weight_worst": worst,
                   "sharded": sum(1 for p in model.parameters()
                                  if getattr(p, "fsdp_split", None)
                                  is not None)}, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


def test_ring_and_zero3_on_card(card, tmp_path):
    """Two rank processes on the card: the ring's gathered output and
    grads within relative L2 2^-7 of one rank's kernels over the whole
    sequence, B1, B2 and B3 r + 1 times on rank r; the ZeRO-3 step's loss
    within 1e-5 relative and its gathered weights within 1e-4 + 1e-4
    relative of the whole model's step (f32, TF32 off)."""
    import json
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        addr = f"localhost:{sock.getsockname()[1]}"
    here = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    procs = [subprocess.Popen(
        [sys.executable, here, "--layout-worker",
         str(tmp_path / f"r{r}.json")],
        cwd=repo, env={**os.environ, "PADDLE_TRAINER_ID": str(r),
                       "PADDLE_TRAINERS_NUM": "2",
                       "PADDLE_COORDINATOR_ADDR": addr,
                       "PYTHONPATH": repo},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (r, log[-3000:])
    for r in range(2):
        res = json.loads((tmp_path / f"r{r}.json").read_text())
        assert max(res["ring_gaps"]) <= TC_REL_L2, res
        for kernel in fa.KERNEL_NAMES:
            assert res["launches"].get(f"{kernel}.{fa.TC}", 0) == r + 1, res
        got, want = res["loss"]
        assert abs(got - want) <= 1e-5 * abs(want), res["loss"]
        assert res["weight_worst"] <= 1e-4 and res["sharded"] > 0, res


def test_compiled_stage_program_captures_a_stage_on_card(card):
    """A pipeline stage's two directions as CompiledStagePrograms on the
    card: each captured as a CUDA graph on its second call and replayed
    after; the replays give the eager bodies' outputs and input grads and
    add the same parameter gradients into the stage's accumulators, by
    address (three calls: three times the eager gradients)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        PipelineLayer
    from paddle_tpu_torch.distributed.fleet.pipeline_engine import _Stage
    from paddle_tpu_torch.jit.compiled_step import CompiledStageProgram
    gen = torch.Generator().manual_seed(7)
    pl = PipelineLayer([pt.nn.Linear(32, 64, device="cuda", generator=gen),
                        pt.nn.GELU(),
                        pt.nn.Linear(64, 32, device="cuda", generator=gen)])
    st = _Stage(pl, is_last=False)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(8, 32, device="cuda", generator=g)
    dy = torch.randn(8, 32, device="cuda", generator=g)
    with torch.no_grad():
        want_y = st.run(x)
        want_dx = st.backward(x, dy)
    want = [a.clone() for a in st.acc]
    st.acc = [torch.zeros_like(p) for p in st.params]
    fwd = CompiledStageProgram(st.run, label="pp.s0.fwd")
    bwd = CompiledStageProgram(st.backward, label="pp.s0.bwd")
    with torch.no_grad():
        for _ in range(3):
            y = fwd(x)
            dx = bwd(x, dy)
    torch.cuda.synchronize()
    for prog in (fwd, bwd):
        stats = prog.stats()
        assert stats["captured"] == 1 and stats["hits"] == 1, stats
    torch.testing.assert_close(y, want_y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dx, want_dx, rtol=1e-6, atol=1e-6)
    for acc, w in zip(st.acc, want):
        torch.testing.assert_close(acc, 3 * w, rtol=1e-5, atol=1e-6)


# -- auto_parallel and incubate (the auto_moe slice) --------------------------

EXCHANGE_SHAPE = (8, 96, 64)   # (experts, capacity, width)


def _moe_card_worker(out_path):
    """One of two ranks on the card (gloo over CUDA tensors): the expert
    exchange's autograd Functions against their plain versions. Each rank
    draws every rank's inputs and cotangents from their seeds, so it
    computes the plain dispatch (each owner's block summed over the
    senders) and combine (every owner's block to every rank) and their
    gradients by autograd over all of them, and compares its own share."""
    import json

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import utils
    from paddle_tpu_torch.distributed.collective import get_group
    dist.init_parallel_env()
    rank, n = dist.get_rank(), dist.get_world_size()
    e, c, d = EXCHANGE_SHAPE
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]

        def draw(seed, shape):
            g = torch.Generator(device="cuda").manual_seed(seed)
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        bufs = [draw(10 + r, (e, c, d)).requires_grad_() for r in range(n)]
        cot = [draw(20 + r, (e // n, c, d)) for r in range(n)]
        plain = [torch.stack([b[o * e // n:(o + 1) * e // n]
                              for b in bufs]).sum(0) for o in range(n)]
        torch.autograd.backward(plain, cot)
        mine = bufs[rank].detach().clone().requires_grad_()
        utils.reset_exchange_stats()
        got = utils.expert_dispatch(mine, get_group(0))
        got.backward(cot[rank])
        res[f"dispatch.{name}"] = [
            bool(torch.equal(got, plain[rank])),
            bool(torch.equal(mine.grad, bufs[rank].grad))]
        res[f"bytes.{name}"] = utils.exchange_stats()["bytes"]
        locs = [draw(30 + r, (e // n, c, d)).requires_grad_()
                for r in range(n)]
        cot = [draw(40 + r, (e, c, d)) for r in range(n)]
        whole = torch.cat(locs)
        torch.autograd.backward([whole] * n, cot)
        mine = locs[rank].detach().clone().requires_grad_()
        got = utils.expert_combine(mine, get_group(0))
        got.backward(cot[rank])
        res[f"combine.{name}"] = [bool(torch.equal(got, whole)),
                                  bool(torch.equal(mine.grad,
                                                   locs[rank].grad))]
    with open(out_path, "w") as f:
        json.dump(res, f)
    dist.barrier()
    torch.distributed.destroy_process_group()


def test_moe_exchange_functions_match_plain_on_card(card, tmp_path):
    """The MoE exchange's dispatch and combine Functions on two rank
    processes on the card, forward and backward, in f32 and bf16: equal
    to their plain versions to the bit (each sums the same values in the
    same order), and the bytes a rank sends counted."""
    import json
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        addr = f"localhost:{sock.getsockname()[1]}"
    here = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    procs = [subprocess.Popen(
        [sys.executable, here, "--moe-worker", str(tmp_path / f"r{r}.json")],
        cwd=repo, env={**os.environ, "PADDLE_TRAINER_ID": str(r),
                       "PADDLE_TRAINERS_NUM": "2",
                       "PADDLE_COORDINATOR_ADDR": addr,
                       "PYTHONPATH": repo},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, (r, log[-3000:])
    e, c, d = EXCHANGE_SHAPE
    for r in range(2):
        res = json.loads((tmp_path / f"r{r}.json").read_text())
        for name in ("float32", "bfloat16"):
            assert res[f"dispatch.{name}"] == [True, True], res
            assert res[f"combine.{name}"] == [True, True], res
            size = 4 if name == "float32" else 2
            # forward and backward, each (2 ranks x E/2 x C x d)
            assert res[f"bytes.{name}"] == 2 * e * c * d * size, res


def test_moe_layer_on_card_matches_host(card):
    """MoELayer at one rank in f32 (TF32 off), top 2 with a capacity that
    drops tokens: the card's output, aux loss and every gradient within
    1e-5 relative of the host's, the dropped tokens equal."""
    gen = torch.Generator().manual_seed(3)
    host = pt.incubate.MoELayer(64, 128, 8, top_k=2, capacity_factor=0.5,
                                device="cpu", generator=gen)
    dev = pt.incubate.MoELayer(64, 128, 8, top_k=2, capacity_factor=0.5,
                               device="cuda")
    pt.load_numpy_state_dict(dev, host.state_dict())
    x = torch.randn(4, 96, 64, generator=torch.Generator().manual_seed(4))
    outs = []
    for layer, device in ((host, "cpu"), (dev, "cuda")):
        # a leaf of its own on each device (x.to("cpu") is x itself)
        xt = x.detach().clone().to(device).requires_grad_()
        y = layer(xt)
        ((y ** 2).mean() + 0.1 * layer.aux_loss).backward()
        outs.append([y.detach().cpu(), layer.aux_loss.detach().cpu(),
                     xt.grad.cpu()] + [p.grad.cpu()
                                       for p in layer.parameters()])
    assert dev.dropped_tokens.tolist() == host.dropped_tokens.tolist()
    assert sum(host.dropped_tokens.tolist()) > 0
    for got, want in zip(outs[1], outs[0]):
        assert _rel_l2(got, want) <= 1e-5


def test_auto_engine_at_one_rank_captures_its_merged_step_on_card(card):
    """auto_parallel's Engine at world size 1 on the card: its step under
    gradient merge (k 2) captured through to_static (an accumulating and a
    stepping program) gives the eager run's losses and weights
    (FLAGS_compiled_step=0), a small f32 GPT at s 256 with B1-B3 on their
    f32 variants."""
    from paddle_tpu_torch.distributed.auto_parallel import Engine, Strategy
    cfg = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
               max_position_embeddings=256, dropout=0.0)
    rng = np.random.RandomState(6)
    batches = [(rng.randint(0, 256, (2, 256)), rng.randint(0, 256, (2, 256)))
               for _ in range(6)]

    def loss_fn(logits, labels):
        return pt.nn.functional.cross_entropy(
            logits.reshape(-1, 256), labels.reshape(-1))
    runs = []
    for compiled in (True, False):
        pt.set_flags({"FLAGS_compiled_step": compiled})
        try:
            model = GPTForCausalLM(GPTConfig(**cfg), device="cuda",
                                   generator=torch.Generator().manual_seed(0))
            s = Strategy()
            s.gradient_merge.enable, s.gradient_merge.k_steps = True, 2
            engine = Engine(model, loss=loss_fn, strategy=s,
                            optimizer=pt.optimizer.AdamW(
                                learning_rate=1e-3,
                                parameters=model.parameters()))
            launch_counts.clear()
            losses = [engine.fit([b])["loss"][0] for b in batches]
            runs.append((losses, [p.detach().clone()
                                  for p in model.parameters()],
                         launch_counts.get(f"{fa.KERNEL_NAME}.{fa.SIMT}", 0)))
        finally:
            pt.set_flags({"FLAGS_compiled_step": True})
    (got, gw, captured), (want, ww, eager) = runs
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b in zip(gw, ww):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # eager: 2 layers a micro-step; captured: each program's discovery
    # and capture calls launch (4 calls), its replays do not (2)
    assert eager == 12 and captured == 8, (captured, eager)



# -- integrity, the async checkpointer and the profiler on the card -----------

def _card_gpt_state():
    """A 2-layer bf16 GPT on the card after one AdamW (multi-precision)
    step, with its optimizer."""
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=128, dropout=0.0)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
    opt = pt.optimizer.AdamW(learning_rate=1e-3, multi_precision=True,
                             parameters=model.parameters())
    ids = torch.randint(0, 256, (2, 64), device="cuda",
                        generator=torch.Generator(device="cuda")
                        .manual_seed(1))
    model(ids, labels=ids).backward()
    opt.step()
    opt.clear_grad()
    return model, opt


def _host_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host_tree(v) for v in x)
    return x


def test_checksum_of_a_card_model_equals_its_host_copy(card):
    from paddle_tpu_torch.resilience.integrity import (checksum_state,
                                                       state_bytes)
    model, opt = _card_gpt_state()
    host = [_host_tree(model.state_dict()), _host_tree(opt.state_dict())]
    assert checksum_state([model, opt]) == checksum_state(host)
    assert state_bytes([model, opt]) == state_bytes(host) > 0
    with torch.no_grad():   # one flipped bit on the card shows
        p = next(model.parameters())
        p.view(torch.int16).view(-1)[7] ^= 1
    assert checksum_state([model, opt]) != checksum_state(host)


def test_async_snapshot_of_card_tensors_reloads_equal_on_the_host(
        card, tmp_path):
    from paddle_tpu_torch.resilience.snapshot import (AsyncCheckpointer,
                                                      load_blob)
    model, opt = _card_gpt_state()
    want = _host_tree(model.state_dict())
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save({"m.pdparams": (model.state_dict(), "model"),
             "m.pdopt": (opt.state_dict(), "optimizer")}, step=1)
    with torch.no_grad():   # the next step writes: the snapshot holds
        for p in model.parameters():
            p.add_(1.0)
    assert ck.flush(timeout=120.0) == []
    blob, _ = load_blob(ck.root)
    assert set(blob["model"]) == set(want)
    for k, v in want.items():
        got = blob["model"][k]
        got = got if isinstance(got, torch.Tensor) else torch.as_tensor(got)
        assert got.dtype == v.dtype and torch.equal(got, v), k
    for k, v in _host_tree(opt.state_dict()).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(torch.as_tensor(blob["optimizer"][k]), v), k
    ck.close()


def test_record_event_and_b1_share_one_profiler_window(card):
    from paddle_tpu_torch import profiler
    q, k, v = _qkv(1, 256, 2, 64, torch.bfloat16, 5)
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU,
                                      profiler.ProfilerTarget.GPU])
    with prof:
        torch.ones(1, device="cuda").add_(1)     # lead the window in
        torch.cuda.synchronize()
        with profiler.RecordEvent("card.attention"):
            fa.flash_attention_fwd(q, k, v, True, 0.125)
        torch.cuda.synchronize()
    names = [e.name for e in prof.torch_profiler.events()]
    assert "card.attention" in names
    # a kernel's name is demangled: "void (anonymous namespace)::..."
    assert any("flash_fwd_tc_kernel" in n for n in names), \
        sorted(set(names))
    assert "card.attention" in profiler._recorder.aggregate()
    profiler.reset_profiler()

# -- serving over the wire, live rollout ----------------------------------------

def _replay_kernel_names(graph, replays=3):
    """The kernel names of ``replays`` replays of an InferenceGraph under
    torch.profiler (led in by one replay, whose records a window may lose;
    taken again up to three times if the window lost kernels)."""
    from collections import Counter
    counts = Counter()
    for _ in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with graph.lock:
                graph.graph.replay()
                torch.cuda.synchronize()
                for _ in range(replays):
                    graph.graph.replay()
                torch.cuda.synchronize()
        counts = Counter(e.name for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        if sum(c for n, c in counts.items() if "flash_fwd" in n) \
                >= (replays + 1) * 2:
            break
    return counts


def test_replica_added_under_traffic_replays_b1_and_matches_eager(card):
    """A replica added (with a predictor of its own, as a rollout's canary
    or an autoscaler's grow is) while four client threads keep two
    replicas busy: it captures one graph per warm bucket before it takes
    traffic and none after, its bucket graph replays B1 by kernel name
    once a layer (the SIMT variant, f32), and every reply is within f32
    summation order of the eager forward."""
    import copy

    import numpy as np

    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch.serving import InferenceServer, ServingConfig
    pred, model = _bert_predictor(card)
    cfg = infer.Config()
    cfg.set_layer(model)
    srv = InferenceServer(cfg, ServingConfig(
        max_batch_size=4, replicas=2,
        warmup_signatures=[(((256,), "int64"),)]))
    srv.start()
    rng = np.random.RandomState(4)
    rows = rng.randint(0, 120, (48, 256)).astype("int64")
    got, errors = {}, []

    def client(k):
        try:
            for i in range(k, 48, 4):
                got[i] = srv.infer([rows[i:i + 1]], timeout=120.0)[0]
        except Exception as e:     # reported below
            errors.append(repr(e))

    twin = copy.deepcopy(model)
    tcfg = infer.Config()
    tcfg.set_layer(twin)
    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    idx = srv.scheduler.add_replica(
        factory=lambda i: infer.create_predictor(tcfg))
    new = srv.scheduler.find_replica(idx)
    warm = new.compile_count
    for t in threads:
        t.join(timeout=300)
    for i in range(8):          # traffic after the add, on 3 replicas
        got[48 + i] = srv.infer([rows[i:i + 1]], timeout=120.0)[0]
    srv.stop()
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert warm == len(srv.config.buckets) == new.compile_count
    graph = new.executor.predictor._jit_cache[(((4, 256), "int64"),)].graph
    counts = _replay_kernel_names(graph)
    b1 = sum(c for n, c in counts.items() if "flash_fwd_kernel" in n)
    assert b1 == 4 * 2, counts           # 4 replays, 2 layers each
    assert not any("softmax" in n.lower() for n in counts), counts
    with torch.no_grad():
        eager = model(torch.tensor(rows, device=card)).cpu().numpy()
    for i, out in got.items():
        np.testing.assert_allclose(out, eager[i % 48][None], rtol=1e-4,
                                   atol=1e-5)


def test_building_and_dropping_predictors_returns_their_memory(card):
    """ROADMAP C14: a predictor's graphs, built and dropped again and
    again on one thread (as a rollout's canaries and an autoscaler's
    grows are), give back all the memory they took. Each graph used to
    capture on a stream of its own, and cuBLAS keeps a workspace for every
    stream it runs on for the life of the process."""
    import gc

    import numpy as np

    from paddle_tpu_torch.serving import BucketedExecutor
    ids = np.random.RandomState(7).randint(0, 120, (4, 256)).astype("int64")

    def build_and_drop():
        pred, model = _bert_predictor(card, bf16=True)
        ex = BucketedExecutor(pred)
        ex.warmup((((256,), "int64"),), [1, 2, 4])
        ex.run([ids])
        del ex, pred, model
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    base = build_and_drop()      # this thread's stream and workspace made
    after = [build_and_drop() for _ in range(3)]
    assert all(abs(a - base) <= 1 << 20 for a in after), (base, after)


def test_socket_reply_from_the_card_equals_eager(card):
    """A BERT predictor on the card behind SocketFrontend: each reply an
    InferenceClient gets equals the eager forward of its row (f32
    summation order); a predictor that returns CUDA tensors has them
    copied to the host before they are framed (bf16 stays bf16)."""
    import numpy as np

    import paddle_tpu_torch.inference as infer
    from paddle_tpu_torch.serving import (InferenceClient, InferenceServer,
                                          ServingConfig, SocketFrontend)
    pred, model = _bert_predictor(card)
    cfg = infer.Config()
    cfg.set_layer(model)
    rows = np.random.RandomState(6).randint(0, 120, (6, 256)).astype("int64")

    class OnCard:
        def run(self, arrays):
            with torch.no_grad():
                x = model(torch.tensor(np.asarray(arrays[0]), device=card))
            return [x, x.to(torch.bfloat16)]

    got = {}
    for name, src in (("predictor", cfg), ("tensors", lambda i: OnCard())):
        srv = InferenceServer(src, ServingConfig(max_batch_size=2,
                                                 replicas=1))
        srv.start()
        try:
            with SocketFrontend(srv) as fe, \
                    InferenceClient(fe.address) as cli:
                got[name] = [cli.infer([r[None]], timeout=60.0)
                             for r in rows]
        finally:
            srv.stop()
    with torch.no_grad():
        eager = model(torch.tensor(rows, device=card)).cpu()
    for i in range(len(rows)):
        np.testing.assert_allclose(got["predictor"][i][0],
                                   eager[i:i + 1].numpy(), rtol=1e-4,
                                   atol=1e-5)
        f32, bf16 = got["tensors"][i]
        assert isinstance(f32, np.ndarray)
        np.testing.assert_allclose(f32, eager[i:i + 1].numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert bf16.dtype == torch.bfloat16 and bf16.device.type == "cpu"
        assert torch.equal(bf16, torch.from_numpy(f32).to(torch.bfloat16))


if __name__ == "__main__":
    import sys
    if sys.argv[1:2] == ["--tp-worker"]:
        _tp_card_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--layout-worker"]:
        _layout_card_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--moe-worker"]:
        _moe_card_worker(sys.argv[2])
