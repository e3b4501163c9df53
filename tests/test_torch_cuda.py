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

The conv net slice (cuDNN, f32 with TF32 off) is held against the same
code on the host: conv2d and the poolings elementwise to 1e-4 relative +
1e-4 (the padded exclusive average pool among them, whose torch backward
is wrong on channels_last CUDA tensors), the fused conv + BN op's grads to 1e-4 of the largest, a ResNet-18
step in f64 to 1e-12 (loss, statistics) and 1e-10 (grads, relative L2),
and its eval logits in f32 to 1e-4.
"""
import pytest
import torch

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
