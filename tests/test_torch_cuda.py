"""The port's CUDA kernels and its GPT serving and training paths on a card.

Marked ``cuda``: every test here needs an NVIDIA card and the CUDA
toolkit, and skips without them. They import torch and the port only, so
they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, kernel against its plain version on the same inputs: bf16
outputs may round one ulp apart (2e-2 for values below 2), f32 outputs
differ by summation order (2e-5); LSE is f32 in both (1e-4). The
backward's grads are held elementwise to |err| <= atol + rtol * |plain|:
bf16 one ulp (rtol 2^-7), f32 summation order over up to 1024 terms with
cancellation in dS (rtol 1e-4); atol 1e-4 for values near zero.
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import launch_counts
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
BWD_RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-4}
BWD_ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no host mode (its "
                    "plain version is tested against the reference in "
                    "test_torch_flash_attention.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, 3, h, d), generator=g, device="cuda")
    return qkv.to(dtype).unbind(dim=2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [256, 512])
def test_kernel_matches_plain(card, s, causal, d, dtype):
    q, k, v = _qkv(2, s, 4, d, dtype, seed=s + d + causal)
    scale = d ** -0.5
    before = launch_counts[fa.KERNEL_NAME]
    out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert launch_counts[fa.KERNEL_NAME] == before + 1
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                        scale)
    assert out.dtype == dtype and out.is_contiguous()
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL[dtype]
    assert (lse - ref_lse).abs().max().item() <= 1e-4


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
    before = [launch_counts[n] for n in (fa.DKV_KERNEL, fa.DQ_KERNEL)]
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert [launch_counts[n] for n in (fa.DKV_KERNEL, fa.DQ_KERNEL)] == \
        [c + 1 for c in before]
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                            scale)
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.dtype == dtype and a.is_contiguous(), name
        err = (a.float() - b.float()).abs()
        bound = BWD_ATOL + BWD_RTOL[dtype] * b.float().abs()
        assert bool((err <= bound).all()), (name, err.max().item())


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
