"""The port's CUDA kernels and its GPT serving path on a card.

Marked ``cuda``: every test here needs an NVIDIA card and the CUDA
toolkit, and skips without them. They import torch and the port only, so
they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, kernel against its plain version on the same inputs: bf16
outputs may round one ulp apart (2e-2 for values below 2), f32 outputs
differ by summation order (2e-5); LSE is f32 in both (1e-4).
"""
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import launch_counts
from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM

pytestmark = pytest.mark.cuda

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


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


def test_kernel_is_forward_only(card):
    q, k, v = _qkv(1, 256, 2, 64, torch.float32, seed=0)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_fwd(q, k, v)


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
