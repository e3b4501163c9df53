"""Flash attention B1 in the PyTorch/CUDA port against the JAX reference.

The port's plain version of B1 (what its wrapper runs on a CPU tensor)
is held against paddle_tpu's Pallas forward run in interpret mode, for O
and LSE. The wrapper's checks and the attention selection rule are pure
logic and run here; the kernel itself runs in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import flash_attention as ref_fa
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa
from paddle_tpu_torch.ops.cuda import launch_counts

# The shapes here are tiny: one intra-op thread is enough, and it keeps
# torch's spinning OpenMP pool from taking cores from the timing-sensitive
# tests that other workers run beside these.
torch.set_num_threads(1)


def _qkv(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype("float32") for _ in range(3)]


def _ref(arrs, causal, scale, dtype=jnp.float32):
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrs)
    out, lse = ref_fa.flash_attention_fwd(q, k, v, causal=causal,
                                          scale=scale, interpret=True)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_b1_matches_pallas_interpret_f32(causal, d):
    arrs = _qkv((1, 256, 2, d), seed=d + causal)
    scale = 1.0 / np.sqrt(d)
    ref_out, ref_lse = _ref(arrs, causal, scale)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    out, lse = port_fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    assert out.dtype == torch.float32 and lse.shape == (1, 2, 256)
    # the tolerances of tests/test_tpu_native.py's flash tests
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)
    # the wrapper on a CPU tensor is the plain version, and launches nothing
    before = launch_counts[port_fa.KERNEL_NAME]
    w_out, w_lse = port_fa.flash_attention_fwd(q, k, v, causal, scale)
    assert torch.equal(w_out, out) and torch.equal(w_lse, lse)
    assert launch_counts[port_fa.KERNEL_NAME] == before


@pytest.mark.parametrize("causal", [False, True])
def test_plain_b1_matches_pallas_interpret_bf16(causal):
    """Both sides read the same bf16 inputs and compute in f32; their f32
    results may round to neighbouring bf16 values, so O is held to one
    bf16 ulp (2^-7 relative, values below 2) and LSE (f32) stays tight."""
    d = 64
    arrs = _qkv((1, 256, 2, d), seed=11 + causal)
    scale = 1.0 / np.sqrt(d)
    ref_out, ref_lse = _ref(arrs, causal, scale, dtype=jnp.bfloat16)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    out, lse = port_fa.flash_attention_fwd(q, k, v, causal, scale)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), ref_out, rtol=1e-2,
                               atol=1e-2)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)


def test_plain_b1_reads_strided_views():
    """q/k/v sliced out of a fused (b, s, 3, h, d) projection, as
    GPTAttention hands them over, give the same result as copies."""
    rng = np.random.RandomState(5)
    qkv = torch.from_numpy(rng.randn(2, 256, 3, 2, 64).astype("float32"))
    q, k, v = qkv.unbind(dim=2)
    assert q.stride(1) == 3 * 2 * 64
    got = port_fa.flash_attention_fwd(q, k, v, True, 0.125)
    want = port_fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                       v.contiguous(), True, 0.125)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("q_shape,k_shape,expected", [
    ((1, 256, 2, 64), (1, 256, 2, 64), True),
    ((2, 384, 4, 128), (2, 384, 4, 128), True),
    ((1, 256, 2, 192), (1, 256, 2, 192), True),
    ((1, 200, 2, 64), (1, 200, 2, 64), False),
    ((1, 256, 2, 32), (1, 256, 2, 32), False),
    ((1, 128, 2, 64), (1, 256, 2, 64), False),
])
def test_supports_matches_reference(q_shape, k_shape, expected):
    assert port_fa.supports(q_shape, k_shape) is expected
    assert ref_fa.supports(q_shape, k_shape) is expected


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("q,k,v,match", [
    (_t((1, 256, 2, 64), torch.float16), _t((1, 256, 2, 64), torch.float16),
     _t((1, 256, 2, 64), torch.float16), "float32 or bfloat16"),
    (_t((1, 256, 2, 64)), _t((1, 256, 2, 64), torch.bfloat16),
     _t((1, 256, 2, 64)), "of one dtype"),
    (_t((1, 200, 2, 64)), _t((1, 200, 2, 64)), _t((1, 200, 2, 64)),
     "contract"),
    (_t((1, 128, 2, 64)), _t((1, 256, 2, 64)), _t((1, 256, 2, 64)),
     "contract"),
    (_t((1, 256, 2, 192)), _t((1, 256, 2, 192)), _t((1, 256, 2, 192)),
     "not built"),
    (_t((1, 256, 2, 64)), _t((1, 256, 4, 64)), _t((1, 256, 4, 64)),
     "do not form"),
    (_t((256, 2, 64)), _t((256, 2, 64)), _t((256, 2, 64)), r"\(B, S, H, D\)"),
    (_t((1, 256, 2, 128))[..., ::2], _t((1, 256, 2, 64)),
     _t((1, 256, 2, 64)), "unit stride"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(q, k, v, match):
    with pytest.raises(ValueError, match=match):
        port_fa.flash_attention_fwd(q, k, v)


def test_wrapper_takes_grad_requiring_inputs():
    """The forward wrapper takes inputs that require grad (the autograd
    Function calls it with grad off; a direct call saves nothing) and on
    the host launches nothing."""
    q = torch.zeros((1, 256, 2, 64), requires_grad=True)
    before = launch_counts[port_fa.KERNEL_NAME]
    out, lse = port_fa.flash_attention_fwd(q, q, q)
    assert out.shape == q.shape and lse.shape == (1, 2, 256)
    assert launch_counts[port_fa.KERNEL_NAME] == before


def test_selection_rule(monkeypatch):
    q = _t((1, 256, 2, 64))
    short = _t((1, 128, 2, 64))
    # on the host the rule never picks the kernel
    assert not port_attn.flash_selected(q, q)
    monkeypatch.setattr(port_attn, "_kernel_available", lambda t: True)
    assert port_attn.flash_selected(q, q)
    assert not port_attn.flash_selected(short, short)        # s < 256
    assert not port_attn.flash_selected(q, q, attn_mask=q)   # mask
    assert not port_attn.flash_selected(q, q, dropout_p=0.1)  # dropout
    assert not port_attn.flash_selected(_t((1, 256, 2, 32)),
                                        _t((1, 256, 2, 32)))  # d % 64
    # cached decode step: s_q = 1 != s_k
    assert not port_attn.flash_selected(_t((1, 1, 2, 64)), q)


def test_use_kernel_flags():
    q = torch.from_numpy(_qkv((1, 256, 2, 64), 3)[0])
    with pytest.raises(ValueError, match="incompatible"):
        port_attn.scaled_dot_product_attention(
            q, q, q, attn_mask=torch.ones(256, 256, dtype=torch.bool),
            use_kernel=True)
    # use_kernel=True on the host takes B1's plain version; it agrees with
    # the math path, and use_kernel=False is the math path
    flash = port_attn.scaled_dot_product_attention(q, q, q, is_causal=True,
                                                   use_kernel=True)
    math = port_attn.scaled_dot_product_attention(q, q, q, is_causal=True,
                                                  use_kernel=False)
    np.testing.assert_allclose(flash.numpy(), math.numpy(), rtol=1e-5,
                               atol=1e-6)
