"""Flash attention B1 in the PyTorch/CUDA port against the JAX reference.

The port's plain version of B1 (what its wrapper runs on a CPU tensor)
is held against paddle_tpu's Pallas forward run in interpret mode, for O
and LSE. So is an emulation of the bf16 tensor-core kernel's rounding
points, under the relative-L2 bound the card holds that kernel to. The
wrapper's checks, its choice of kernel variant, its alignment rule and
the attention selection rule are pure logic and run here; the kernels
themselves run in tests/test_torch_cuda.py.
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


# the card's bound on the tensor-core outputs' relative L2 gap
TC_REL_L2 = 2 ** -7


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tc_fwd_emulated(q, k, v, causal, scale, block_k=64):
    """What the bf16 tensor-core B1 computes, rounding where it rounds:
    S in f32 from the bf16 q and k, the scale applied to S in f32, an
    online softmax over 64-key tiles whose P is rounded to bf16 before
    P . V (l sums the f32 P), O rounded to bf16. (B, S, H, D) in, (out
    bf16, lse f32 (B, H, S)) out."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s_len = qf.shape[2]
    m = torch.full(qf.shape[:3], -1e30)
    l = torch.zeros(qf.shape[:3])
    acc = torch.zeros(qf.shape)
    q_pos = torch.arange(s_len)[:, None]
    for k0 in range(0, s_len, block_k):
        ks, vs = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = (qf @ ks.transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + block_k)[None, :]
            s = torch.where(q_pos >= k_pos, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.to(torch.bfloat16).float() @ vs
        m = m_new
    l_safe = l.clamp_min(1e-30)
    out = (acc / l_safe[..., None]).transpose(1, 2).to(torch.bfloat16)
    return out, m + torch.log(l_safe)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_rounding_emulation_within_bound_of_pallas_bf16(causal, d):
    """The tensor-core kernel's rounding points cost less than the bound
    the card holds it to: the emulation's O is within relative L2 2^-7 of
    the Pallas forward on the same bf16 inputs (and not equal to it: the
    rounding is there), its LSE within f32 noise."""
    arrs = _qkv((2, 256, 2, d), seed=30 + d + causal)
    scale = 1.0 / np.sqrt(d)
    ref_out, ref_lse = _ref(arrs, causal, scale, dtype=jnp.bfloat16)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    out, lse = _tc_fwd_emulated(q, k, v, causal, scale)
    gap = _rel_l2(out.float().numpy(), ref_out)
    assert 0.0 < gap <= TC_REL_L2, gap
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-5, atol=1e-5)


def test_variant_is_a_function_of_dtype():
    """bf16 takes the tensor-core kernels, f32 the CUDA-core ones, for all
    three kernels; each variant has its own launch counter beside the
    kernel's and its own entry point."""
    assert port_fa.variant(torch.bfloat16) == port_fa.TC == "tc_bf16"
    assert port_fa.variant(torch.float32) == port_fa.SIMT == "simt_f32"
    assert port_fa.KERNEL_NAMES == (port_fa.KERNEL_NAME, port_fa.DKV_KERNEL,
                                    port_fa.DQ_KERNEL)
    entries = {port_fa._ENTRY[name, kind] for name in port_fa.KERNEL_NAMES
               for kind in (port_fa.TC, port_fa.SIMT)}
    assert len(entries) == 6
    for name in port_fa.KERNEL_NAMES:
        assert port_fa.variant_counter(name, torch.bfloat16) == \
            f"{name}.tc_bf16"
        assert port_fa.variant_counter(name, torch.float32) == \
            f"{name}.simt_f32"


def test_tc_operand_copies_a_misaligned_view():
    """A bf16 view whose base is 2 bytes past an allocation cannot be read
    16 bytes at a time: it is copied to a fresh contiguous tensor with the
    same values (``contiguous()`` would return it as it is)."""
    base = torch.arange(2 * 256 * 2 * 64 + 1, dtype=torch.float32)
    x = base.to(torch.bfloat16)[1:].view(2, 256, 2, 64)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert x.contiguous().data_ptr() == x.data_ptr()
    y = port_fa.tc_operand(x)
    assert y.data_ptr() != x.data_ptr() and y.data_ptr() % 16 == 0
    assert y.is_contiguous() and torch.equal(y, x)


def test_tc_operand_copies_strides_off_the_16_byte_grid():
    """A view with a sequence stride of 388 elements puts rows off 16-byte
    boundaries even where the base is aligned."""
    x = torch.zeros((2, 256, 388), dtype=torch.bfloat16)
    v = x[:, :, :128].unflatten(-1, (2, 64))
    assert v.data_ptr() % 16 == 0 and v.stride(1) % 8 != 0
    assert port_fa.tc_operand(v).data_ptr() != v.data_ptr()


def test_tc_operand_keeps_the_gpt_qkv_views():
    """GPTAttention's q, k, v are views of its fused (b, s, 3, h, d)
    projection at offsets 0, h*d and 2*h*d with strides that are multiples
    of 8: all three are read in place, as is a contiguous f32 LSE."""
    qkv = torch.zeros((2, 256, 3, 16, 64), dtype=torch.bfloat16)
    for t in qkv.unbind(dim=2):
        assert port_fa.tc_operand(t) is t
    lse = torch.zeros((2, 16, 256))
    assert port_fa.tc_operand(lse) is lse


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
