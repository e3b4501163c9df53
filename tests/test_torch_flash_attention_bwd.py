"""Flash attention backward (B2, B3) and its autograd Function in the
PyTorch/CUDA port, against the JAX reference.

The port's plain version of B2/B3 (what its wrapper runs on a CPU tensor)
is held against paddle_tpu's Pallas backward run in interpret mode, for
dq, dk and dv; the port's ``_FlashAttentionFn`` is held against
``jax.vjp`` of the reference's ``_flash_attention_diff``, checked by
gradcheck in float64, and fed the strided q/k/v views GPT hands it.
Emulations of the bf16 tensor-core B2's and B3's rounding points are held
against the Pallas backward under the relative-L2 bound the card holds
those kernels to.
The kernels themselves run in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.attention import _flash_attention_diff
from paddle_tpu.ops.pallas import flash_attention as ref_fa
from paddle_tpu_torch.ops import attention as port_attn
from paddle_tpu_torch.ops.cuda import flash_attention as port_fa
from paddle_tpu_torch.ops.cuda import launch_counts

# The shapes here are tiny: one intra-op thread is enough, and it keeps
# torch's spinning OpenMP pool from taking cores from the timing-sensitive
# tests that other workers run beside these.
torch.set_num_threads(1)

SHAPE = (1, 256, 2)
# f32: the tolerance of the reference's own backward parity test
# (tests/test_tpu_native.py, TestFlashAttentionBackward)
F32_TOL = dict(rtol=5e-4, atol=1e-5)
# bf16: both sides read the same bf16 inputs, compute in f32 and round to
# bf16 once; the f32 values differ by summation order only, so a result
# may land one bf16 ulp away (2^-7 relative), and near zero by the f32
# difference itself
BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)
# the card's bound on the tensor-core outputs' relative L2 gap
TC_REL_L2 = 2 ** -7


def _arrays(d, seed):
    rng = np.random.RandomState(seed)
    qkv = [(rng.randn(*SHAPE, d) * 0.3).astype("float32") for _ in range(3)]
    do = rng.randn(*SHAPE, d).astype("float32")
    return qkv, do


def _counts():
    return {name: launch_counts[name] for name in port_fa.KERNEL_NAMES}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_matches_pallas_interpret(causal, d, dtype):
    (q, k, v), do = _arrays(d, seed=d + 2 * causal)
    scale = 1.0 / np.sqrt(d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    out, lse = ref_fa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                          scale=scale, interpret=True)
    want = ref_fa.flash_attention_bwd(jq, jk, jv, out, lse, jdo,
                                      causal=causal, scale=scale,
                                      interpret=True)
    tdt = getattr(torch, dtype)

    def port(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
    before = _counts()
    got = port_fa.flash_attention_bwd(
        port(jq), port(jk), port(jv), port(out),
        torch.from_numpy(np.asarray(lse)), port(jdo), causal, scale)
    assert _counts() == before           # the host runs the plain version
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == tdt and g.shape == (*SHAPE, d) \
            and g.is_contiguous(), name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   err_msg=name, **tol)


def _scores_f32(q, k, causal, scale):
    """The tensor-core kernels' S: f32 products of the bf16 q and k, the
    scale applied in f32, -1e30 where a query precedes its key when
    causal. (B, H, S, S) from (B, H, S, D) f32 views of bf16 values."""
    s = (q @ k.transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        keep = torch.arange(n)[:, None] >= torch.arange(n)[None, :]
        s = torch.where(keep, s, -1e30)
    return s


def _tc_dkv_emulated(q, k, v, out, lse, do, causal, scale):
    """What the bf16 tensor-core B2 computes, rounding where it rounds:
    S^T in f32 from the bf16 k and q, the scale applied to S^T in f32, P^T
    = exp(S^T - LSE) rounded to bf16 before P^T . dO, dS^T = P^T * (dP^T -
    Dl) in f32 rounded to bf16 before dS^T . q, dK scaled once at the end,
    dK and dV rounded to bf16. (B, S, H, D) in and out."""
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    p = torch.exp(_scores_f32(qf, kf, causal, scale) - lse[..., None])
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ dof
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dk = (ds.to(torch.bfloat16).float().transpose(-1, -2) @ qf) * scale
    return tuple(g.transpose(1, 2).to(torch.bfloat16) for g in (dk, dv))


def _tc_dq_emulated(q, k, v, out, lse, do, causal, scale):
    """What the bf16 tensor-core B3 computes, rounding where it rounds: S
    in f32 from the bf16 q and k, the scale applied to S in f32, P =
    exp(S - LSE) and dS = P * (dP - Dl) in f32, dS rounded to bf16 before
    dS . K, dQ scaled once at the end and rounded to bf16. (B, S, H, D) in
    and out."""
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    p = torch.exp(_scores_f32(qf, kf, causal, scale) - lse[..., None])
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    dq = (ds.to(torch.bfloat16).float() @ kf) * scale
    return dq.transpose(1, 2).to(torch.bfloat16)


def _pallas_bf16_bwd(d, causal, seed):
    """bf16 inputs (B, S, H, D) = (2, 256, 2, d) made from ``seed``, and
    the Pallas forward and backward on them (interpret mode): (port
    inputs (q, k, v, out, lse, do) as torch tensors, Pallas (dq, dk, dv)
    as f64 numpy arrays)."""
    rng = np.random.RandomState(seed)
    q, k, v = ((rng.randn(2, 256, 2, d) * 0.3).astype("float32")
               for _ in range(3))
    do = rng.randn(2, 256, 2, d).astype("float32")
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jnp.bfloat16)
                       for a in (q, k, v, do))
    out, lse = ref_fa.flash_attention_fwd(jq, jk, jv, causal=causal,
                                          scale=scale, interpret=True)
    want = ref_fa.flash_attention_bwd(jq, jk, jv, out, lse, jdo,
                                      causal=causal, scale=scale,
                                      interpret=True)

    def port(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    inputs = (port(jq), port(jk), port(jv), port(out),
              torch.from_numpy(np.array(lse)), port(jdo))
    return inputs, [np.asarray(w.astype(jnp.float32), np.float64)
                    for w in want]


def _assert_within_tc_bound(got, want, names):
    for g, w, name in zip(got, want, names):
        gap = np.linalg.norm(g.double().numpy() - w) / np.linalg.norm(w)
        assert 0.0 < gap <= TC_REL_L2, (name, gap)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_rounding_emulation_within_bound_of_pallas_bf16(causal, d):
    """The tensor-core B2's rounding points cost less than the bound the
    card holds it to: the emulation's dK and dV are within relative L2
    2^-7 of the Pallas backward on the same bf16 inputs (and differ from
    it: the rounding is there)."""
    inputs, (_, want_dk, want_dv) = _pallas_bf16_bwd(d, causal,
                                                     seed=40 + d + causal)
    got = _tc_dkv_emulated(*inputs, causal, 1.0 / np.sqrt(d))
    _assert_within_tc_bound(got, (want_dk, want_dv), ("dk", "dv"))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_tc_dq_rounding_emulation_within_bound_of_pallas_bf16(causal, d):
    """The same for the tensor-core B3: the emulation's dQ is within
    relative L2 2^-7 of the Pallas backward's bf16 dq, and differs from
    it."""
    inputs, (want_dq, _, _) = _pallas_bf16_bwd(d, causal,
                                               seed=50 + d + causal)
    got = _tc_dq_emulated(*inputs, causal, 1.0 / np.sqrt(d))
    _assert_within_tc_bound((got,), (want_dq,), ("dq",))


@pytest.mark.parametrize("causal", [False, True])
def test_function_matches_jax_vjp_of_reference(causal):
    """Forward and backward of the port's autograd Function against
    jax.vjp of the reference's custom_vjp (B1 forward, B2/B3 backward, both
    in interpret mode)."""
    d = 64
    (q, k, v), do = _arrays(d, seed=20 + causal)
    scale = 1.0 / np.sqrt(d)
    out_r, vjp = jax.vjp(
        lambda a, b, c: _flash_attention_diff(a, b, c, causal, scale, True),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = _counts()
    out = port_attn.scaled_dot_product_attention(
        *ts, is_causal=causal, scale=scale, use_kernel=True)
    out.backward(torch.from_numpy(do))
    assert _counts() == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_r),
                               rtol=2e-5, atol=2e-6)
    for t, w, name in zip(ts, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"grad wrt {name}", **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_function_gradcheck_float64(causal):
    """The plain versions compute in f64 for f64 host inputs, so torch's
    gradcheck can hold the backward formulas against finite differences
    of the forward (fast mode: random projections of the Jacobian)."""
    rng = np.random.RandomState(3 + causal)
    ts = [torch.from_numpy(rng.randn(1, 128, 1, 64) * 0.5)
          .requires_grad_(True) for _ in range(3)]

    def fn(q, k, v):
        return port_attn._FlashAttentionFn.apply(q, k, v, causal, 0.125)
    assert torch.autograd.gradcheck(fn, ts, fast_mode=True)


def test_function_grads_through_strided_views():
    """q/k/v sliced out of a fused (b, s, 3, h, d) projection, as
    GPTAttention hands them over, give the same grads as copies; the qkv
    gradient is the three grads stacked."""
    rng = np.random.RandomState(6)
    base = torch.from_numpy(rng.randn(2, 256, 3, 2, 64).astype("float32"))
    g = torch.from_numpy(rng.randn(2, 256, 2, 64).astype("float32"))
    qkv = base.clone().requires_grad_(True)
    q, k, v = qkv.unbind(dim=2)
    assert q.stride(1) == 3 * 2 * 64
    port_attn.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           use_kernel=True).backward(g)
    copies = [t.detach().clone().requires_grad_(True)
              for t in base.unbind(dim=2)]
    port_attn.scaled_dot_product_attention(*copies, is_causal=True,
                                           use_kernel=True).backward(g)
    assert torch.equal(qkv.grad, torch.stack([c.grad for c in copies], 2))


def test_function_takes_an_expanded_cotangent():
    """The cotangent of a sum has stride 0 everywhere; the Function hands
    the backward a contiguous copy, and the grads match the math path's."""
    (q, k, v), _ = _arrays(64, seed=8)
    grads = []
    for use_kernel in (True, False):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        port_attn.scaled_dot_product_attention(
            *ts, is_causal=True, use_kernel=use_kernel).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def _z(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("out,lse,do,match", [
    (_z((1, 256, 2, 64)), _z((1, 2, 256)), _z((1, 128, 2, 64)), "shape"),
    (_z((1, 256, 2, 64)), _z((1, 256, 2)), _z((1, 256, 2, 64)), "lse"),
    (_z((1, 256, 2, 64)), _z((1, 2, 256), torch.bfloat16),
     _z((1, 256, 2, 64)), "lse"),
    (_z((1, 256, 2, 64), torch.bfloat16), _z((1, 2, 256)),
     _z((1, 256, 2, 64)), "must be"),
    (_z((1, 256, 2, 64)), _z((1, 2, 256)), _z((1, 256, 2, 128))[..., ::2],
     "unit stride"),
])
def test_bwd_wrapper_rejects_what_the_kernels_do_not_take(out, lse, do,
                                                          match):
    q = _z((1, 256, 2, 64))
    with pytest.raises(ValueError, match=match):
        port_fa.flash_attention_bwd(q, q, q, out, lse, do)


def test_bf16_function_takes_delta_from_the_unrounded_output():
    """For bf16 inputs the Function's backward computes D = rowsum(dO * O)
    from O before its rounding to bf16: its grads equal the plain backward
    given the f32 O, and differ from the plain backward given the bf16 O
    (the reference's choice), whose rounding enters a whole row of dS with
    one sign. The rows of dS then sum to zero, as in exact arithmetic, so
    the grad of a bias added to every key (sum of dK over the keys)
    vanishes up to bf16 rounding of dK."""
    (q, k, v), do = _arrays(64, seed=31)
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v,
                                                                     do))
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = port_attn._FlashAttentionFn.apply(*ts, False, 0.125)
    out.backward(do)
    out32, lse = port_fa._fwd_plain(q, k, v, False, 0.125)
    assert out32.dtype == torch.float32
    assert torch.equal(out, out32.to(torch.bfloat16))
    want = port_fa.flash_attention_bwd_reference(q, k, v, out32, lse, do,
                                                 False, 0.125)
    rounded = port_fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                    False, 0.125)
    for t, w in zip(ts, want):
        assert torch.equal(t.grad, w)
    assert not torch.equal(ts[0].grad, rounded[0])
    # sum of dK over the keys, against its size: the f32 O's D leaves only
    # dK's own rounding; the bf16 O's D leaves O's rounding on every row
    def key_sum_share(dk):
        return (dk.float().sum(dim=1).norm() / dk.float().norm()).item()
    assert key_sum_share(ts[1].grad) < key_sum_share(rounded[1])
