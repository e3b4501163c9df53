"""Flash attention forward (kernel B1) on CUDA, and its plain version.

Port of paddle_tpu/ops/pallas/flash_attention.py, forward only. The kernel
is ``csrc/flash_attn_fwd.cu`` (its header says what bounds it on the H100
and how its design answers that); this module builds it at first use,
checks what it is given, allocates the outputs and launches it on the
current stream.

Layout: inputs (B, S, H, D), paddle's convention, as in the reference.
The kernel reads the batch, sequence and head strides it is given, so the
strided q/k/v views that GPTAttention slices out of its fused qkv
projection go in without a copy; D must have unit stride.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import launch_counts
from ._build import library

__all__ = ["supports", "flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_reference", "KERNEL_NAME"]

KERNEL_NAME = "flash_attn_fwd"
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
# the constants of the reference kernel (_attn_fwd_kernel)
NEG_BIG = -1e30
L_FLOOR = 1e-30


def supports(q_shape, k_shape):
    """The reference's shape contract: s_q == s_k, both multiples of 128,
    head dim a multiple of 64."""
    b, s_q, h, d = q_shape
    s_k = k_shape[1]
    return (s_q % 128 == 0 and s_k % 128 == 0
            and d % 64 == 0 and s_q == s_k)


def flash_attention_fwd_reference(q, k, v, causal=False, scale=1.0):
    """Plain PyTorch version of B1 in f32 math: (out, lse), out (B, S, H, D)
    in q's dtype, lse (B, H, S) f32. The whole score matrix is formed at
    once; the online softmax of the kernel gives the same values."""
    s_q, s_k = q.shape[1], k.shape[1]
    qf = q.float().transpose(1, 2) * scale              # (B, H, S, D)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    s = qf @ kf.transpose(-1, -2)
    if causal:
        q_pos = torch.arange(s_q, device=q.device)[:, None]
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, NEG_BIG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_safe = p.sum(dim=-1).clamp_min(L_FLOOR)
    out = (p @ vf) / l_safe[..., None]
    lse = m + torch.log(l_safe)
    return out.transpose(1, 2).to(q.dtype).contiguous(), lse


def _check(q, k, v):
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("flash attention takes (B, S, H, D) inputs")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not form one attention")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"flash attention takes float32 or bfloat16 inputs "
                         f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    if not supports(tuple(q.shape), tuple(k.shape)):
        raise ValueError(f"shape {tuple(q.shape)} x {tuple(k.shape)} outside "
                         f"the kernel's contract (s_q == s_k, s % 128 == 0, "
                         f"d % 64 == 0)")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not built: the kernel is "
                         f"instantiated for d in {HEAD_DIMS}")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError("batch * heads above 65535 (the grid's y limit)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim must have unit stride")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the CUDA flash-attention path is forward-only: its backward "
            "kernels (B2 dK/dV, B3 dQ) come with the training slice; call "
            "under torch.inference_mode()/no_grad or pass use_kernel=False")


@functools.lru_cache(maxsize=None)
def _entry_points():
    """(launcher, error-string) functions of the built library, typed:
    every pointer and the stream as c_void_p, never a truncated int."""
    lib = library(KERNEL_NAME)
    fn = lib.pt_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_longlong] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err_str = lib.pt_cuda_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


def _launch(q, k, v, causal, scale):
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    fn, err_str = _entry_points()
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, s, h, d, int(q.dtype == torch.bfloat16),
                 int(bool(causal)), float(scale), *strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: "
                           f"{err_str(err).decode()} ({err})")
    launch_counts[KERNEL_NAME] += 1
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, scale=1.0):
    """(out, lse): out (B, S, H, D) in q's dtype, lse (B, H, S) f32.

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it runs the plain version. Forward only in this slice."""
    _check(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    raise ValueError(f"no flash-attention path for device {q.device}")


def flash_attention(q, k, v, causal=False, scale=1.0):
    """(B, S, H, D) -> (B, S, H, D): the output of flash_attention_fwd."""
    out, _ = flash_attention_fwd(q, k, v, causal, scale)
    return out
