"""Flash attention on CUDA: forward (kernel B1), backward (kernels B2 and
B3), and their plain versions.

Port of paddle_tpu/ops/pallas/flash_attention.py. Each kernel has two
variants, chosen by dtype (``variant``): bf16 runs on the tensor cores
(``csrc/flash_attn_fwd_tc.cu``, ``csrc/flash_attn_dkv_tc.cu``,
``csrc/flash_attn_dq_tc.cu``: mma.sync, ldmatrix, cp.async), f32 on
CUDA-core FMAs (``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``),
where TF32 would break the f32 correctness gates. The kernels' headers say
what bounds them on the H100 and how their designs answer that. This
module builds them at first use, checks what they are given, allocates
the outputs and launches them on the current stream. On a CPU tensor each
wrapper runs the plain PyTorch version instead; on a CUDA tensor it
launches or raises.

Layout: inputs (B, S, H, D), paddle's convention, as in the reference.
Tiles: each tensor-core kernel is instantiated at two block sizes (B1
and B3 at 64 or 128 query rows a block, B2 at 64 or 128 key rows), and
its C entry point takes the one to run. ``_tuned_fwd_blocks`` and
``_tuned_bwd_blocks`` choose them per shape, as the reference's
functions of the same names do: ``ops/autotune.py`` times every candidate
that ptxas compiled without spilling and that matches the plain version
(relative L2 2^-7) on the card, and caches the winner; off the card, and
for the f32 kernels, which keep one tile, the answer is 64 x 64.

The kernels read the batch, sequence and head strides they are given, so
the strided q/k/v views that GPTAttention slices out of its fused qkv
projection go in without a copy; D must have unit stride. The tensor-core
kernels copy rows 16 bytes at a time, so their bf16 operands also need a
16-byte-aligned base and strides that are multiples of 8 elements; an
operand that breaks this is copied first (``tc_operand``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import autotune
from . import count_lock, launch_counts
from ._build import CSRC, kernel_resources, library

__all__ = ["supports", "flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_for_grad",
           "flash_attention_fwd_reference", "flash_attention_bwd",
           "flash_attention_bwd_reference", "flash_attention_block_fwd",
           "flash_attention_block_bwd", "launch_dkv", "launch_dq",
           "bwd_delta", "variant", "variant_counter", "tc_operand",
           "tile_candidates", "KERNEL_NAME", "KERNEL_NAMES", "SOURCES"]

KERNEL_NAME = "flash_attn_fwd"
DKV_KERNEL = "flash_attn_bwd_dkv"
DQ_KERNEL = "flash_attn_bwd_dq"
KERNEL_NAMES = (KERNEL_NAME, DKV_KERNEL, DQ_KERNEL)
# the variants of each kernel: bf16 on the tensor cores, f32 on CUDA cores
TC, SIMT = "tc_bf16", "simt_f32"
# (source in csrc/, C entry point) of each kernel variant
_ENTRY = {(KERNEL_NAME, TC): ("flash_attn_fwd_tc", "pt_flash_attn_fwd_tc"),
          (KERNEL_NAME, SIMT): ("flash_attn_fwd", "pt_flash_attn_fwd"),
          (DKV_KERNEL, TC): ("flash_attn_dkv_tc", "pt_flash_attn_bwd_dkv_tc"),
          (DKV_KERNEL, SIMT): ("flash_attn_bwd", "pt_flash_attn_bwd_dkv"),
          (DQ_KERNEL, TC): ("flash_attn_dq_tc", "pt_flash_attn_bwd_dq_tc"),
          (DQ_KERNEL, SIMT): ("flash_attn_bwd", "pt_flash_attn_bwd_dq")}
# every CUDA file of the kernels: a searched decision about them is
# versioned by their text
SOURCES = tuple(str(CSRC / f"{src}.cu")
                for src in sorted({v[0] for v in _ENTRY.values()}))
# (pointers, ints before the scale, strides after it) of each kernel's
# entry points, by kernel or by (kernel, variant) where the variants differ
# (the tensor-core kernels also take their tile, and B1's its f32 O's
# pointer); the strides are (batch, seq, head) of q, k, v (and dout)
_ARITY = {KERNEL_NAME: (5, 5, 9), (KERNEL_NAME, TC): (6, 6, 9),
          DKV_KERNEL: (8, 5, 12), (DKV_KERNEL, TC): (8, 6, 12),
          DQ_KERNEL: (7, 5, 12), (DQ_KERNEL, TC): (7, 6, 12)}
# the block sizes each tensor-core kernel is instantiated at: query rows a
# block for B1 and B3, key rows a block for B2
TILES = (64, 128)
# the tile of each kernel's template in the ptxas report: (source, kernel
# function) of the tensor-core variants
_TC_FUNCTION = {KERNEL_NAME: ("flash_attn_fwd_tc", "flash_fwd_tc_kernel"),
                DKV_KERNEL: ("flash_attn_dkv_tc", "flash_bwd_dkv_tc_kernel"),
                DQ_KERNEL: ("flash_attn_dq_tc", "flash_bwd_dq_tc_kernel")}
# B2's query tile (its loop's step) at each head dim, fixed in the kernel
_DKV_QUERY_TILE = {64: 64, 128: 32}
# the relative L2 gap to the plain version a tile must keep to be timed
TILE_GATE = 2.0 ** -7
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


def _math_dtype(t):
    """The plain versions compute in f32, or in f64 for f64 inputs (which
    only the host takes, for gradcheck)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scores(q, k, causal):
    """q . K^T for (B, H, S, D) operands (q already scaled), masked with the
    reference's -1e30 where a query precedes its key when causal."""
    s = q @ k.transpose(-1, -2)
    if causal:
        s_q, s_k = s.shape[-2], s.shape[-1]
        q_pos = torch.arange(s_q, device=q.device)[:, None]
        k_pos = torch.arange(s_k, device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, NEG_BIG)
    return s


def flash_attention_fwd_reference(q, k, v, causal=False, scale=1.0):
    """Plain PyTorch version of B1 in f32 math: (out, lse), out (B, S, H, D)
    in q's dtype, lse (B, H, S) f32. The whole score matrix is formed at
    once; the online softmax of the kernel gives the same values."""
    out, lse = _fwd_plain(q, k, v, causal, scale)
    return out.to(q.dtype), lse


def _fwd_plain(q, k, v, causal, scale):
    """B1's plain version with out left in the math dtype (unrounded)."""
    dt = _math_dtype(q)
    qf = q.to(dt).transpose(1, 2) * scale              # (B, H, S, D)
    kf = k.to(dt).transpose(1, 2)
    vf = v.to(dt).transpose(1, 2)
    s = _scores(qf, kf, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_safe = p.sum(dim=-1).clamp_min(L_FLOOR)
    out = (p @ vf) / l_safe[..., None]
    lse = m + torch.log(l_safe)
    return out.transpose(1, 2).contiguous(), lse


def _delta(out, do):
    """D = rowsum(dO * O) in f32 from the stored O (the reference's line
    301), as (B, H, S). The reference stores O in the inputs' dtype; the
    port's autograd Function hands in the unrounded O
    (``flash_attention_fwd_for_grad``)."""
    dt = _math_dtype(out)
    return (do.to(dt) * out.to(dt)).sum(dim=-1).transpose(1, 2)


def flash_attention_bwd_reference(q, k, v, out, lse, do, causal=False,
                                  scale=1.0):
    """Plain PyTorch version of B2 and B3 in f32 math: (dq, dk, dv), each
    (B, S, H, D) contiguous in its input's dtype. The whole score matrix is
    formed at once and the reference's formulas applied with its
    constants: P = exp(S - LSE) with S = -1e30 where masked, dS =
    P * (dO V^T - D), dK against q * scale, dQ scaled once at the end."""
    grads = _bwd_plain(q, k, v, do, lse, _delta(out, do), causal, scale)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def _bwd_plain(q, k, v, do, lse, delta, causal, scale):
    """B2 and B3's plain version on a given LSE and D, (dq, dk, dv) left
    in the math dtype, each (B, S, H, D) contiguous."""
    dt = _math_dtype(q)
    qf = q.to(dt).transpose(1, 2) * scale
    kf = k.to(dt).transpose(1, 2)
    vf = v.to(dt).transpose(1, 2)
    dof = do.to(dt).transpose(1, 2)
    p = torch.exp(_scores(qf, kf, causal) - lse.to(dt)[..., None])
    dv = p.transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - delta.to(dt)[..., None])
    dk = ds.transpose(-1, -2) @ qf
    dq = (ds @ kf) * scale
    return tuple(g.transpose(1, 2).contiguous() for g in (dq, dk, dv))


def _check(q, k, v):
    if not (q.dim() == k.dim() == v.dim() == 4):
        raise ValueError("flash attention takes (B, S, H, D) inputs")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not form one attention")
    host_f64 = q.device.type == "cpu" and q.dtype == torch.float64
    if not (q.dtype == k.dtype == v.dtype) \
            or (q.dtype not in DTYPES and not host_f64):
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


def _check_bwd(q, out, lse, do):
    b, s, h, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if tuple(lse.shape) != (b, h, s) or lse.dtype != _math_dtype(q):
        raise ValueError(f"lse must be ({b}, {h}, {s}) {_math_dtype(q)}, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
    if out.dtype not in (q.dtype, _math_dtype(q)) or do.dtype != q.dtype:
        raise ValueError(f"out must be {q.dtype} or {_math_dtype(q)} and "
                         f"dout {q.dtype}, got {out.dtype}/{do.dtype}")
    if not (out.device == lse.device == do.device == q.device):
        raise ValueError("q, out, lse and dout lie on different devices")
    if do.stride(-1) != 1:
        raise ValueError("dout's head dim must have unit stride")


def variant(dtype):
    """The variant of each kernel that a CUDA tensor of ``dtype`` launches:
    the tensor-core kernel for bf16, the CUDA-core one for f32."""
    return TC if dtype == torch.bfloat16 else SIMT


def variant_counter(kernel, dtype):
    """The ``launch_counts`` key of ``kernel``'s variant for ``dtype``."""
    return f"{kernel}.{variant(dtype)}"


def _tc_ready(t):
    """Whether the tensor-core kernels can read ``t`` as it lies: cp.async
    copies 16 bytes, so the base must be 16-byte aligned and every stride
    but the last a whole number of 16-byte chunks."""
    per_chunk = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(st % per_chunk == 0 for st in t.stride()[:-1]))


def tc_operand(t):
    """``t`` itself where the tensor-core kernels can read it, else a fresh
    contiguous copy (``contiguous()`` would keep a contiguous but
    misaligned view as it is)."""
    return t if _tc_ready(t) else t.clone(memory_format=torch.contiguous_format)


def _count(kernel, kind):
    with count_lock:
        launch_counts[kernel] += 1
        launch_counts[f"{kernel}.{kind}"] += 1


@functools.lru_cache(maxsize=None)
def _entry_point(kernel, kind):
    """(launcher, error-string) of one kernel variant, typed: every pointer
    and the stream as c_void_p, never a truncated int."""
    source, symbol = _ENTRY[kernel, kind]
    lib = library(source)
    n_ptrs, n_ints, n_strides = _ARITY.get((kernel, kind), _ARITY[kernel])
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] + [ctypes.c_longlong] * n_strides
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err_str = lib.pt_cuda_error_string
    err_str.argtypes = [ctypes.c_int]
    err_str.restype = ctypes.c_char_p
    return fn, err_str


def _raise_on(err, name, err_str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{err_str(err).decode()} ({err})")


def _launch(q, k, v, causal, scale, keep_f32=False, tile=None):
    """B1 on checked CUDA inputs: (out, lse, out32), out32 the f32 O when
    ``keep_f32`` (the tensor-core variant writes it beside the bf16 O, the
    SIMT variant's O is f32 already), else None. ``tile``: the tensor-core
    variant's query rows a block (default: the tuned one)."""
    b, s, h, d = q.shape
    kind = variant(q.dtype)
    if kind == TC:
        q, k, v = (tc_operand(t) for t in (q, k, v))
        if tile is None:
            tile = _tuned_fwd_blocks(b * h, s, s, d, q.dtype, causal,
                                     q.device)[0]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    out32 = None
    if keep_f32:
        out32 = out if kind == SIMT else torch.empty(
            (b, s, h, d), dtype=torch.float32, device=q.device)
    # the tensor-core entry point takes the f32 O's pointer, null for none,
    # and its tile
    extra = [] if kind == SIMT else [
        None if out32 is None else out32.data_ptr()]
    tile_arg = [] if kind == SIMT else [int(tile)]
    fn, err_str = _entry_point(KERNEL_NAME, kind)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *extra, lse.data_ptr(), b, s, h, d, int(bool(causal)),
                 *tile_arg, float(scale), *strides, stream)
    _raise_on(err, KERNEL_NAME, err_str)
    _count(KERNEL_NAME, kind)
    return out, lse, out32


def _bwd_launch(kernel, q, k, v, do, lse, delta, n_out, causal, scale,
                tile=None):
    """Launch a backward kernel's variant for q's dtype on checked CUDA
    inputs; returns its ``n_out`` outputs, each (B, S, H, D) in q's
    dtype. ``tile``: the tensor-core variant's block rows (default: the
    tuned one)."""
    if not all(t.is_cuda for t in (q, k, v, do, lse, delta)):
        raise ValueError("the backward kernels take CUDA tensors")
    kind = variant(q.dtype)
    if kind == TC:
        q, k, v, do, lse, delta = (tc_operand(t)
                                   for t in (q, k, v, do, lse, delta))
    outs = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
            for _ in range(n_out)]
    b, s, h, d = q.shape
    tile_arg = []
    if kind == TC:
        if tile is None:
            blocks = _tuned_bwd_blocks(b * h, s, s, d, q.dtype, causal,
                                       q.device)
            tile = blocks[1] if kernel == DKV_KERNEL else blocks[2]
        tile_arg = [int(tile)]
    fn, err_str = _entry_point(kernel, kind)
    strides = [st for t in (q, k, v, do) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 *(t.data_ptr() for t in outs), b, s, h, d,
                 int(bool(causal)), *tile_arg, float(scale), *strides,
                 stream)
    _raise_on(err, kernel, err_str)
    _count(kernel, kind)
    return outs


def launch_dkv(q, k, v, do, lse, delta, causal, scale, tile=None):
    """B2 on checked CUDA inputs: (dk, dv). lse and delta are contiguous
    (B, H, S) f32 (``bwd_delta`` makes delta)."""
    dk, dv = _bwd_launch(DKV_KERNEL, q, k, v, do, lse, delta, 2, causal,
                         scale, tile)
    return dk, dv


def launch_dq(q, k, v, do, lse, delta, causal, scale, tile=None):
    """B3 on checked CUDA inputs: dq. lse and delta as for launch_dkv."""
    dq, = _bwd_launch(DQ_KERNEL, q, k, v, do, lse, delta, 1, causal, scale,
                      tile)
    return dq


def bwd_delta(out, do):
    """The kernels' D operand: contiguous (B, H, S) f32."""
    return _delta(out, do).contiguous()


def flash_attention_fwd(q, k, v, causal=False, scale=1.0):
    """(out, lse): out (B, S, H, D) in q's dtype, lse (B, H, S) f32.

    On a CUDA tensor this launches B1 (or raises); on a CPU tensor it runs
    the plain version."""
    _check(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale)[:2]
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    raise ValueError(f"no flash-attention path for device {q.device}")


def flash_attention_fwd_for_grad(q, k, v, causal=False, scale=1.0):
    """(out, lse, out_unrounded): flash_attention_fwd's outputs and O in
    the math dtype (f32), for the backward's D = rowsum(dO * O). For bf16
    inputs B1 writes it beside the bf16 O in the same launch; for f32
    inputs it is out itself. On a CPU tensor the plain version."""
    _check(q, k, v)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale, keep_f32=True)
    if q.device.type == "cpu":
        out, lse = _fwd_plain(q, k, v, causal, scale)
        return out.to(q.dtype), lse, out
    raise ValueError(f"no flash-attention path for device {q.device}")


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=1.0):
    """(dq, dk, dv), each contiguous (B, S, H, D) in the input dtype, from
    the forward's inputs, its out and lse, and the output cotangent do.

    On a CUDA tensor this launches B2 (dk, dv) and then B3 (dq), or
    raises; on a CPU tensor it runs the plain version."""
    _check(q, k, v)
    _check_bwd(q, out, lse, do)
    if q.device.type == "cuda":
        lse, delta = lse.contiguous(), bwd_delta(out, do)
        dk, dv = launch_dkv(q, k, v, do, lse, delta, causal, scale)
        return launch_dq(q, k, v, do, lse, delta, causal, scale), dk, dv
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                             scale)
    raise ValueError(f"no flash-attention path for device {q.device}")


def flash_attention_block_fwd(q, k, v, causal=False, scale=1.0):
    """One (query block, key block) pair of a blockwise attention (ring
    attention, fleet/sequence_parallel.py): (out, lse), out (B, S, H, D)
    unrounded in the math dtype (f32) and lse (B, H, S) f32, for the
    caller to merge with other blocks by their LSEs. On a CUDA tensor
    this launches B1 (which writes the f32 O beside its bf16 one), or
    raises; on a CPU tensor it runs the plain version."""
    _check(q, k, v)
    if q.device.type == "cuda":
        _, lse, out32 = _launch(q, k, v, causal, scale, keep_f32=True)
        return out32, lse
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, causal, scale)
    raise ValueError(f"no flash-attention path for device {q.device}")


def flash_attention_block_bwd(q, k, v, do, lse, delta, causal=False,
                              scale=1.0):
    """One block pair's (dq, dk, dv), each (B, S, H, D), under a given
    LSE and D (B, H, S) f32: the merged row statistics of the whole
    attention the block is part of, so that the blocks' gradients add
    up to the whole's. On a CUDA tensor this launches B2 (dk, dv) and B3
    (dq), each in q's dtype, or raises; on a CPU tensor it runs the plain
    version (in the math dtype)."""
    _check(q, k, v)
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, s) or t.dtype != _math_dtype(q):
            raise ValueError(f"{name} must be ({b}, {h}, {s}) "
                             f"{_math_dtype(q)}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1:
        raise ValueError(f"dout must be {tuple(q.shape)} {q.dtype} with a "
                         f"unit-stride head dim")
    if q.device.type == "cuda":
        lse, delta = lse.contiguous(), delta.contiguous()
        dk, dv = launch_dkv(q, k, v, do, lse, delta, causal, scale)
        return launch_dq(q, k, v, do, lse, delta, causal, scale), dk, dv
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, causal, scale)
    raise ValueError(f"no flash-attention path for device {q.device}")


def flash_attention(q, k, v, causal=False, scale=1.0):
    """(B, S, H, D) -> (B, S, H, D): the output of flash_attention_fwd."""
    out, _ = flash_attention_fwd(q, k, v, causal, scale)
    return out


# -- tile choice (the reference's _tuned_fwd_blocks / _tuned_bwd_blocks) ----

DEFAULT_BLOCK_Q = 64
DEFAULT_BLOCK_K = 64


@functools.lru_cache(maxsize=None)
def tile_candidates(kernel, d):
    """(kept, dropped) tiles of ``kernel``'s tensor-core variant at head
    dim ``d``: kept, the tiles ptxas compiled without spilling; dropped,
    {tile: why} for the others (builds the library first if needed)."""
    source, function = _TC_FUNCTION[kernel]
    report = kernel_resources(source)
    kept, dropped = [], {}
    for tile in TILES:
        r = report.get((function, (d, tile)))
        if r is None:
            dropped[tile] = "not in ptxas's report"
        elif r.get("spill_stores", 0) or r.get("spill_loads", 0):
            dropped[tile] = (f"spills {r['spill_stores']} bytes stored, "
                             f"{r['spill_loads']} loaded at "
                             f"{r.get('registers')} registers")
        else:
            kept.append(tile)
    return tuple(kept), dropped


def _signature(pass_, bh, s_q, s_k, d, dtype, causal):
    return "%s|bh%d|s%dx%d|d%d|%s|c%d" % (
        pass_, autotune.shape_bucket((bh,))[0], s_q, s_k, d,
        autotune.short_dtype(dtype), int(causal))


def _probe_qkv(bh, s, d, dtype, device, n):
    """``n`` probe operands (1, s, bh, d) of a seeded normal: the grid and
    the work of a (b, s, h, d) call with b * h = bh."""
    gen = torch.Generator(device=device).manual_seed(0)
    return [torch.randn((1, s, bh, d), generator=gen, device=device,
                        dtype=torch.float32).to(dtype) for _ in range(n)]


def _gate(name, got, want):
    """Raise where a tile's output is further than TILE_GATE (relative L2)
    from the plain version's: such a tile is no candidate."""
    gap = float((got.float() - want.float()).norm()
                / want.float().norm().clamp_min(1e-30))
    if not gap <= TILE_GATE:
        raise ValueError(f"{name}: relative L2 {gap:.3g} to the plain "
                         f"version above {TILE_GATE:.3g}")


def _tuned_fwd_blocks(bh, s_q, s_k, d, dtype, causal, device):
    """(block_q, block_k) of B1: on the card for bf16, the tuned (and
    cached) tile; otherwise, and for f32's one tile, 64 x 64."""
    fallback = (DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)
    if device.type != "cuda" or dtype != torch.bfloat16:
        return fallback
    cands = [(t, DEFAULT_BLOCK_K) for t in tile_candidates(KERNEL_NAME, d)[0]]
    if len(cands) <= 1:
        return cands[0] if cands else fallback
    scale = 1.0 / d ** 0.5

    def make_args():
        return _probe_qkv(bh, s_q, d, dtype, device, 3)

    def build(cand):
        def run(q, k, v):
            return _launch(q, k, v, causal, scale, tile=cand[0])
        q, k, v = make_args()
        _gate(f"{KERNEL_NAME} tile {cand}", run(q, k, v)[0],
              _fwd_plain(q, k, v, causal, scale)[0])
        return run

    return autotune.get_tuner().get(
        "flash_attention", _signature("fwd", bh, s_q, s_k, d, dtype, causal),
        candidates=cands, build=build, make_args=make_args,
        fallback=fallback, device=device,
        version=autotune.source_version(
            __name__, str(CSRC / "flash_attn_fwd_tc.cu")))


def _tuned_bwd_blocks(bh, s_q, s_k, d, dtype, causal, device):
    """(block_q_dkv, block_k_dkv, block_q_dq, block_k_dq) of B2 and B3, as
    the reference's: on the card for bf16 the tuned (and cached) pair of
    tiles, B2's key rows and B3's query rows, timed together; otherwise,
    and for f32's one tile, 64 x 64 (B2's query step is fixed by d)."""
    q_dkv = _DKV_QUERY_TILE.get(d, DEFAULT_BLOCK_Q)
    fallback = (q_dkv, DEFAULT_BLOCK_K, DEFAULT_BLOCK_Q, DEFAULT_BLOCK_K)
    if device.type != "cuda" or dtype != torch.bfloat16:
        return fallback
    cands = [(q_dkv, bk, bq, DEFAULT_BLOCK_K)
             for bk in tile_candidates(DKV_KERNEL, d)[0]
             for bq in tile_candidates(DQ_KERNEL, d)[0]]
    if len(cands) <= 1:
        return cands[0] if cands else fallback
    scale = 1.0 / d ** 0.5

    def make_args():
        q, k, v, do = _probe_qkv(bh, s_q, d, dtype, device, 4)
        out, lse = _fwd_plain(q, k, v, causal, scale)
        return [q, k, v, do, lse.contiguous(), bwd_delta(out, do)]

    def build(cand):
        def run(q, k, v, do, lse, delta):
            dk, dv = launch_dkv(q, k, v, do, lse, delta, causal, scale,
                                tile=cand[1])
            return launch_dq(q, k, v, do, lse, delta, causal, scale,
                             tile=cand[2]), dk, dv
        args = make_args()
        q, k, v, do, lse, _ = args
        out, _ = _fwd_plain(q, k, v, causal, scale)
        want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                             scale)
        for name, g, w in zip(("dq", "dk", "dv"), run(*args), want):
            _gate(f"backward tiles {cand} {name}", g, w)
        return run

    return autotune.get_tuner().get(
        "flash_attention", _signature("bwd", bh, s_q, s_k, d, dtype, causal),
        candidates=cands, build=build, make_args=make_args,
        fallback=fallback, device=device,
        version=autotune.source_version(
            __name__, str(CSRC / "flash_attn_dkv_tc.cu"),
            str(CSRC / "flash_attn_dq_tc.cu")))
