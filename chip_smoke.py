#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing JSON lines:

1. build: compile every CUDA source of the port with nvcc (one process per
   source, all at once) and report the time, the libraries and ptxas's
   register, shared-memory and spill lines.
2. kernels: hold each kernel against its plain PyTorch version on the card
   and time kernel, plain version and a library yardstick: flash attention
   B1 (causal and not, head dim 64 and 128, bf16 and f32), then its
   backward B2 (dK, dV) and B3 (dQ) at the training shape (4 x 1024, 16
   heads of 64, bf16, causal) and five more; last B1, B2 and B3 at BERT's
   shape (8 x 512, 12 heads of 64, bf16, non-causal, q, k and v three
   contiguous tensors). bf16 runs the tensor-core
   variants, f32 the CUDA-core (SIMT) ones; each row names the variant
   that ran. At the bf16 causal shapes and at BERT's the wrapper's whole
   backward (bwd_delta, B2 and B3) is also timed against the library's,
   with bwd_delta's own share. "ms" is device time (the kernels' summed
   duration under torch.profiler, per call; a profile that lost kernels
   is taken again, and after three such tries the time comes from CUDA
   events around calls queued behind a spin kernel, with a
   timing_fallback line); "wall_ms" is CUDA-event time over back-to-back
   calls, which includes the host's launch cost where the host is slower
   than the kernel.
3. reference: a small GPT on the card is held against the same model on
   the host (whose math path the host tests hold against paddle_tpu):
   greedy decode, and 3 AdamW training steps in f32.
4. serve: GPT-medium at full width (vocab 32000, hidden 1024, 24 layers,
   16 heads, random weights from --seed) serves 4 x 512-token prompts and
   64 greedy KV-cached decode steps in bf16 through the port's entry point,
   with the launch counts reset just before and read just after. The
   kernel path is then compared with the math path (use_flash_attention
   off) in bf16 and, at full width, in f32, where the greedy tokens must
   be identical. The bf16 model is then profiled (torch.profiler) over one
   prefill and 16 decode steps: device time by kernel and busy share.
5. train: GPT-medium at full width in bf16 with AdamW(multi_precision)
   trains on bench.py's permutation stream, batch 4 x 1024, through
   ``jit.to_static`` on the eager path (FLAGS_compiled_step=0): 4 warm-up
   steps, then 16 timed steps with the launch counts reset just before
   and read just after (24 launches each of B1, B2 and B3 per step, all
   on the tensor cores). Then one bf16 step is profiled, bwd_delta's
   kernels summed apart; one f32 step at full width holds the kernel
   path's loss and grads against the math path's (the SIMT variants), and
   the same weights cast to bf16 hold the tensor-core path's grads against
   the f32 math path's, no further from it than twice the bf16 math path.
6. compiled_train: the same cell with the step captured as one CUDA graph
   (``CompiledTrainStep`` over ``to_static``), the same weights and
   batches: 1 compile in the 4 warm-up steps, 0 compiles and 16 cache
   hits in the 16 timed steps, the loss curve within 2e-2 of the eager
   run's step by step, step time, tokens/s and peak memory beside the
   eager run's, and one replayed step profiled (one graph launch; B1, B2
   and B3 24 times each, counted by kernel name, since a replay does not
   pass through the wrappers' Python counts).
7. amp_train: GPT-medium with f32 parameters under auto_cast(bf16),
   recompute, AdamW + ClipGradByGlobalNorm(1.0) + LinearWarmup, captured
   and driven through run_steps (K = 4, three executions, the scheduler
   stepping between them): the lr read back at each step equals the
   scheduler's, the last execution's mean loss is below the first's; the
   second execution is profiled (B1 48 times a step, B2 and B3 24).
8. to_static_grad: the captured step's repaired faults on BERT-base in
   f32 at 4 x 256 (B1, B2 and B3 in its graphs): a forward-only ``to_static(model)`` under an outer
   backward gives eager's grads on its calls 1-3 (its forward and backward
   captured as two graphs), differentiating a self-backward step's output
   raises the reference's error, and an optimizer built on host
   parameters, the model then moved to the card, reads its scheduler's lr
   at every replay.
9. bert_train, ernie_train: bench.py's BERT lane (bench_bert): BERT-base
   (then ERNIE-base) with dropout 0 in bf16, AdamW(1e-4,
   multi_precision), the parity-label stream at 16 x 128, the step
   captured and driven through run_steps with 64 steps an execution, 512
   (256) recorded steps, once for each of three weight draws (seeds
   --seed, +1, +2) on the one data stream; the median of their last-32
   means below bench's chance floor 0.62; each run 1 compile in the
   warm-up, 0 timed, and a replay profiled.
10. bert_flash: BERT-base at 8 x 512 with no mask, where attention takes
   B1, B2 and B3 non-causal: one f32 step (kernel path against math
   path), the same weights in bf16 against the f32 truth, eval logits and
   latencies of both paths, and a captured bf16 step on each path (B1, B2
   and B3 12 times each per replay, by kernel name).
11. vision_reference: a ResNet-18 (10 classes, NHWC, the space-to-depth
   stem, fused conv + BN) at 2 x 3 x 64 x 64 and a LeNet on the card are
   held against the same models on the host in f32 (TF32 off): one
   Momentum step's loss, grads and moved running statistics, then the
   eval logits.
12. resnet_train: bench.py's ResNet-50 lane (bench_resnet50) at full width
   and depth: bf16, batch 128 at 224 x 224, NHWC, the space-to-depth stem,
   fused conv + BN, Momentum(0.1, 0.9), the step captured and driven by
   run_steps K = 32, 2 warm-up + 12 timed executions over 3 staged stacks
   of bench's prototype stream (made on the card): 448 recorded steps, the
   last-32 mean below bench's chance floor 6.71, 1 compile in the warm-up
   and none timed, running statistics that move; step ms, images/s, MFU,
   peak memory and a replay's profile by kernel class.
13. resnet_fused: ResNet-50 fused against unfused conv + BN: one f32 step
   at 32 x 224 x 224 (loss and every grad), and a bf16 eager step at batch
   128 (peak memory over what the step starts with, step ms).
14. resnet_eval: the trained ResNet-50 in eval mode, bf16, on the fused
   op's folded-statistics path against BatchNorm in eval, both held to the
   f32 unfused logits, at batch 128 and 1; latency and device time.
15. lenet_train: bench.py's LeNet lane (bench_lenet): f32, Adam(1e-3),
   batch 256, run_steps K = 32, 2 warm-up + 1 timed executions, the
   last-32 mean below bench's floor 1.80; images/s.
None of the conv net paths runs B1, B2 or B3: each counts 0 launches of
them, and the kernels line says so.

``--phases`` runs only the named phases (comma-separated: build,
kernels, reference, serve, train, to_static_grad, bert, vision); the
kernels line needs every phase and is printed only when all run.

Then it prints the kernels line ({"kernels": [...]}, with each kernel's
launches on the main path, error, times and bound), the card's name and
power limit from nvidia-smi, and last {"ok": true, "device": {...}}.
Any failed check raises, so the exit code is not 0 and no ok line is
printed. It needs a CUDA card and the repository checkout it lies in.
"""
import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# H100 SXM dense peaks (NVIDIA data sheet) for the roofline bound and MFU
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

PROMPTS, PROMPT_LEN, DECODE_STEPS = 4, 512, 64
# bench.py's GPT training lane: batch 4 x 1024, AdamW lr 1e-4, a 512-token
# permutation stream, 4 warm-up steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WARMUP, TRAIN_STEPS = 4, 1024, 4, 16
# bench.py's BERT lane (bench_bert): batch 16 x 128, run_steps with 64
# steps per execution, 2 warm-up executions; its chance-floor gate: the
# mean loss of the last 32 recorded steps below 0.62 (ln 2 = 0.693 is
# chance), judged on at least 512 recorded steps for BERT and 256 for
# ERNIE (bench.py:1241-1242)
CLS_BATCH, CLS_SEQ, CLS_SPE, CLS_FLOOR, CLS_WINDOW = 16, 128, 64, 0.62, 32
CLS_STEPS = {"bert": 512, "ernie": 256}
# the floor is judged on the median of the last-32 means of this many
# weight draws (seeds --seed, --seed + 1, ...) on the one data stream: one
# fine-tuning run from one draw can stay at chance, as ERNIE-base from
# seed 0 does (PERF.md section 6)
CLS_WEIGHT_DRAWS = 3
# BERT-base on the flash kernels: (batch, seq, heads, head dim) at s = 512,
# where the selection rule takes B1, B2 and B3 (non-causal)
BERT_FLASH_SHAPE = (8, 512, 12, 64)
BERT_FLASH_REPLAYS = 16
# eval-mode f32 logits, kernel path against math path (summation order)
BERT_LOGIT_TOL = 1e-3
# forward-only to_static under an outer backward against eager, f32
OUTER_GRAD_RTOL = 1e-5
# the key projections' bias grads are zero in exact arithmetic; each
# path's must stay below this share of its weight grad's norm, by dtype
# (bf16 rounds dK before the bias sums it over every key). Sound readings
# at BERT-base 8 x 512: f32 1.3e-7 (math) and 5.1e-7 (kernel); bf16
# 9.5e-5 (math) and 1.7e-4 (kernel). A bf16 backward that took D from the
# bf16 O read 1.6e-3 (PERF.md section 6).
KEY_BIAS = "self_attn.k_proj.bias"
KEY_BIAS_TOL = {"float32": 1e-5, "bfloat16": 5e-4}
# bench.py's ResNet-50 lane (bench_resnet50, bench.py:828-912): batch 128
# at 224 x 224, NHWC, the space-to-depth stem, run_steps with 32 steps an
# execution, 2 warm-up + 12 timed executions (384 timed steps, 448
# recorded) rotating over 3 staged stacks (96 distinct batches) of 1000
# class prototypes at scale 2.0 plus unit noise; its chance floor: the
# last-32 mean below 6.71 at 448 recorded steps (ln 1000 = 6.908;
# bench.py:1244-1248). A training step is 3 x 4.09 GFLOP an image at 224
# (bench.py:903-904).
RESNET_BATCH, RESNET_HW, RESNET_SPE, RESNET_STACKS = 128, 224, 32, 3
RESNET_WARMUP_EXEC, RESNET_TIMED_EXEC, RESNET_RECORDED = 2, 12, 448
RESNET_FLOOR, RESNET_WINDOW, RESNET_PROTO_SCALE = 6.71, 32, 2.0
RESNET_TRAIN_FLOP = 3 * 4.09e9
# bench.py's LeNet lane (bench_lenet, bench.py:1004-1042): batch 256, 32
# steps an execution, each on a distinct stack; floor 1.80 on the last 32
# of 96 recorded steps (ln 10 = 2.303; bench.py:1243)
LENET_BATCH, LENET_SPE, LENET_FLOOR, LENET_WINDOW = 256, 32, 1.80, 32
# vision_reference, card (cuDNN, f32, TF32 off) against host (f32): the
# loss's relative gap, each grad's relative L2 gap, each running
# statistic's and the eval logits' max gap over the max magnitude. Sound
# readings (ResNet-18 at 2 x 64 x 64, PERF.md section 6): loss 3.3e-6,
# grads 1.7e-5, statistics 5.3e-6, logits 2.3e-5; LeNet below 1.3e-6
VISION_TOL = {"loss": 2e-5, "grad": 1e-4, "stats": 2e-5, "logits": 1e-4}
# resnet_fused (a): ResNet-50 f32 at 32 x 224, fused against unfused conv
# + BN: the same forward association, so the loss differs only where
# cuDNN's algorithm does; grads by the backward's order of sums. Sound
# reading: loss equal to the bit, worst grad 4.8e-5 (bn1.bias), median
# 2.0e-6 (PERF.md section 6)
FUSED_F32_BATCH, FUSED_LOSS_RTOL, FUSED_GRAD_RTOL = 32, 1e-5, 2e-4
# resnet_eval: each bf16 path's logits against the f32 unfused ones; the
# fused path (an f32 scale/shift epilogue) within EVAL_FACTOR x the
# unfused path's (bf16 BatchNorm) gap + EVAL_SLACK
EVAL_FACTOR, EVAL_SLACK, EVAL_CALLS = 2.0, 2 ** -8, 20
# max |O - plain O| and |LSE - plain LSE| allowed, kernel vs plain on the
# card. bf16 (tensor cores, also held to the relative-L2 rule below): P is
# rounded to bf16 before P.V and O to bf16, a few bf16 ulps at |O| < 2;
# LSE is f32 in both; f32: sums in another order over at most 1024 terms.
KERNEL_TOL = {"bfloat16": (2e-2, 1e-3), "float32": (2e-5, 1e-4)}
# max |logits| gap between the kernel path and the math path at full width:
# bf16 runs round the attention output differently (the math path rounds
# probabilities and scores to bf16) and 24 layers carry the difference
# into logits of magnitude ~3, where a bf16 ulp is 2^-6; f32 differs only
# by summation order.
LOGIT_TOL = {"bfloat16": 0.25, "float32": 1e-3}
# the f32 backward (the SIMT B2 and B3) against the plain backward,
# elementwise |kernel - plain| <= atol + rtol * |plain|; atol covers values
# near zero
BWD_RTOL, BWD_ATOL = 1e-4, 1e-4
BWD_TOL_REASON = ("f32 sums in another order over up to 1024 terms, with "
                  "cancellation in dS")
# the tensor-core outputs (bf16 O of B1, dK and dV of B2, dQ of B3) against
# the f32 plain version: relative L2 gap <= TC_REL_L2, and <= TC_SDPA_FACTOR
# x the library's own relative L2 gap to the same plain version +
# TC_SDPA_SLACK.
# An elementwise bound is not sound once P and dS round before the product:
# sums with cancellation land near zero.
TC_REL_L2, TC_SDPA_FACTOR, TC_SDPA_SLACK = 2 ** -7, 2.0, 2 ** -10
TC_TOL_REASON = ("P and dS are rounded to bf16 as mma operands (unit "
                 "roundoff 2^-9 per term) and the output to bf16 (2^-9 "
                 "relative); the library rounds at the same places, so the "
                 "kernel is held to no worse than twice its gap")
# bf16 training step at full width: each grad's (and the loss's) relative
# gap to the f32 math path, kernel path <= factor x bf16 math path + slack
BF16_GRAD_FACTOR, BF16_GRAD_SLACK = 2.0, 1e-3
# the f32 training step at full width, kernel path against math path:
# loss relative gap, and each parameter's grad relative L2 gap (summation
# order only, carried through 24 layers)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
# a small GPT's 3 f32 AdamW steps, card (kernels) against host (math path)
SMALL_LOSS_TOL, SMALL_GRAD_RTOL = 1e-4, 1e-4


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_time_ms(torch, fn, reps=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(prof):
    """(us, count, name) of each device kernel in a profile, longest
    first (ranges marked by record_function are not kernels)."""
    kernels = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((us, e.count, e.key))
    return sorted(kernels, reverse=True)


# how each device time was taken: a profile that recorded every call's
# kernels, a profile retried after it recorded none or only some of them,
# or queued CUDA events after every try failed (queued_event_ms)
TIMING = {"profiler": 0, "profiler_retries": 0, "queued_events": []}
# a spin of 2^27 clock cycles holds the stream ~70 ms at the H100's
# 1.98 GHz boost clock while the host queues the timed calls
SPIN_CYCLES = 1 << 27


def queued_event_ms(torch, fn, reps=20, warmup=3):
    """Device time (ms) of one call of ``fn`` from CUDA events, for when
    the profiler records no kernels: a spin kernel (torch.cuda._sleep)
    holds the stream while the host queues all ``reps`` calls, so the
    events bracket back-to-back device work and not the host's launch
    cost. If the spin ended before the host had queued them all, the spin
    is doubled and the calls timed again (up to 4 times). Returns the
    time and whether the queue held."""
    for _ in range(warmup):
        fn()
    spin = SPIN_CYCLES
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            break
        spin *= 2
    return start.elapsed_time(end) / reps, held


def device_profile(torch, fn, reps=20, warmup=3, tries=3):
    """Device time (ms) and kernel launches of one call of ``fn``: the
    summed duration and number of the kernels it launches
    (torch.profiler), averaged over ``reps`` calls. The time leaves out
    the host's launch cost, which CUDA events over back-to-back calls
    (cuda_time_ms) include when the host is the slower side.

    ``fn`` launches the same kernels on every call, so a profile whose
    launch count is zero or not a multiple of ``reps`` lost kernels: it is
    taken again, up to ``tries`` times, and then the time comes from
    queued CUDA events (queued_event_ms) with the launches unknown (None).
    Every time returned is above zero."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = kernel_times(prof)
        launches = sum(k[1] for k in kernels)
        if launches and launches % reps == 0:
            TIMING["profiler"] += 1
            TIMING["profiler_retries"] += attempt
            return sum(k[0] for k in kernels) / 1e3 / reps, launches / reps
    ms, held = queued_event_ms(torch, fn, reps, warmup=0)
    record = {"fn": getattr(fn, "__qualname__", repr(fn)),
              "profiled_launches_last_try": launches, "reps": reps,
              "ms": ms, "queue_held": held}
    TIMING["queued_events"].append(record)
    emit({"phase": "timing_fallback", **record})
    assert ms > 0, record
    return ms, None


def device_ms(torch, fn, reps=20, warmup=3):
    """Device time of one call of ``fn`` (device_profile)."""
    return device_profile(torch, fn, reps, warmup)[0]


def rel_l2(a, b):
    """||a - b|| / ||b|| in f32."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def tc_gate(got, want, library):
    """The tensor-core tolerance rule for one output: its relative L2 gap
    to the plain version, the library's gap, the bound, and whether it
    holds."""
    gap, lib_gap = rel_l2(got, want), rel_l2(library, want)
    bound = min(TC_REL_L2, TC_SDPA_FACTOR * lib_gap + TC_SDPA_SLACK)
    return {"rel_l2": gap, "library_rel_l2": lib_gap, "bound": bound,
            "ok": gap <= bound}


def flash_bound(b, s, h, d, dtype_name, causal, f32_out=False):
    """Least time (ms) for B1's work and what bounds it: q, k, v read once,
    O and LSE written once (and O in f32 too with ``f32_out``, as the
    training path asks of the tensor-core B1); 4*B*H*S^2*D flops, halved
    when causal."""
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4
    if f32_out:
        nbytes += 4 * b * s * h * d
    flops = 4 * b * h * s * s * d * (0.5 if causal else 1.0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# (B, S, H, D) inputs, outputs, flops / (B*H*S^2*D) and (B, H, S) f32
# vectors read of B2, B3 and the wrapper's whole backward (which reads O in
# place of D and does B2's and B3's products)
BWD_WORK = {"dkv": (4, 2, 8, 2), "dq": (4, 1, 6, 2), "whole": (5, 3, 14, 1)}


def flash_bwd_bound(b, s, h, d, dtype_name, causal, kernel):
    """Least time (ms) for B2's ("dkv"), B3's ("dq") or the whole
    backward's ("whole") work and what bounds it: each input read once,
    each output written once (BWD_WORK); the flops halved when causal."""
    elt = 2 if dtype_name == "bfloat16" else 4
    n = b * s * h * d
    inputs, outputs, coef, vectors = BWD_WORK[kernel]
    nbytes = (inputs + outputs) * n * elt + vectors * b * h * s * 4
    flops = coef * b * h * s * s * d * (0.5 if causal else 1.0)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def phase_build():
    from paddle_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    libraries = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libraries})


def qkv_views(torch, b, s, h, d, dtype, gen):
    """q, k, v as the model hands them to the kernel: at BERT's shape three
    contiguous tensors (MultiHeadAttention's separate projections), else
    the strided views of one fused projection (GPTAttention)."""
    if (b, s, h, d) == BERT_FLASH_SHAPE:
        return [torch.randn((b, s, h, d), generator=gen, device="cuda",
                            dtype=torch.float32).to(dtype) for _ in range(3)]
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                      dtype=torch.float32).to(dtype)
    return qkv.unbind(dim=2)


def launched_variant(fa, launch_counts, kernels, fn):
    """Run ``fn`` and return the variant that it launched once for each
    of ``kernels``: each must advance exactly one of its variant counters
    by one, and all the same variant."""
    keys = [f"{k}.{v}" for k in kernels for v in (fa.TC, fa.SIMT)]
    before = [launch_counts[k] for k in keys]
    result = fn()
    moved = [k for k, c in zip(keys, before) if launch_counts[k] == c + 1]
    kinds = {k.split(".", 1)[1] for k in moved}
    assert len(moved) == len(kernels) and len(kinds) == 1, (kernels, moved)
    return kinds.pop(), result


def phase_kernels(torch, seed):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(4, 512, 16, 64, torch.bfloat16, True),
             (4, 512, 16, 64, torch.bfloat16, False),
             (4, 1024, 16, 64, torch.bfloat16, True),
             (4, 1024, 16, 64, torch.bfloat16, False),
             (2, 1024, 16, 128, torch.bfloat16, True),
             (2, 1024, 16, 128, torch.bfloat16, False),
             (4, 512, 16, 64, torch.float32, True),
             (2, 512, 16, 128, torch.float32, False),
             (*BERT_FLASH_SHAPE, torch.bfloat16, False)]
    rows = []
    for b, s, h, d, dtype, causal in cases:
        dname = str(dtype).split(".")[-1]
        q, k, v = qkv_views(torch, b, s, h, d, dtype, gen)
        scale = 1.0 / d ** 0.5
        kind, (out, lse) = launched_variant(
            fa, launch_counts, (fa.KERNEL_NAME,),
            lambda: fa.flash_attention_fwd(q, k, v, causal, scale))
        assert kind == fa.variant(dtype), (kind, dname)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                            scale)
        err_o = (out.float() - ref_out.float()).abs().max().item()
        err_l = (lse - ref_lse).abs().max().item()
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
        tol_o, tol_l = KERNEL_TOL[dname]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale)
        gate = None
        if kind == fa.TC:
            gate = tc_gate(out, ref_out, sdpa().transpose(1, 2))

        def kernel():
            return fa.flash_attention_fwd(q, k, v, causal, scale)

        def plain():
            return fa.flash_attention_fwd_reference(q, k, v, causal, scale)
        ms = device_ms(torch, kernel)
        library_ms = device_ms(torch, sdpa)
        bound_ms, bound_by = flash_bound(b, s, h, d, dname, causal)
        f32_out = {}
        if kind == fa.TC:
            # the training path's launch: O also written unrounded in f32,
            # which must round to the same bf16 O
            out_g, lse_g, out32 = fa.flash_attention_fwd_for_grad(
                q, k, v, causal, scale)
            f32_bound, f32_bound_by = flash_bound(b, s, h, d, dname, causal,
                                                  f32_out=True)
            f32_out = {
                "ms_with_f32_out": device_ms(
                    torch, lambda: fa.flash_attention_fwd_for_grad(
                        q, k, v, causal, scale)),
                "bound_us_with_f32_out": f32_bound * 1e3,
                "bound_by_with_f32_out": f32_bound_by,
                "f32_out_rounds_to_out": bool(
                    torch.equal(out_g, out) and torch.equal(lse_g, lse)
                    and torch.equal(out32.to(dtype), out))}
            del out_g, lse_g, out32
        row = {"shape": [b, s, h, d], "dtype": dname, "causal": causal,
               "variant": kind,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_l,
               "tol_o": tol_o, "tol_lse": tol_l,
               "rel_l2_o": gate and gate["rel_l2"],
               "sdpa_rel_l2_o": gate and gate["library_rel_l2"],
               "rel_l2_bound": gate and gate["bound"],
               "tol_reason": TC_TOL_REASON if gate else None,
               "ms": ms, "wall_ms": cuda_time_ms(torch, kernel),
               "plain_ms": device_ms(torch, plain, reps=5, warmup=1),
               "library_ms": library_ms,
               "library_wall_ms": cuda_time_ms(torch, sdpa),
               "bound_us": bound_ms * 1e3, "bound_by": bound_by,
               "share_of_bound": bound_ms / ms,
               "factor_vs_library": ms / library_ms, **f32_out}
        emit({"phase": "kernels", "kernel": fa.KERNEL_NAME, **row})
        assert err_o <= tol_o and err_l <= tol_l, row
        assert not f32_out or f32_out["f32_out_rounds_to_out"], row
        assert gate is None or gate["ok"], row
        rows.append(row)
    return rows


def sdpa_bwd(torch, q, k, v, do, causal, scale):
    """The library yardstick for the backward: PyTorch's own fused
    attention (scaled_dot_product_attention), the gradient of a retained
    graph for dq, dk and dv together. Returns its device time and its
    CUDA-event time (ms) and its grads (B, S, H, D). Run here only; the
    port never calls it."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, scale=scale)
    g = do.transpose(1, 2)

    def grad():
        return torch.autograd.grad(out, (qt, kt, vt), g, retain_graph=True)
    grads = grad()
    return (device_ms(torch, grad), cuda_time_ms(torch, grad),
            [t.transpose(1, 2) for t in grads])


def phase_kernels_bwd(torch, seed):
    """B2 and B3 against the plain backward on the card, each timed alone
    (its launcher, on a precomputed D), beside the plain backward and the
    library's backward (both compute dq, dk and dv together). bf16 grads
    (the tensor-core B2 and B3) are held to the relative-L2 rule, f32
    grads elementwise. At the bf16 causal shapes the wrapper's whole
    backward is timed against the library's backward, and bwd_delta (D =
    rowsum(dO * O)) alone beside it."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    cases = [(4, 1024, 16, 64, torch.bfloat16, True),    # the training shape
             (4, 512, 16, 64, torch.bfloat16, True),
             (4, 512, 16, 64, torch.bfloat16, False),
             (2, 1024, 16, 128, torch.bfloat16, True),
             (4, 512, 16, 64, torch.float32, True),
             (2, 512, 16, 128, torch.float32, False),
             (*BERT_FLASH_SHAPE, torch.bfloat16, False)]
    rows = {"dkv": [], "dq": [], "whole": []}
    for b, s, h, d, dtype, causal in cases:
        dname = str(dtype).split(".")[-1]
        q, k, v = qkv_views(torch, b, s, h, d, dtype, gen)
        do = torch.randn((b, s, h, d), generator=gen, device="cuda",
                         dtype=torch.float32).to(dtype)
        scale = 1.0 / d ** 0.5
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        kind, got = launched_variant(
            fa, launch_counts, (fa.DKV_KERNEL, fa.DQ_KERNEL),
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                           scale))
        assert kind == fa.variant(dtype), (kind, dname)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                causal, scale)
        library_ms, library_wall_ms, lib = sdpa_bwd(torch, q, k, v, do,
                                                    causal, scale)
        err, share_of_tol, info, gates = {}, {}, {}, {}
        for name, g, w, x in zip(("dq", "dk", "dv"), got, want, lib):
            assert torch.isfinite(g.float()).all(), name
            diff = (g.float() - w.float()).abs()
            err[name] = diff.max().item()
            # the kernel may agree with the plain version to the bit; the
            # size of the values and the gap to the library's independent
            # backward show the comparison is not empty
            info[name] = {"max_abs_plain": w.float().abs().max().item(),
                          "max_abs_gap_vs_library":
                              (g.float() - x.float()).abs().max().item()}
            if kind == fa.TC:
                gates[name] = tc_gate(g, w, x)
            else:
                share_of_tol[name] = (
                    diff / (BWD_ATOL + BWD_RTOL * w.float().abs())
                ).max().item()
        del got, want, lib
        delta = fa.bwd_delta(out, do)

        def dkv():
            return fa.launch_dkv(q, k, v, do, lse, delta, causal, scale)

        def dq():
            return fa.launch_dq(q, k, v, do, lse, delta, causal, scale)
        # the queued-event time is device_profile's fallback, measured here
        # on every run so that it stays checked against the profiler
        times = {"dkv": (device_ms(torch, dkv), cuda_time_ms(torch, dkv),
                         queued_event_ms(torch, dkv)[0]),
                 "dq": (device_ms(torch, dq), cuda_time_ms(torch, dq),
                        queued_event_ms(torch, dq)[0])}
        plain_ms = device_ms(torch, lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal, scale), reps=3, warmup=1)
        if kind == fa.TC and (causal or (b, s, h, d) == BERT_FLASH_SHAPE):
            rows["whole"].append(whole_backward(
                torch, fa, (q, k, v, out, lse, do), causal, scale, kind,
                library_ms))
        for kernel, name, outs in (("dkv", fa.DKV_KERNEL, ("dk", "dv")),
                                   ("dq", fa.DQ_KERNEL, ("dq",))):
            bound_ms, bound_by = flash_bwd_bound(b, s, h, d, dname, causal,
                                                 kernel)
            ms, wall_ms, queued_ms = times[kernel]
            elementwise = [o for o in outs if o in share_of_tol]
            row = {"shape": [b, s, h, d], "dtype": dname, "causal": causal,
                   "variant": kind,
                   "max_abs_err": max(err[o] for o in outs),
                   "max_abs_err_by_output": {o: err[o] for o in outs},
                   "sanity_by_output": {o: info[o] for o in outs},
                   "ms": ms, "wall_ms": wall_ms,
                   "queued_event_ms": queued_ms, "plain_ms": plain_ms,
                   "plain_scope": "dq, dk and dv together",
                   "library_ms": library_ms,
                   "library_wall_ms": library_wall_ms,
                   "library_scope": "SDPA backward, dq, dk and dv together",
                   "bound_us": bound_ms * 1e3, "bound_by": bound_by,
                   "share_of_bound": bound_ms / ms,
                   "factor_vs_library": ms / library_ms}
            if elementwise:
                row.update(rtol=BWD_RTOL, atol=BWD_ATOL,
                           tol_reason=BWD_TOL_REASON,
                           worst_share_of_tol=max(share_of_tol[o]
                                                  for o in elementwise))
            else:
                row.update(rel_l2_by_output={o: gates[o] for o in outs},
                           tol_reason=TC_TOL_REASON)
            emit({"phase": "kernels", "kernel": name, **row})
            rows[kernel].append(row)
        assert max(share_of_tol.values(), default=0.0) <= 1.0, \
            (dname, causal, err)
        assert all(gt["ok"] for gt in gates.values()), (dname, causal, gates)
        del out, lse, delta, q, k, v, do
        torch.cuda.empty_cache()
    return rows


def whole_backward(torch, fa, inputs, causal, scale, kind, library_ms):
    """The wrapper's whole backward (bwd_delta, B2 and B3) against the
    library's backward, both as device time, and bwd_delta alone: its
    device time and kernel launches per call."""
    q, k, v, out, lse, do = inputs
    b, s, h, d = q.shape
    dname = str(q.dtype).split(".")[-1]
    ms, launches = device_profile(torch, lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal, scale))
    delta_ms, delta_launches = device_profile(
        torch, lambda: fa.bwd_delta(out, do))
    bound_ms, bound_by = flash_bwd_bound(b, s, h, d, dname, causal, "whole")
    row = {"phase": "kernels", "kernel": "flash_attention_bwd",
          "scope": "the wrapper's whole backward: bwd_delta, B2, B3",
          "shape": [b, s, h, d], "dtype": dname, "causal": causal,
          "variant": kind, "ms": ms, "launches_per_call": launches,
          "library_ms": library_ms,
          "library_scope": "SDPA backward, dq, dk and dv together",
          "factor_vs_library": ms / library_ms,
          "bwd_delta_ms": delta_ms,
          "bwd_delta_launches_per_call": delta_launches,
          "bwd_delta_share": delta_ms / ms,
          "bound_us": bound_ms * 1e3, "bound_by": bound_by,
          "share_of_bound": bound_ms / ms}
    emit(row)
    return row


def greedy(torch, model, ids, steps):
    """Batched prefill, then ``steps`` KV-cached greedy decode steps.
    Returns tokens (b, steps + 1), prefill logits, TTFT s, decode s."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model(ids, caches=model.gpt.init_decode_caches())
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = [tok]
    for _ in range(steps):
        step_logits, caches = model(tok, caches=caches)
        tok = step_logits[:, -1].argmax(dim=-1, keepdim=True)
        toks.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return torch.cat(toks, dim=1), logits, t1 - t0, t2 - t1


def set_flash(model, on):
    for block in model.gpt.h:
        block.attn.use_flash = on


def phase_reference(torch, seed):
    """A small f32 GPT built from the seed on the card and on the host
    (same weights: both draw from a CPU generator). The card's kernel path
    must agree with the host's math path, which tests/test_torch_gpt.py
    holds against paddle_tpu: logits within 1e-4, identical tokens."""
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=512, dropout=0.0)
    ids = torch.randint(0, cfg.vocab_size, (2, 256),
                        generator=torch.Generator().manual_seed(seed + 1))
    out = {}
    for dev in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(seed))
        with torch.inference_mode():
            out[dev] = greedy(torch, model.eval(), ids.to(dev), 8)
    gap = (out["cuda"][1].cpu() - out["cpu"][1]).abs().max().item()
    same = torch.equal(out["cuda"][0].cpu(), out["cpu"][0])
    emit({"phase": "reference", "config": "GPT v256 h128 L2 a2 d64 f32",
          "prompt": [2, 256], "decode_steps": 8,
          "logits_max_abs_gap_card_vs_host": gap, "tol": 1e-4,
          "greedy_tokens_identical": same})
    assert gap <= 1e-4 and same


def phase_serve(torch, seed):
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import (KERNEL_NAME,
                                                           variant_counter)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024, num_layers=24,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    ids = torch.randint(0, cfg.vocab_size, (PROMPTS, PROMPT_LEN),
                        generator=torch.Generator().manual_seed(seed + 1))
    ids = ids.to("cuda")
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        model = GPTForCausalLM(cfg, device="cuda", dtype=dtype,
                               generator=torch.Generator().manual_seed(seed))
        model.eval()
        build_s = time.perf_counter() - t0
        with torch.inference_mode():
            greedy(torch, model, ids, 2)                 # warm-up
            torch.cuda.reset_peak_memory_stats()
            launch_counts.clear()
            toks, logits, ttft, decode_s = greedy(torch, model, ids,
                                                  DECODE_STEPS)
            launches = launch_counts[KERNEL_NAME]
            variant = variant_counter(KERNEL_NAME, dtype)
            variant_launches = launch_counts[variant]
            peak = torch.cuda.max_memory_allocated()
            assert launches == cfg.num_layers, (launches, cfg.num_layers)
            assert variant_launches == launches, (variant, dict(launch_counts))
            assert toks.shape == (PROMPTS, DECODE_STEPS + 1)
            assert logits.shape == (PROMPTS, PROMPT_LEN, cfg.vocab_size)
            assert torch.isfinite(logits.float()).all()
            set_flash(model, False)
            launch_counts.clear()
            m_toks, m_logits, m_ttft, m_decode_s = greedy(torch, model, ids,
                                                          DECODE_STEPS)
            assert launch_counts[KERNEL_NAME] == 0
            set_flash(model, True)
            if dtype == torch.bfloat16:
                profile_windows(torch, model, ids)
        gap = (logits.float() - m_logits.float()).abs().max().item()
        agree = int((toks == m_toks).sum().item())
        row = {"phase": "serve", "dtype": dname,
               "config": "GPT-medium v32000 h1024 L24 a16 d64",
               "prompts": PROMPTS, "prompt_len": PROMPT_LEN,
               "decode_steps": DECODE_STEPS, "model_build_s": build_s,
               "ttft_ms": ttft * 1e3,
               "tpot_ms": decode_s / DECODE_STEPS * 1e3,
               "decode_tokens_per_s": PROMPTS * DECODE_STEPS / decode_s,
               "peak_mem_bytes": peak, "flash_launches": launches,
               "flash_variant": variant,
               "flash_variant_launches": variant_launches,
               "prefill_forwards": 1, "math_path_ttft_ms": m_ttft * 1e3,
               "math_path_tpot_ms": m_decode_s / DECODE_STEPS * 1e3,
               "logits_max_abs_gap_vs_math": gap,
               "logits_tol": LOGIT_TOL[dname],
               "greedy_tokens_agree": agree, "greedy_tokens": toks.numel()}
        emit(row)
        assert gap <= LOGIT_TOL[dname], row
        if dtype == torch.float32:
            assert torch.equal(toks, m_toks), "f32 greedy tokens differ"
        result[dname] = row
        del model, logits, m_logits
        torch.cuda.empty_cache()
    return result


def profile_windows(torch, model, ids, decode_steps=16):
    """Device time by kernel over one warm prefill and over
    ``decode_steps`` cached decode steps (torch.profiler), beside the
    host-clock wall time of the same window: the busy share is the summed
    kernel time over the wall time (kernels on one stream do not overlap;
    the profiler's own host overhead stretches the wall time)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        torch.cuda.synchronize()
        windows = {}
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, caches = model(ids, caches=model.gpt.init_decode_caches())
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            windows["prefill"] = (prof, time.perf_counter() - t0)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(decode_steps):
                step_logits, caches = model(tok, caches=caches)
                tok = step_logits[:, -1].argmax(dim=-1, keepdim=True)
            torch.cuda.synchronize()
            windows["decode"] = (prof, time.perf_counter() - t0)
    for name, (prof, wall_s) in windows.items():
        emit_profile(prof, wall_s, name,
                     1 if name == "prefill" else decode_steps)


def emit_profile(prof, wall_s, window, steps, top=12, **extra):
    """Device time by kernel of a profiled window, and the busy share: the
    summed kernel time over the host-clock wall time of the window. The
    port's flash kernels are listed by name whatever their rank."""
    kernels = kernel_times(prof)
    device_us = sum(k[0] for k in kernels)
    row = {"phase": "profile", "window": window, "steps": steps,
           "wall_ms": wall_s * 1e3, "device_ms": device_us / 1e3,
           "busy_share": device_us / 1e3 / (wall_s * 1e3),
           "kernel_launches": sum(k[1] for k in kernels),
           "flash_kernels": {m.group(0): {"ms": k[0] / 1e3, "count": k[1]}
                             for k in kernels
                             for m in [re.search(r"flash_\w+<[^>]*>", k[2])]
                             if m},
           "top": [{"kernel": k[2][:90], "ms": k[0] / 1e3,
                    "count": k[1]} for k in kernels[:top]], **extra}
    emit(row)
    return row


def annotated_kernels(prof, name):
    """(device ms, kernel launches, calls) of the kernels launched under
    the host ranges called ``name`` (torch.profiler.record_function) in a
    profile."""
    def launches(e):
        return len(e.kernels) + sum(launches(c) for c in e.cpu_children)
    ranges = [e for e in prof.events() if e.name == name
              and str(e.device_type).endswith("CPU")]
    return (sum(e.device_time_total for e in ranges) / 1e3,
            sum(launches(e) for e in ranges), len(ranges))


def bench_stream(seed, steps, batch, seq, sub=512):
    """bench.py's learnable stream: a fixed random permutation over a
    512-token sub-vocabulary drives next-token generation, x[t+1] =
    perm[x[t]]. Returns int32 inputs and int64 labels, (steps, batch,
    seq) each."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(sub)
    ids = np.empty((steps, batch, seq + 1), np.int64)
    ids[:, :, 0] = rng.randint(0, sub, (steps, batch))
    for t in range(seq):
        ids[:, :, t + 1] = perm[ids[:, :, t]]
    return ids[:, :, :-1].astype("int32"), ids[:, :, 1:]


def train_step_fn(model, opt):
    """The training step as bench.py writes it, through the port."""
    import paddle_tpu_torch as pt

    @pt.jit.to_static
    def step(x, y):
        loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.float()
    return step


def loss_and_grads(model, x, y):
    """Forward and backward of the training loss: (loss, {name: grad})."""
    loss = model(x, labels=y)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def grad_gaps(torch, grads, ref):
    """Each parameter's relative L2 gap, worst first (name, gap)."""
    gaps = [(n, ((g.float().cpu() - ref[n].float().cpu()).norm()
                 / ref[n].float().cpu().norm().clamp_min(1e-30)).item())
            for n, g in grads.items()]
    return sorted(gaps, key=lambda t: -t[1])


def phase_reference_train(torch, seed):
    """A small f32 GPT takes 3 AdamW steps on the card (kernel path, B1/B2/
    B3 launched) and on the host (math path, which tests/test_torch_training
    holds against paddle_tpu): losses within 1e-4, first-step grads within
    1e-4 relative L2 (summation order only)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_position_embeddings=512, dropout=0.0)
    xs, ys = bench_stream(seed + 3, 3, 2, 256, sub=64)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = GPTForCausalLM(cfg, device=dev,
                               generator=torch.Generator().manual_seed(seed))
        opt = pt.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
        launch_counts.clear()
        losses, first_grads = [], None
        for x, y in zip(xs, ys):
            x = torch.from_numpy(x).to(dev)
            y = torch.from_numpy(y).to(dev)
            if first_grads is None:
                loss, first_grads = loss_and_grads(model, x, y)
            loss = model(x, labels=y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        runs[dev] = (losses, first_grads,
                     {n: launch_counts[n] for n in KERNEL_NAMES})
    gaps = grad_gaps(torch, runs["cuda"][1], runs["cpu"][1])
    loss_gap = max(abs(a - b) for a, b in zip(runs["cuda"][0],
                                              runs["cpu"][0]))
    # 4 training forwards (one for the grads, then 3 steps) of 2 layers
    want = {n: 0 for n in KERNEL_NAMES}
    emit({"phase": "reference", "config": "GPT v256 h128 L2 a2 d64 f32",
          "train_batch": [2, 256], "adamw_steps": 3,
          "losses_card": runs["cuda"][0], "losses_host": runs["cpu"][0],
          "loss_max_abs_gap": loss_gap, "loss_tol": SMALL_LOSS_TOL,
          "first_step_grad_rel_l2_worst": gaps[0],
          "grad_rel_l2_tol": SMALL_GRAD_RTOL,
          "card_launches": runs["cuda"][2]})
    assert runs["cpu"][2] == want
    assert all(c == 4 * cfg.num_layers for c in runs["cuda"][2].values())
    assert loss_gap <= SMALL_LOSS_TOL and gaps[0][1] <= SMALL_GRAD_RTOL


def phase_train(torch, seed):
    """GPT-medium at full width trains in bf16 through the port's entry
    points (bench.py's step); then a profiled step and the f32 check."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    from torch.profiler import ProfilerActivity, profile, record_function
    # the counters of each kernel's variant for each dtype
    variants = {dt: [fa.variant_counter(n, dt) for n in KERNEL_NAMES]
                for dt in (torch.bfloat16, torch.float32)}
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024, num_layers=24,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    total = TRAIN_WARMUP + TRAIN_STEPS + 1
    xs, ys = bench_stream(seed, total, TRAIN_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    step = train_step_fn(model, opt)
    # the eager path: every call runs the Python body (the compiled_train
    # phase captures the same step)
    pt.set_flags({"FLAGS_compiled_step": False})
    losses = [step(xs[i], ys[i]) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    per_step = []
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        before = [launch_counts[n] for n in KERNEL_NAMES]
        losses.append(step(xs[i], ys[i]))
        per_step.append([launch_counts[n] - c
                         for n, c in zip(KERNEL_NAMES, before)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {n: launch_counts[n]
                for n in (*KERNEL_NAMES, *variants[torch.bfloat16],
                          *variants[torch.float32])}
    peak = torch.cuda.max_memory_allocated()
    losses = [loss.item() for loss in losses]
    row = {"phase": "train", "dtype": "bfloat16",
           "config": "GPT-medium v32000 h1024 L24 a16 d64",
           "optimizer": "AdamW lr 1e-4 multi_precision (f32 masters)",
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "warmup_steps": TRAIN_WARMUP,
           "timed_steps": TRAIN_STEPS,
           "step_ms": seconds / TRAIN_STEPS * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / seconds,
           "peak_mem_bytes": peak, "losses": losses,
           "launches": launches,
           "launches_per_step": dict(zip(KERNEL_NAMES, per_step[0]))}
    emit(row)
    assert all(c == [cfg.num_layers] * len(KERNEL_NAMES) for c in per_step), \
        per_step
    # B1, B2 and B3 ran their tensor-core variants, every launch
    assert all(launches[n] == cfg.num_layers * TRAIN_STEPS
               for n in variants[torch.bfloat16]), launches
    assert all(launches[n] == 0 for n in variants[torch.float32]), launches
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    # bwd_delta's kernels are generic elementwise and reduction kernels:
    # a host range around each call tells them apart in the profile
    def annotated_delta(out, do):
        with record_function("flash_bwd_delta"):
            return plain_delta(out, do)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    plain_delta, fa.bwd_delta = fa.bwd_delta, annotated_delta
    try:
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(xs[-1], ys[-1])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        fa.bwd_delta = plain_delta
        pt.set_flags({"FLAGS_compiled_step": True})
    delta_ms, delta_launches, delta_calls = annotated_kernels(
        prof, "flash_bwd_delta")
    row["profile"] = emit_profile(
        prof, wall_s, "train_step", 1, top=16,
        bwd_delta={"ms": delta_ms, "launches": delta_launches,
                   "calls": delta_calls})
    assert delta_calls == cfg.num_layers, delta_calls
    del model, opt, step, prof
    torch.cuda.empty_cache()

    # f32 at full width: one step's loss and grads, kernel path against the
    # math path (use_flash_attention off), from the same weights and batch
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    launch_counts.clear()
    k_loss, k_grads = loss_and_grads(model, xs[0], ys[0])
    f32_launches = {n: launch_counts[n] for n in KERNEL_NAMES}
    f32_variants = {n: launch_counts[n]
                    for n in (*variants[torch.float32],
                              *variants[torch.bfloat16])}
    set_flash(model, False)
    m_loss, m_grads = loss_and_grads(model, xs[0], ys[0])
    gaps = grad_gaps(torch, k_grads, m_grads)
    check = {"phase": "train_check", "dtype": "float32",
             "config": "GPT-medium v32000 h1024 L24 a16 d64 (full depth)",
             "batch": [TRAIN_BATCH, TRAIN_SEQ],
             "loss_kernel_path": k_loss, "loss_math_path": m_loss,
             "loss_rel_gap": abs(k_loss - m_loss) / abs(m_loss),
             "loss_rtol": TRAIN_LOSS_RTOL,
             "grad_rel_l2_worst": gaps[:3],
             "grad_rel_l2_median": gaps[len(gaps) // 2][1],
             "grad_rel_l2_tol": TRAIN_GRAD_RTOL,
             "kernel_path_launches": f32_launches,
             "kernel_path_variant_launches": f32_variants,
             "math_path_launches": {n: launch_counts[n] - f32_launches[n]
                                    for n in KERNEL_NAMES}}
    emit(check)
    assert all(c == cfg.num_layers for c in f32_launches.values())
    assert all(f32_variants[n] == cfg.num_layers
               for n in variants[torch.float32]), f32_variants
    assert all(f32_variants[n] == 0 for n in variants[torch.bfloat16])
    assert all(c == 0 for c in check["math_path_launches"].values())
    assert check["loss_rel_gap"] <= TRAIN_LOSS_RTOL, check
    assert gaps[0][1] <= TRAIN_GRAD_RTOL, check
    row["f32_launches"] = f32_variants
    del k_grads
    bf16_check(torch, model, xs[0], ys[0], m_loss, m_grads, variants)
    del model, m_grads
    torch.cuda.empty_cache()
    return row


def bf16_check(torch, model, x, y, f32_loss, f32_grads, variants,
               path=set_flash, n_layers=None,
               config="GPT-medium v32000 h1024 L24 a16 d64 (full depth)",
               gaps=grad_gaps, zero_share=None):
    """One bf16 step at full width from the f32 check's weights cast to
    bf16, on the kernel path (tensor-core B1, B2 and B3) and on the math
    path. The f32 math path's loss and grads are the truth: the
    kernel path's relative gap to it must be no more than BF16_GRAD_FACTOR
    times the bf16 math path's + BF16_GRAD_SLACK, for the loss and for
    every parameter's grad (relative L2, as ``gaps`` measures it).
    ``path(model, on)`` switches the model between the two paths;
    ``zero_share(grads)``, where given, holds the grads that ``gaps``
    leaves out (KEY_BIAS_TOL in bf16)."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    model.to(torch.bfloat16)
    path(model, True)
    launch_counts.clear()
    k_loss, k_grads = loss_and_grads(model, x, y)
    k_launches = dict(launch_counts)
    path(model, False)
    launch_counts.clear()
    m_loss, m_grads = loss_and_grads(model, x, y)
    m_launches = sum(launch_counts[n] for n in KERNEL_NAMES)
    k_gap = dict(gaps(torch, k_grads, f32_grads))
    m_gap = dict(gaps(torch, m_grads, f32_grads))
    share = {n: k_gap[n] / (BF16_GRAD_FACTOR * m_gap[n] + BF16_GRAD_SLACK)
             for n in k_gap}
    worst = sorted(share, key=lambda n: -share[n])[:3]
    loss_gap = {"kernel": abs(k_loss - f32_loss) / abs(f32_loss),
                "math": abs(m_loss - f32_loss) / abs(f32_loss)}
    check = {"phase": "train_check", "dtype": "bfloat16",
             "config": config,
             "batch": list(x.shape), "truth": "f32 math path",
             "loss_kernel_path": k_loss, "loss_math_path": m_loss,
             "loss_f32": f32_loss, "loss_rel_gap": loss_gap,
             "rule": f"kernel gap <= {BF16_GRAD_FACTOR} x bf16 math-path "
                     f"gap + {BF16_GRAD_SLACK}",
             "worst_params": [{"param": n, "kernel_rel_l2": k_gap[n],
                               "math_rel_l2": m_gap[n],
                               "share_of_bound": share[n]} for n in worst],
             "kernel_rel_l2_median": sorted(k_gap.values())[len(k_gap) // 2],
             "math_rel_l2_median": sorted(m_gap.values())[len(m_gap) // 2],
             "kernel_path_launches": k_launches,
             "math_path_launches": m_launches}
    if zero_share is not None:
        check["key_bias_share"] = {"kernel": zero_share(k_grads),
                                   "math": zero_share(m_grads),
                                   "tol": KEY_BIAS_TOL["bfloat16"]}
    emit(check)
    n_layers = n_layers or model.config.num_layers
    if zero_share is not None:
        assert all(check["key_bias_share"][p][1] <= KEY_BIAS_TOL["bfloat16"]
                   for p in ("kernel", "math")), check
    assert all(k_launches.get(n, 0) == n_layers
               for n in (*KERNEL_NAMES, *variants[torch.bfloat16])), k_launches
    assert m_launches == 0
    assert loss_gap["kernel"] <= (BF16_GRAD_FACTOR * loss_gap["math"]
                                  + BF16_GRAD_SLACK), check
    assert share[worst[0]] <= 1.0, check
    del k_grads, m_grads
    return check


# the tensor-core kernels of a step, by the names of their __global__
# functions: a replayed graph launches them without passing through the
# wrappers, whose Python counts therefore do not move
TC_KERNEL_NAMES = {"flash_attn_fwd": "flash_fwd_tc_kernel",
                   "flash_attn_bwd_dkv": "flash_bwd_dkv_tc_kernel",
                   "flash_attn_bwd_dq": "flash_bwd_dq_tc_kernel"}
# eager and captured bf16 loss curves, step by step (the same kernels on
# the same batches; bf16 rounding differs between two runs only where the
# order of reductions does)
CURVE_RTOL = 2e-2


def profiled(torch, fn, steps, expect=None, tries=3):
    """Profile ``fn`` (which runs ``steps`` training steps): the profile,
    its host-clock wall seconds, its result, and per step the kernels'
    device ms, kernel launches, host graph launches and B1/B2/B3 launches
    counted by kernel name.

    A replayed graph launches the same kernels every time, so a profile
    whose B1/B2/B3 counts fall short of ``expect`` ({kernel: launches per
    step}) lost records: ``fn`` then runs again under a new profile, up to
    ``tries`` times, and ``profile_tries`` says how many it took."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        kernels = kernel_times(prof)
        graph_launches = sum(1 for e in prof.events()
                             if e.name.startswith("cudaGraphLaunch"))
        per_step = {
            "device_ms": sum(k[0] for k in kernels) / 1e3 / steps,
            "kernel_launches": sum(k[1] for k in kernels) / steps,
            "graph_launches": graph_launches / steps,
            "flash_launches": {n: sum(k[1] for k in kernels if tc in k[2])
                               / steps for n, tc in TC_KERNEL_NAMES.items()},
            "profile_tries": attempt}
        if expect is None or per_step["flash_launches"] == expect:
            break
    return prof, wall_s, out, per_step


def phase_compiled_train(torch, seed, eager):
    """The train phase's cell with its step captured: GPT-medium bf16,
    AdamW(multi_precision), the same weights and batches, the step under
    ``jit.to_static`` wrapped in ``CompiledTrainStep``, so that it becomes
    one CUDA graph (jit/to_static.py). 4 warm-up steps (a discovery pass,
    the capture and its replay, two replays), then 16 timed replays, held
    against the train phase's eager run (``eager``): compile counters, the
    loss curves step by step, step time, tokens/s, peak memory; then one
    replayed step profiled (device time, busy share, graph launches,
    kernels per replay and B1/B2/B3 by kernel name)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024, num_layers=24,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0)
    total = TRAIN_WARMUP + TRAIN_STEPS + 1
    xs, ys = bench_stream(seed, total, TRAIN_BATCH, TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    step = CompiledTrainStep(train_step_fn(model, opt), label="gpt_medium")
    reset_compile_stats()
    t0 = time.perf_counter()
    losses = [step(xs[i], ys[i]) for i in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    warm = compile_stats()
    reset_compile_stats()
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        losses.append(step(xs[i], ys[i]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    timed = compile_stats()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    losses = [loss.item() for loss in losses]
    _, wall_s, _, prof = profiled(torch, lambda: step(xs[-1], ys[-1]), 1,
                                  expect={k: cfg.num_layers
                                          for k in TC_KERNEL_NAMES})
    step_ms = seconds / TRAIN_STEPS * 1e3
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, eager["losses"])]
    row = {"phase": "compiled_train", "dtype": "bfloat16",
           "config": "GPT-medium v32000 h1024 L24 a16 d64",
           "optimizer": "AdamW lr 1e-4 multi_precision (f32 masters)",
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "warmup_steps": TRAIN_WARMUP,
           "timed_steps": TRAIN_STEPS,
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "warmup_s": warmup_s,
           "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / seconds,
           "eager_step_ms": eager["step_ms"],
           "eager_tokens_per_s": eager["tokens_per_s"],
           "speedup_vs_eager": eager["step_ms"] / step_ms,
           "peak_mem_bytes": peak, "reserved_bytes_end": reserved,
           "eager_peak_mem_bytes": eager["peak_mem_bytes"],
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3,
                              "busy_share": prof["device_ms"]
                              / (wall_s * 1e3)},
           "unprofiled_busy_share": prof["device_ms"] / step_ms,
           "eager_profile": {k: eager["profile"][k] for k in (
               "device_ms", "wall_ms", "busy_share", "kernel_launches")},
           "losses": losses, "eager_losses": eager["losses"],
           "curve_rel_gap_max": max(gaps), "curve_rtol": CURVE_RTOL}
    emit(row)
    n = cfg.num_layers
    assert warm == {"compiles": 1, "cache_hits": 2,
                    "retrace_warnings": 0}, warm
    assert timed == {"compiles": 0, "cache_hits": TRAIN_STEPS,
                     "retrace_warnings": 0}, timed
    assert prof["flash_launches"] == {k: n for k in TC_KERNEL_NAMES}, prof
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert max(gaps) <= CURVE_RTOL, gaps
    del model, opt, step
    torch.cuda.empty_cache()
    return row


def phase_amp_train(torch, seed):
    """bench.py's GPT lane with BENCH_DTYPE=amp and BENCH_GPT_RECOMPUTE=1,
    a global-norm clip and a warm-up schedule: GPT-medium with f32
    parameters, the forward under ``amp.auto_cast(dtype="bfloat16")``,
    ``recompute=True``, AdamW + ClipGradByGlobalNorm(1.0) + LinearWarmup,
    the step captured and driven through ``run_steps`` with K = 4, three
    times (12 steps; single-batch losses spike early in training, so the
    gate compares the mean loss of the last execution with the first's);
    the scheduler steps between executions. The step returns the lr tensor
    beside the loss, so each step's lr is read back. The first execution
    holds the discovery pass and the capture, the second is profiled (B1
    runs 48 times a step, the forward and its rerun in the backward; B2 and
    B3 24), the third is timed unprofiled."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.text.models.gpt import GPTConfig, GPTForCausalLM
    k_steps, executions = 4, 3
    cfg = GPTConfig(vocab_size=32000, hidden_size=1024, num_layers=24,
                    num_heads=16, max_position_embeddings=1024, dropout=0.0,
                    recompute=True)
    xs, ys = bench_stream(seed, k_steps * executions, TRAIN_BATCH,
                          TRAIN_SEQ)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32,
                           generator=torch.Generator().manual_seed(seed))
    model.train()
    sched = pt.optimizer.lr.LinearWarmup(learning_rate=1e-4, warmup_steps=2,
                                         start_lr=5e-5, end_lr=1e-4)
    opt = pt.optimizer.AdamW(learning_rate=sched,
                             parameters=model.parameters(),
                             grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))

    def train_step(x, y):
        with pt.amp.auto_cast(dtype="bfloat16"):
            loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.float(), opt._learning_rate
    step = CompiledTrainStep(pt.jit.to_static(train_step),
                             label="gpt_medium_amp")
    reset_compile_stats()
    losses, lrs, want_lrs, stats, times, prof = [], [], [], [], [], None
    for e in range(executions):
        sl = slice(e * k_steps, (e + 1) * k_steps)
        want_lrs += [float(np.float32(sched()))] * k_steps

        def run():
            return step.run_steps(xs[sl], ys[sl])
        if e == 1:
            _, wall_s, out, prof = profiled(
                torch, run, k_steps,
                expect={"flash_attn_fwd": 2 * cfg.num_layers,
                        "flash_attn_bwd_dkv": cfg.num_layers,
                        "flash_attn_bwd_dq": cfg.num_layers})
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        times.append(wall_s / k_steps * 1e3)
        stats.append(compile_stats())
        reset_compile_stats()
        losses += out[0].tolist()
        lrs += out[1].tolist()
        sched.step()
    peak = torch.cuda.max_memory_allocated()
    row = {"phase": "amp_train",
           "config": "GPT-medium v32000 h1024 L24 a16 d64, f32 params, "
                     "auto_cast bf16 (O1), recompute",
           "optimizer": "AdamW + ClipGradByGlobalNorm(1.0) + LinearWarmup "
                        "(5e-5 -> 1e-4 over 2 executions)",
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "k_steps": k_steps,
           "executions": executions, "compile_stats": stats,
           "step_ms_by_execution": times,
           "step_ms": times[2],
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / times[2] * 1e3,
           "replay_profile": {**prof, "busy_share": prof["device_ms"]
                              / times[1]},
           "peak_mem_bytes": peak,
           "losses": losses, "lrs": lrs, "scheduler_lrs": want_lrs,
           "mean_loss_by_execution": [float(np.mean(losses[i:i + k_steps]))
                                      for i in range(0, len(losses),
                                                     k_steps)]}
    emit(row)
    n = cfg.num_layers
    # the profiled execution runs once more for each profile retaken
    runs = [1, prof["profile_tries"], 1]
    assert stats[0]["compiles"] == 1 and all(st == {
        "compiles": 0, "cache_hits": k_steps * r, "retrace_warnings": 0}
        for st, r in zip(stats[1:], runs[1:])), stats
    assert prof["flash_launches"] == {"flash_attn_fwd": 2 * n,
                                      "flash_attn_bwd_dkv": n,
                                      "flash_attn_bwd_dq": n}, prof
    assert lrs == want_lrs, (lrs, want_lrs)
    means = row["mean_loss_by_execution"]
    assert all(np.isfinite(losses)) and means[-1] < means[0], losses
    del model, opt, step
    torch.cuda.empty_cache()
    return row


def cls_stream(seed, stacks, spe, batch, seq, vocab):
    """bench.py's parity-label stream (bench_bert's data): random ids,
    except that positions 0-7 carry tokens of a 16-token sub-vocabulary
    whose parity is the label, so the label is learnable from any of
    eight embeddings. One (ids, labels) pair of (spe, batch, seq) int64
    and (spe, batch) int64 per execution, drawn in bench's order from
    RandomState(seed)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(stacks):
        ids = rng.randint(0, vocab, (spe, batch, seq))
        labels = rng.randint(0, 2, (spe, batch)).astype("int64")
        ids[:, :, :8] = (2 * rng.randint(0, 8, (spe, batch, 8))
                         + labels[..., None])
        out.append((ids.astype("int64"), labels))
    return out


def bert_grad_gaps(torch, grads, ref):
    """grad_gaps for an encoder with separate key projections, without the
    key projections' biases: their grad is zero in exact arithmetic (the
    softmax over the keys ignores a shift common to one query's logits),
    so a relative gap there compares rounding noise with rounding noise.
    ``key_bias_share`` holds them instead."""
    keep = {n: g for n, g in grads.items() if not n.endswith(KEY_BIAS)}
    return grad_gaps(torch, keep, ref)


def key_bias_share(grads):
    """(name, share) of the key-projection bias whose grad norm is the
    largest share of its projection weight's grad norm: zero in exact
    arithmetic, a small share of it in floating point."""
    shares = [(n, (grads[n].float().norm() / grads[
        n[:-len("bias")] + "weight"].float().norm().clamp_min(1e-30)).item())
        for n in grads if n.endswith(KEY_BIAS)]
    return max(shares, key=lambda t: t[1])


def set_bert_flash(model, on):
    for layer in model.bert.encoder.layers:
        layer.self_attn.use_flash_attention = on


def bert_model(torch, cfg, seed, device="cuda", arch="bert"):
    """A sequence classifier (2 classes) with random weights from the
    seed, drawn on the host so that every device gets the same ones."""
    from paddle_tpu_torch.text.models import (BertForSequenceClassification,
                                              ErnieForSequenceClassification)
    cls = (ErnieForSequenceClassification if arch == "ernie"
           else BertForSequenceClassification)
    return cls(cfg, num_classes=2, device=device,
               generator=torch.Generator().manual_seed(seed))


def phase_to_static_grad(torch, seed):
    """The repaired faults of the captured step, on the card, with
    BERT-base in f32 at 4 x 256 (so B1, B2 and B3 run, SIMT, in its
    graphs, 12 layers' activations saved between them): a forward-only ``to_static(model)`` under an outer backward, called 3
    times (discovery, the capture of forward and backward, a replay), gives
    eager's grads; a train step that runs its own backward refuses to be
    differentiated; an optimizer built on host parameters, then the model
    moved to the card, reads its LinearWarmup scheduler's lr at every
    replay."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.text.models import BertConfig
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    (xs, ys), = cls_stream(seed + 7, 1, 5, 4, 256, cfg.vocab_size)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    eager = bert_model(torch, cfg, seed).train()
    static = pt.jit.to_static(bert_model(torch, cfg, seed).train())
    worst, zero_grads = [], []
    for i in range(3):
        want_loss, want = loss_and_grads(eager, xs[i], ys[i])
        got_loss, got = loss_and_grads(static, xs[i], ys[i])
        gaps = bert_grad_gaps(torch, got, want)
        worst.append({"call": i + 1, "loss": got_loss,
                      "eager_loss": want_loss, "worst": gaps[0],
                      "key_bias_share": key_bias_share(got)})
        zero_grads += [(i + 1, n) for n, g in got.items()
                       if not n.endswith(KEY_BIAS) and not g.any()]
    prog, = static.forward.programs.values()
    graphed = prog.graph is not None and prog.bwd_graph is not None

    model = bert_model(torch, cfg, seed).train()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = train_step_fn(model, opt)
    refused, message = [], None
    for i in range(3):
        loss = step(xs[i], ys[i])
        try:
            (2.0 * loss).backward()
            refused.append(False)
        except RuntimeError as err:
            message = str(err)
            refused.append("runs its own backward" in message)

    host = bert_model(torch, cfg, seed, device="cpu").train()
    sched = pt.optimizer.lr.LinearWarmup(learning_rate=1e-4, warmup_steps=3,
                                         start_lr=2e-5, end_lr=1e-4)
    opt = pt.optimizer.AdamW(learning_rate=sched,
                             parameters=host.parameters())
    host.to("cuda")
    lr_device_before = str(opt._learning_rate.device)

    @pt.jit.to_static
    def lr_step(x, y):
        loss = host(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.float(), opt._learning_rate * 1.0
    lrs, want_lrs = [], []
    for i in range(5):
        want_lrs.append(float(np.float32(sched())))
        lrs.append(lr_step(xs[i], ys[i])[1].item())
        sched.step()
    lr_prog, = lr_step.programs.values()
    row = {"phase": "to_static_grad",
           "config": "BERT-base v30522 h768 L12 a12 d64 f32, batch 4 x 256",
           "forward_only": {"calls": worst, "rel_l2_tol": OUTER_GRAD_RTOL,
                            "zero_grads": zero_grads,
                            "forward_and_backward_captured": graphed},
           "self_backward_step_refused": refused,
           "refusal": message,
           "lr": {"device_at_build": lr_device_before,
                  "device_after": str(opt._learning_rate.device),
                  "read_back": lrs, "scheduler": want_lrs,
                  "captured": lr_prog.graph is not None}}
    emit(row)
    assert all(w["worst"][1] <= OUTER_GRAD_RTOL
               and w["key_bias_share"][1] <= KEY_BIAS_TOL["float32"]
               for w in worst), \
        worst
    assert not zero_grads and graphed, row
    assert refused == [True] * 3, (refused, message)
    assert lrs == want_lrs and lr_prog.graph is not None, row
    assert lr_device_before == "cpu" and opt._learning_rate.is_cuda
    del eager, static, model, host, opt, step, lr_step
    torch.cuda.empty_cache()
    return row


def phase_cls_train(torch, seed, arch):
    """bench.py's BERT (or ERNIE) lane: the base model (12 layers, hidden
    768, 12 heads) with dropout 0 in bf16, AdamW(1e-4, multi_precision),
    the parity-label stream at 16 x 128 from ``seed``, the step under
    ``to_static`` returning the f32 loss, driven by ``run_steps`` with 64
    steps an execution: 2 warm-up executions, then timed ones up to
    bench's recorded budget (512 steps for BERT, 256 for ERNIE). At s =
    128 attention takes the math path with no mask, as bench's. It runs
    once for each of CLS_WEIGHT_DRAWS weight seeds (``seed``, ``seed`` +
    1, ...) on the same batches; each run's replayed step is profiled.
    Gates: each run one compile in the warm-up, none timed, finite
    losses; the median of the runs' last-32 means below bench's chance
    floor 0.62."""
    from paddle_tpu_torch.text.models import BertConfig, ErnieConfig
    cfg = ErnieConfig() if arch == "ernie" else BertConfig.base()
    cfg.dropout = 0.0
    n_exec = CLS_STEPS[arch] // CLS_SPE
    stacks = [tuple(torch.from_numpy(a).cuda() for a in st)
              for st in cls_stream(seed, n_exec, CLS_SPE, CLS_BATCH, CLS_SEQ,
                                   cfg.vocab_size)]
    rows = [cls_run(torch, arch, cfg, stacks, seed, w)
            for w in range(seed, seed + CLS_WEIGHT_DRAWS)]
    means = [r[f"last{CLS_WINDOW}_mean"] for r in rows]
    median = float(np.median(means))
    emit({"phase": f"{arch}_floor", "data_seed": seed,
          "weight_seeds": [r["weight_seed"] for r in rows],
          f"last{CLS_WINDOW}_means": means, "median": median,
          "chance_floor": CLS_FLOOR})
    assert median < CLS_FLOOR, means
    del stacks
    torch.cuda.empty_cache()
    return rows


def cls_run(torch, arch, cfg, stacks, seed, weight_seed):
    """One run of the BERT (or ERNIE) lane from the weights of
    ``weight_seed`` on ``stacks`` (one (ids, labels) pair an execution),
    with its per-run gates; its row carries the last-32 mean."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    steps = CLS_STEPS[arch]
    n_exec = len(stacks)
    # an earlier model in a reference cycle (to_static(layer) binds the
    # layer's forward to a program that holds the layer) keeps its device
    # memory until the cycle collector runs
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = bert_model(torch, cfg, weight_seed, arch=arch)
    model.bfloat16()
    model.train()
    build_s = time.perf_counter() - t0
    opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                             parameters=model.parameters())
    step = CompiledTrainStep(train_step_fn(model, opt), label=f"{arch}_base")
    launch_counts.clear()
    reset_compile_stats()
    curve = []
    t0 = time.perf_counter()
    for e in range(2):
        curve.append(step.run_steps(*stacks[e]))
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    warm = compile_stats()
    reset_compile_stats()
    t0 = time.perf_counter()
    for e in range(2, n_exec):
        curve.append(step.run_steps(*stacks[e]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    timed = compile_stats()
    flash = {n: launch_counts[n] for n in KERNEL_NAMES}
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(curve).tolist()
    timed_steps = (n_exec - 2) * CLS_SPE
    step_ms = seconds / timed_steps * 1e3
    x, y = stacks[-1][0][-1], stacks[-1][1][-1]
    trace, wall_s, _, prof = profiled(torch, lambda: step(x, y), 1)
    emit_profile(trace, wall_s, f"{arch}_train_replay", 1, top=10)
    last = float(np.mean(losses[-CLS_WINDOW:]))
    name = "ERNIE-base v18000" if arch == "ernie" else "BERT-base v30522"
    row = {"phase": f"{arch}_train", "dtype": "bfloat16",
           "config": f"{name} h768 L12 a12 d64, 2 classes, dropout 0",
           "optimizer": "AdamW lr 1e-4 multi_precision (f32 masters)",
           "data_seed": seed, "weight_seed": weight_seed,
           "batch": [CLS_BATCH, CLS_SEQ], "steps_per_execution": CLS_SPE,
           "executions": n_exec, "recorded_steps": len(losses),
           "timed_steps": timed_steps, "model_build_s": build_s,
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "warmup_s": warmup_s, "step_ms": step_ms,
           "tokens_per_s": CLS_BATCH * CLS_SEQ * timed_steps / seconds,
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3,
                              "busy_share": prof["device_ms"]
                              / (wall_s * 1e3)},
           "unprofiled_busy_share": prof["device_ms"] / step_ms,
           "peak_mem_bytes": peak, "flash_launches": flash,
           "attention_path": "math (s = 128 < 256)",
           "loss_first": losses[0], "loss_every_16th": losses[::16],
           f"last{CLS_WINDOW}_mean": last, "chance_floor": CLS_FLOOR}
    emit(row)
    assert warm["compiles"] == 1 and timed == {
        "compiles": 0, "cache_hits": timed_steps, "retrace_warnings": 0}, \
        (warm, timed)
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert all(c == 0 for c in flash.values()), flash
    del model, opt, step
    torch.cuda.empty_cache()
    return row


def phase_bert_flash(torch, seed):
    """BERT-base at 8 x 512, dropout 0, no mask, where attention takes B1,
    B2 and B3 non-causal: (a) one f32 training step, kernel path (the SIMT
    variants) against the math path; (b) the same weights in bf16, the
    tensor-core kernel path against the f32 truth, no further from it than
    twice the bf16 math path; (c) eval-mode f32 logits of a few batches,
    kernel path against math path, and each path's latency in f32 and
    bf16; (d) a captured bf16 training step, 16 timed replays on each
    path, one replay of each profiled (B1, B2 and B3 counted by kernel
    name: 12 each on the kernel path)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.jit.compiled_step import CompiledTrainStep
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.text.models import BertConfig
    cfg = BertConfig.base()
    cfg.dropout = 0.0
    b, s = BERT_FLASH_SHAPE[:2]
    n = cfg.num_layers
    variants = {dt: [fa.variant_counter(k, dt) for k in KERNEL_NAMES]
                for dt in (torch.bfloat16, torch.float32)}
    warmup = 3
    (xs, ys), = cls_stream(seed + 5, 1, warmup + BERT_FLASH_REPLAYS + 1, b,
                           s, cfg.vocab_size)
    xs, ys = torch.from_numpy(xs).cuda(), torch.from_numpy(ys).cuda()
    config = f"BERT-base v30522 h768 L12 a12 d64, batch {b} x {s}"
    torch.cuda.empty_cache()

    # (a) f32, kernel path against math path
    model = bert_model(torch, cfg, seed).train()
    launch_counts.clear()
    k_loss, k_grads = loss_and_grads(model, xs[0], ys[0])
    f32_launches = {k: launch_counts[k]
                    for k in (*variants[torch.float32],
                              *variants[torch.bfloat16])}
    set_bert_flash(model, False)
    launch_counts.clear()
    m_loss, m_grads = loss_and_grads(model, xs[0], ys[0])
    m_launches = sum(launch_counts[k] for k in KERNEL_NAMES)
    gaps = bert_grad_gaps(torch, k_grads, m_grads)
    check = {"phase": "bert_flash", "part": "f32 step", "config": config,
             "loss_kernel_path": k_loss, "loss_math_path": m_loss,
             "loss_rel_gap": abs(k_loss - m_loss) / abs(m_loss),
             "loss_rtol": TRAIN_LOSS_RTOL, "grad_rel_l2_worst": gaps[:3],
             "grad_rel_l2_median": gaps[len(gaps) // 2][1],
             "grad_rel_l2_tol": TRAIN_GRAD_RTOL,
             "kernel_path_variant_launches": f32_launches,
             "math_path_launches": m_launches,
             "key_bias_share": {"kernel": key_bias_share(k_grads),
                                "math": key_bias_share(m_grads),
                                "tol": KEY_BIAS_TOL["float32"]}}
    emit(check)
    assert all(check["key_bias_share"][p][1] <= KEY_BIAS_TOL["float32"]
               for p in ("kernel", "math")), check
    assert all(f32_launches[k] == n for k in variants[torch.float32])
    assert all(f32_launches[k] == 0 for k in variants[torch.bfloat16])
    assert m_launches == 0
    assert check["loss_rel_gap"] <= TRAIN_LOSS_RTOL, check
    assert gaps[0][1] <= TRAIN_GRAD_RTOL, check
    del k_grads

    # (c) eval-mode logits and latency, f32 and then bf16
    def infer(on):
        """The logits of 4 batches and their host-clock ms per batch."""
        set_bert_flash(model, on)
        with torch.inference_mode():
            model(xs[1])                                # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = [model(xs[i]) for i in range(1, 5)]
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / 4 * 1e3
    model.eval()
    infer_row = {"phase": "bert_flash", "part": "inference",
                 "config": config, "batches": 4, "logits_tol": BERT_LOGIT_TOL}
    k_logits, infer_row["f32_kernel_ms"] = infer(True)
    m_logits, infer_row["f32_math_ms"] = infer(False)
    infer_row["f32_logits_max_abs_gap"] = max(
        (a - c).abs().max().item() for a, c in zip(k_logits, m_logits))

    # (b) the same weights in bf16 against the f32 truth
    model.train()
    bf16 = bf16_check(torch, model, xs[0], ys[0], m_loss, m_grads, variants,
                      path=set_bert_flash, n_layers=n,
                      config=config + " (bert_flash)", gaps=bert_grad_gaps,
                      zero_share=key_bias_share)
    model.eval()
    k_logits, infer_row["bf16_kernel_ms"] = infer(True)
    m_logits, infer_row["bf16_math_ms"] = infer(False)
    infer_row["bf16_logits_max_abs_gap"] = max(
        (a.float() - c.float()).abs().max().item()
        for a, c in zip(k_logits, m_logits))
    emit(infer_row)
    assert infer_row["f32_logits_max_abs_gap"] <= BERT_LOGIT_TOL, infer_row
    del model, m_grads, k_logits, m_logits
    torch.cuda.empty_cache()

    # (d) the captured bf16 step on each path, from the same weights
    steps = {}
    for on in (True, False):
        model = bert_model(torch, cfg, seed)
        model.bfloat16()
        model.train()
        set_bert_flash(model, on)
        opt = pt.optimizer.AdamW(learning_rate=1e-4, multi_precision=True,
                                 parameters=model.parameters())
        step = CompiledTrainStep(train_step_fn(model, opt),
                                 label=f"bert_flash_{on}")
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        launch_counts.clear()
        losses = [step(xs[i], ys[i]) for i in range(warmup)]
        capture_launches = {k: launch_counts[k]
                            for k in variants[torch.bfloat16]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(warmup, warmup + BERT_FLASH_REPLAYS):
            losses.append(step(xs[i], ys[i]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        i = warmup + BERT_FLASH_REPLAYS
        trace, wall_s, _, prof = profiled(
            torch, lambda: step(xs[i], ys[i]), 1,
            expect={k: n if on else 0 for k in TC_KERNEL_NAMES})
        emit_profile(trace, wall_s, "bert_flash_replay_"
                     + ("kernel_path" if on else "math_path"), 1, top=8)
        step_ms = seconds / BERT_FLASH_REPLAYS * 1e3
        steps[on] = {"step_ms": step_ms,
                     "tokens_per_s": b * s * BERT_FLASH_REPLAYS / seconds,
                     "capture_launches": capture_launches,
                     "replay_profile": {**prof, "wall_ms": wall_s * 1e3},
                     "unprofiled_busy_share": prof["device_ms"] / step_ms,
                     "peak_mem_bytes": peak,
                     "losses": [loss.item() for loss in losses]}
        del model, opt, step
        torch.cuda.empty_cache()
    kernel, math = steps[True], steps[False]
    row = {"phase": "bert_flash", "part": "captured bf16 step",
           "config": config, "replays_timed": BERT_FLASH_REPLAYS,
           "kernel_path": kernel, "math_path": math,
           "speedup_vs_math": math["step_ms"] / kernel["step_ms"]}
    emit(row)
    per_replay = kernel["replay_profile"]["flash_launches"]
    assert per_replay == {k: n for k in TC_KERNEL_NAMES}, per_replay
    assert all(c == 0 for c in
               math["replay_profile"]["flash_launches"].values()), math
    # the capture passes through the wrappers once: discovery + capture
    assert all(c == 2 * n for c in kernel["capture_launches"].values())
    for path in (kernel, math):
        assert all(np.isfinite(path["losses"])), path["losses"]
    return {"f32": check, "bf16": bf16, "inference": infer_row,
            "captured": row,
            "launches": {k: bf16["kernel_path_launches"].get(k, 0)
                         for k in variants[torch.bfloat16]}}


# --- the conv net slice: ResNet and LeNet --------------------------------

def vision_pair(torch, make, seed):
    """The same model (``make(device)``, weights from ``seed``) on the card
    and on the host: the port's layers draw on the generator's device (the
    host), so both get the same weights."""
    import paddle_tpu_torch as pt
    card = make("cuda", pt.make_generator(seed))
    host = make("cpu", pt.make_generator(seed))
    return card, host


def step_state(torch, model, opt, x, y):
    """One training step of ``model``: the f32 loss, every grad and every
    running statistic after the forward, then the optimizer's update."""
    import paddle_tpu_torch.nn.functional as F
    loss = F.cross_entropy(model(x).float(), y)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    opt.step()
    opt.clear_grad()
    return loss.item(), grads, stats


def max_rel_gap(a, b):
    """max |a - b| / max |b| over two tensors, in f32 on the host."""
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def phase_vision_reference(torch, seed):
    """A ResNet-18 (10 classes, NHWC, the space-to-depth stem, fused conv
    + BN) at 2 x 3 x 64 x 64 and a LeNet at 8 x 1 x 28 x 28 on the card
    are held against the same models on the host (whose path the host
    tests hold against paddle_tpu), in f32 with TF32 off: one Momentum
    step (the loss, every grad, the running statistics the forward moved)
    and then the eval logits of the updated weights."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import LeNet, resnet18
    rng = np.random.RandomState(seed + 11)
    cases = {
        "resnet18": (lambda d, g: resnet18(
            num_classes=10, data_format="NHWC", stem="space_to_depth",
            device=d, generator=g),
            rng.randn(2, 64, 64, 3).astype("float32"),
            rng.randint(0, 10, (2,))),
        "lenet": (lambda d, g: LeNet(device=d, generator=g),
                  rng.randn(8, 1, 28, 28).astype("float32"),
                  rng.randint(0, 10, (8,))),
    }
    rows = {}
    for name, (make, x, y) in cases.items():
        card, host = vision_pair(torch, make, seed)
        got, want = [], []
        for model, dev, out in ((card, "cuda", got), (host, "cpu", want)):
            model.train()
            opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                        parameters=model.parameters())
            xt = torch.tensor(x, device=dev)
            out.extend(step_state(torch, model, opt, xt,
                                  torch.tensor(y, device=dev)))
            model.eval()
            with torch.no_grad():
                out.append(model(xt))
        grads = grad_gaps(torch, got[1], want[1])
        stats = sorted(((n, max_rel_gap(got[2][n], want[2][n]))
                        for n in want[2]), key=lambda t: -t[1])
        row = {"phase": "vision_reference", "model": name,
               "loss": got[0], "host_loss": want[0],
               "loss_rel_gap": abs(got[0] - want[0]) / abs(want[0]),
               "worst_grads": grads[:3], "grads": len(grads),
               "worst_stats": stats[:3], "stats": len(stats),
               "eval_logits_gap": max_rel_gap(got[3], want[3]),
               "tol": VISION_TOL}
        emit(row)
        assert row["loss_rel_gap"] <= VISION_TOL["loss"], row
        assert grads[0][1] <= VISION_TOL["grad"], row
        assert not stats or stats[0][1] <= VISION_TOL["stats"], row
        assert row["eval_logits_gap"] <= VISION_TOL["logits"], row
        rows[name] = row
    return rows


def image_stream(torch, seed, stacks, spe, batch, shape, classes, scale,
                 noise, dtype):
    """bench.py's class-prototype stream (bench_resnet50, bench_lenet),
    made on the card from a seeded CUDA generator: ``classes`` prototype
    images of ``shape`` from N(0, 1), and each batch's image = ``scale`` *
    prototype[label] + ``noise`` * N(0, 1), labels uniform. Returns
    ``stacks`` (images, labels) pairs with a leading axis of ``spe``
    batches."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    protos = torch.randn((classes, *shape), generator=g, device="cuda")
    out = []
    for _ in range(stacks):
        ys = torch.randint(0, classes, (spe, batch), generator=g,
                           device="cuda")
        xs = torch.empty((spe, batch, *shape), dtype=dtype, device="cuda")
        for i in range(spe):
            xs[i] = scale * protos[ys[i]] + noise * torch.randn(
                (batch, *shape), generator=g, device="cuda")
        out.append((xs, ys))
    del protos
    return out


def conv_step_fn(model, opt):
    """bench.py's conv net step through the port: the f32 cross-entropy of
    the logits, backward, the optimizer's update."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.nn.functional as F

    @pt.jit.to_static
    def step(x, y):
        loss = F.cross_entropy(model(x).float(), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss
    return step


def host_top(prof, top=8):
    """The host ops of a profile that took the most host time (self CPU
    ms, calls), for where the host bounds a path."""
    ops = sorted((e for e in prof.key_averages()
                  if e.self_cpu_time_total > 0),
                 key=lambda e: -e.self_cpu_time_total)
    return [{"op": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
             "calls": e.count} for e in ops[:top]]


def kernel_classes(prof):
    """Device ms and launches of a profile's kernels by kind: cuDNN's and
    CUTLASS's convolutions, copies (each copy kernel listed), reductions,
    the other elementwise kernels."""
    classes, copies = {}, []
    for us, count, name in kernel_times(prof):
        low = name.lower()
        if any(k in low for k in ("conv", "cudnn", "xmma", "cutlass",
                                  "wgrad", "dgrad", "implicit", "gemm")):
            kind = "conv_gemm"
        elif "copy" in low or "memcpy" in low:
            kind = "copy"
            copies.append({"kernel": name[:150], "ms": us / 1e3,
                           "count": count})
        elif "reduce" in low:
            kind = "reduce"
        else:
            kind = "elementwise_other"
        ms, n = classes.get(kind, (0.0, 0))
        classes[kind] = (ms + us / 1e3, n + count)
    return {**{k: {"ms": ms, "launches": n}
               for k, (ms, n) in classes.items()}, "copy_kernels": copies}


def train_lane(torch, label, model, opt, stacks, warmup_exec, timed_exec,
               watch):
    """Drive a captured conv net step through ``run_steps``, one staged
    stack per execution (rotating): ``warmup_exec`` executions, then
    ``timed_exec`` timed ones, with the launch counts reset just before
    and read just after, and the compile counters of each window. The
    buffers named in ``watch`` are read before and after the timed
    window. Returns (losses, seconds, warm, timed, flash launches,
    watched (before, after), the step)."""
    from paddle_tpu_torch.jit.compiled_step import (CompiledTrainStep,
                                                    compile_stats,
                                                    reset_compile_stats)
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    step = CompiledTrainStep(conv_step_fn(model, opt), label=label)
    buffers = dict(model.named_buffers())
    launch_counts.clear()
    reset_compile_stats()
    curve = []
    for e in range(warmup_exec):
        curve.append(step.run_steps(*stacks[e % len(stacks)]))
    torch.cuda.synchronize()
    warm = compile_stats()
    reset_compile_stats()
    before = {n: buffers[n].float().clone() for n in watch}
    t0 = time.perf_counter()
    for e in range(warmup_exec, warmup_exec + timed_exec):
        curve.append(step.run_steps(*stacks[e % len(stacks)]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    timed = compile_stats()
    after = {n: buffers[n].float().clone() for n in watch}
    flash = {n: launch_counts[n] for n in KERNEL_NAMES}
    return (torch.cat(curve).tolist(), seconds, warm, timed, flash,
            (before, after), step)


def phase_resnet_train(torch, seed):
    """bench.py's ResNet-50 lane (bench_resnet50) at full width and depth:
    ResNet-50 (1000 classes) with bf16 parameters and buffers, NHWC, the
    space-to-depth stem, fused conv + BN, Momentum(0.1, 0.9), batch 128 at
    224 x 224 from bench's prototype stream (made on the card), the step
    captured and driven by run_steps K = 32: 2 warm-up and 12 timed
    executions over 3 staged stacks (96 distinct batches), 448 recorded
    steps. Gates: last-32 mean below bench's chance floor 6.71, 1 compile
    in the warm-up and none timed, the running statistics moved over the
    timed window, no flash kernel launched. Prints step ms, images/s, MFU
    (3 x 4.09 GFLOP an image, bench.py:903-904, against the dense bf16
    peak), peak memory and one replay's profile."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import resnet50
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stacks = image_stream(torch, seed, RESNET_STACKS, RESNET_SPE,
                          RESNET_BATCH, (RESNET_HW, RESNET_HW, 3), 1000,
                          RESNET_PROTO_SCALE, 1.0, torch.bfloat16)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    model = resnet50(data_format="NHWC", stem="space_to_depth",
                     device="cuda", generator=pt.make_generator(seed))
    model.bfloat16()
    model.train()
    opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                parameters=model.parameters())
    watch = ("bn1._mean", "layer4.2.bn3._variance")
    losses, seconds, warm, timed, flash, (before, after), step = train_lane(
        torch, "resnet50", model, opt, stacks, RESNET_WARMUP_EXEC,
        RESNET_TIMED_EXEC, watch)
    peak = torch.cuda.max_memory_allocated()
    timed_steps = RESNET_TIMED_EXEC * RESNET_SPE
    step_ms = seconds / timed_steps * 1e3
    ips = RESNET_BATCH * timed_steps / seconds
    moved = {n: (after[n] - before[n]).abs().max().item() for n in watch}
    x, y = stacks[-1][0][-1], stacks[-1][1][-1]
    trace, wall_s, _, prof = profiled(torch, lambda: step(x, y), 1)
    emit_profile(trace, wall_s, "resnet50_train_replay", 1, top=15,
                 by_class=kernel_classes(trace))
    last = float(np.mean(losses[-RESNET_WINDOW:]))
    n_params = sum(1 for _ in model.parameters())
    row = {"phase": "resnet_train", "dtype": "bfloat16",
           "config": "ResNet-50 1000 classes, NHWC, space-to-depth stem, "
                     "fused conv+BN", "parameters": n_params,
           "optimizer": "Momentum lr 0.1 momentum 0.9",
           "batch": [RESNET_BATCH, RESNET_HW, RESNET_HW, 3],
           "steps_per_execution": RESNET_SPE,
           "executions": RESNET_WARMUP_EXEC + RESNET_TIMED_EXEC,
           "distinct_batches": RESNET_SPE * RESNET_STACKS,
           "recorded_steps": len(losses), "timed_steps": timed_steps,
           "data": "prototype stream made on the card (torch CUDA "
                   "generator)", "data_s": data_s,
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "step_ms": step_ms, "images_per_s": ips,
           "mfu": ips * RESNET_TRAIN_FLOP / PEAK_FLOPS["bfloat16"],
           "replay_profile": {**prof, "wall_ms": wall_s * 1e3,
                              "busy_share": prof["device_ms"]
                              / (wall_s * 1e3)},
           "unprofiled_busy_share": prof["device_ms"] / step_ms,
           "peak_mem_bytes": peak, "flash_launches": flash,
           "running_stats_moved": moved,
           "loss_first": losses[0], "loss_every_32nd": losses[::32],
           f"last{RESNET_WINDOW}_mean": last, "chance_floor": RESNET_FLOOR}
    emit(row)
    assert warm["compiles"] == 1 and timed == {
        "compiles": 0, "cache_hits": timed_steps, "retrace_warnings": 0}, \
        (warm, timed)
    assert len(losses) == RESNET_RECORDED and all(np.isfinite(losses))
    assert last < RESNET_FLOOR, row
    assert all(v > 0 for v in moved.values()), moved
    assert all(c == 0 for c in flash.values()), flash
    del stacks, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    return row, model


def one_step(torch, model, x, y):
    """Eager forward and backward of the f32 loss: (loss, {name: grad})."""
    import paddle_tpu_torch.nn.functional as F
    loss = F.cross_entropy(model(x).float(), y)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def phase_resnet_fused(torch, seed):
    """The fused conv + BN op on the card. (a) One f32 step (TF32 off) of
    ResNet-50 at 32 x 224 x 224, NHWC, the space-to-depth stem, fused
    against unfused (``fused_conv_bn=False``) on the same weights and
    batch: the loss within FUSED_LOSS_RTOL, every grad within
    FUSED_GRAD_RTOL relative L2. (b) bf16 at batch 128, fused against
    unfused: the peak memory of an eager step over the memory held before
    it, and the eager step's time (3 steps after a warm-up one)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import resnet50

    def build(fused, dtype):
        m = resnet50(data_format="NHWC", stem="space_to_depth",
                     fused_conv_bn=fused, device="cuda",
                     generator=pt.make_generator(seed))
        return (m.bfloat16() if dtype == torch.bfloat16 else m).train()

    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    x = torch.randn((FUSED_F32_BATCH, RESNET_HW, RESNET_HW, 3), generator=g,
                    device="cuda")
    y = torch.randint(0, 1000, (FUSED_F32_BATCH,), generator=g,
                      device="cuda")
    res = {}
    for fused in (True, False):
        model = build(fused, torch.float32)
        res[fused] = one_step(torch, model, x, y)
        del model
    gaps = grad_gaps(torch, res[True][1], res[False][1])
    loss_gap = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    del res
    gc.collect()
    torch.cuda.empty_cache()

    xb = torch.randn((RESNET_BATCH, RESNET_HW, RESNET_HW, 3), generator=g,
                     device="cuda").to(torch.bfloat16)
    yb = torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device="cuda")
    mem = {}
    for fused in (True, False):
        model = build(fused, torch.bfloat16)
        opt = pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                    parameters=model.parameters())
        step = conv_step_fn(model, opt)
        pt.set_flags({"FLAGS_compiled_step": 0})
        try:
            step(xb, yb)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            step(xb, yb)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            t0 = time.perf_counter()
            for _ in range(3):
                step(xb, yb)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 3 * 1e3
        finally:
            pt.set_flags({"FLAGS_compiled_step": 1})
        mem["fused" if fused else "unfused"] = {
            "step_peak_over_held_bytes": peak, "held_bytes": held,
            "eager_step_ms": ms}
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    row = {"phase": "resnet_fused",
           "f32_step": {"batch": [FUSED_F32_BATCH, RESNET_HW, RESNET_HW, 3],
                        "loss_rel_gap": loss_gap,
                        "loss_rtol": FUSED_LOSS_RTOL,
                        "worst_grads": gaps[:5],
                        "median_grad_gap": float(np.median(
                            [gap for _, gap in gaps])),
                        "grad_rtol": FUSED_GRAD_RTOL},
           "bf16_b128": mem,
           "residual_bytes_saved": mem["unfused"]["step_peak_over_held_bytes"]
           - mem["fused"]["step_peak_over_held_bytes"]}
    emit(row)
    assert loss_gap <= FUSED_LOSS_RTOL, row
    assert gaps[0][1] <= FUSED_GRAD_RTOL, row
    return row


def phase_resnet_eval(torch, seed, trained):
    """ResNet-50 in eval mode, bf16, on the weights and running statistics
    the resnet_train phase left: the fused path (fused_conv_bn's folded-
    statistics branch) against the unfused path (BatchNorm in eval), at
    batch 128 and at batch 1. Both are held to the same weights in f32 on
    the unfused path: the fused path's relative L2 gap at most
    EVAL_FACTOR x the unfused path's + EVAL_SLACK. Latency (host clock
    ending in a synchronize, mean of EVAL_CALLS calls), device time (None
    where the profiler lost kernels and queued events could not stand in)
    and the host ops that took the most host time."""
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAMES
    from paddle_tpu_torch.vision.models import resnet50
    state = trained.state_dict()
    paths = {"fused": trained.eval()}
    for name, fused, dtype in (("unfused", False, torch.bfloat16),
                               ("unfused_f32", False, torch.float32)):
        m = resnet50(data_format="NHWC", stem="space_to_depth",
                     fused_conv_bn=fused, device="cuda")
        if dtype == torch.bfloat16:
            m.bfloat16()
        pt.load_numpy_state_dict(m, state)
        paths[name] = m.eval()
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    x = torch.randn((RESNET_BATCH, RESNET_HW, RESNET_HW, 3), generator=g,
                    device="cuda").to(torch.bfloat16)
    rows = []
    launch_counts.clear()
    with torch.no_grad():
        for batch in (RESNET_BATCH, 1):
            xb = x[:batch]
            out = {k: m(xb if k != "unfused_f32" else xb.float()).float()
                   for k, m in paths.items()}
            truth = out["unfused_f32"]
            gap = {k: rel_l2(out[k], truth) for k in ("fused", "unfused")}
            row = {"phase": "resnet_eval", "batch": batch,
                   "dtype": "bfloat16",
                   "rel_l2_to_f32": gap,
                   "fused_vs_unfused_rel_l2": rel_l2(out["fused"],
                                                     out["unfused"]),
                   "argmax_agree": (out["fused"].argmax(-1)
                                    == out["unfused"].argmax(-1))
                   .float().mean().item(),
                   "tol": {"factor": EVAL_FACTOR, "slack": EVAL_SLACK}}
            for k in ("fused", "unfused"):
                m = paths[k]
                for _ in range(3):
                    m(xb)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(EVAL_CALLS):
                    m(xb)
                torch.cuda.synchronize()
                latency = (time.perf_counter() - t0) / EVAL_CALLS * 1e3
                dev, launches = device_profile(torch, lambda: m(xb), reps=2,
                                               warmup=1)
                if launches is None and \
                        not TIMING["queued_events"][-1]["queue_held"]:
                    # the profiles lost kernels and the host did not stay
                    # ahead of the queued calls: no device time
                    dev = None
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    m(xb)
                    torch.cuda.synchronize()
                row[k] = {"latency_ms": latency, "device_ms": dev,
                          "kernels": launches, "host_top": host_top(prof)}
            row["latency_ms"] = row["fused"]["latency_ms"]
            row["images_per_s"] = batch / row["latency_ms"] * 1e3
            emit(row)
            assert gap["fused"] <= EVAL_FACTOR * gap["unfused"] \
                + EVAL_SLACK, row
            rows.append(row)
    flash = {n: launch_counts[n] for n in KERNEL_NAMES}
    assert all(c == 0 for c in flash.values()), flash
    del paths, trained
    gc.collect()
    torch.cuda.empty_cache()
    return rows, flash


def phase_lenet_train(torch, seed):
    """bench.py's LeNet lane (bench_lenet): LeNet in f32, Adam(1e-3),
    batch 256 of 1 x 28 x 28 prototype images (10 classes, noise 0.3,
    made on the card), the step captured and driven by run_steps K = 32:
    2 warm-up executions and 1 timed, each on its own stack (96 distinct
    batches, 96 recorded steps). Gates: last-32 mean below bench's floor
    1.80, 1 compile in the warm-up and none timed, no flash kernel."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import LeNet
    stacks = image_stream(torch, seed, 3, LENET_SPE, LENET_BATCH,
                          (1, 28, 28), 10, 1.0, 0.3, torch.float32)
    model = LeNet(device="cuda", generator=pt.make_generator(seed)).train()
    opt = pt.optimizer.Adam(learning_rate=1e-3,
                            parameters=model.parameters())
    losses, seconds, warm, timed, flash, _, _ = train_lane(
        torch, "lenet", model, opt, stacks, 2, 1, ())
    last = float(np.mean(losses[-LENET_WINDOW:]))
    row = {"phase": "lenet_train", "dtype": "float32",
           "optimizer": "Adam lr 1e-3", "batch": [LENET_BATCH, 1, 28, 28],
           "steps_per_execution": LENET_SPE, "recorded_steps": len(losses),
           "compile_stats_warmup": warm, "compile_stats_timed": timed,
           "step_ms": seconds / LENET_SPE * 1e3,
           "images_per_s": LENET_BATCH * LENET_SPE / seconds,
           "flash_launches": flash, "loss_first": losses[0],
           "loss_every_8th": losses[::8],
           f"last{LENET_WINDOW}_mean": last, "chance_floor": LENET_FLOOR}
    emit(row)
    assert warm["compiles"] == 1 and timed == {
        "compiles": 0, "cache_hits": LENET_SPE, "retrace_warnings": 0}, \
        (warm, timed)
    assert len(losses) == 3 * LENET_SPE and all(np.isfinite(losses))
    assert last < LENET_FLOOR, row
    assert all(c == 0 for c in flash.values()), flash
    del stacks, model, opt
    torch.cuda.empty_cache()
    return row


def kernel_entries(fa, rows, bwd_rows, serve, train, compiled, amp, bert,
                   vision):
    """The kernels line: each kernel variant at the shape of the main path
    that runs it, with its launches on that path. bf16 (tensor cores):
    B1 at the prefill shape (and its training-shape time), B2 and B3 at
    the training shape, each with its launches per replayed step of the
    captured step (compiled_train) and of the amp + recompute step
    (amp_train), counted by kernel name; f32 (SIMT): the f32 correctness
    runs at full width, timed at (4, 512, 16, 64) causal; then B1, B2 and
    B3 tc_bf16 again, non-causal at BERT's shape (8, 512, 12, 64), with
    their launches in a bf16 BERT-base step (bert_flash) and per replay
    of its captured step. Every entry also carries its launches on the
    conv net paths (``vision``: {path: {kernel: launches}}), all 0."""
    src = "paddle_tpu_torch/csrc/"
    ref = "paddle_tpu/ops/pallas/flash_attention.py:"
    keys = ("ms", "wall_ms", "plain_ms", "library_ms", "library_wall_ms",
            "bound_by", "shape", "dtype", "causal", "variant",
            "share_of_bound", "factor_vs_library")

    def entry(name, source, line, row, launches, err, **extra):
        kernel = name.split(".")[0]
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": ref + str(line), "launches": launches,
                "max_abs_err": err, "bound_ms": row["bound_us"] / 1e3,
                **{k: row[k] for k in keys},
                "launches_conv_nets": {path: counts[kernel]
                                       for path, counts in vision.items()},
                **extra}
    fwd_tc, fwd_train, fwd_simt = rows[0], rows[2], rows[6]
    dkv_tc, dkv_simt = bwd_rows["dkv"][0], bwd_rows["dkv"][4]
    dq_tc, dq_simt = bwd_rows["dq"][0], bwd_rows["dq"][4]
    tc, simt = fa.TC, fa.SIMT
    scope = {"plain_scope": dkv_tc["plain_scope"],
             "library_scope": dkv_tc["library_scope"]}

    def captured(name):
        return {"launches_per_replay_compiled_train":
                    compiled["replay_profile"]["flash_launches"][name],
                "launches_per_step_amp_train":
                    amp["replay_profile"]["flash_launches"][name]}
    return [
        entry(f"{fa.KERNEL_NAME}.{tc}", "flash_attn_fwd_tc.cu", 114, fwd_tc,
              serve["bfloat16"]["flash_variant_launches"],
              fwd_tc["max_abs_err_o"], rel_l2=fwd_tc["rel_l2_o"],
              main_path="bf16 prefill (serve)",
              launches_train=train["launches"][f"{fa.KERNEL_NAME}.{tc}"],
              train_shape_ms=fwd_train["ms"],
              train_shape_ms_with_f32_out=fwd_train["ms_with_f32_out"],
              train_shape_library_ms=fwd_train["library_ms"],
              **captured(fa.KERNEL_NAME)),
        entry(f"{fa.KERNEL_NAME}.{simt}", "flash_attn_fwd.cu", 114, fwd_simt,
              serve["float32"]["flash_variant_launches"],
              fwd_simt["max_abs_err_o"],
              main_path="f32 prefill (serve, correctness run)"),
        entry(f"{fa.DKV_KERNEL}.{tc}", "flash_attn_dkv_tc.cu", 200, dkv_tc,
              train["launches"][f"{fa.DKV_KERNEL}.{tc}"],
              dkv_tc["max_abs_err"],
              rel_l2={o: g["rel_l2"]
                      for o, g in dkv_tc["rel_l2_by_output"].items()},
              main_path="bf16 training step (train)",
              launches_per_step=train["launches_per_step"][fa.DKV_KERNEL],
              **captured(fa.DKV_KERNEL), **scope),
        entry(f"{fa.DKV_KERNEL}.{simt}", "flash_attn_bwd.cu", 200, dkv_simt,
              train["f32_launches"][f"{fa.DKV_KERNEL}.{simt}"],
              dkv_simt["max_abs_err"],
              main_path="f32 training step (train_check, correctness run)",
              **scope),
        entry(f"{fa.DQ_KERNEL}.{tc}", "flash_attn_dq_tc.cu", 247, dq_tc,
              train["launches"][f"{fa.DQ_KERNEL}.{tc}"],
              dq_tc["max_abs_err"],
              rel_l2={o: g["rel_l2"]
                      for o, g in dq_tc["rel_l2_by_output"].items()},
              main_path="bf16 training step (train)",
              launches_per_step=train["launches_per_step"][fa.DQ_KERNEL],
              **captured(fa.DQ_KERNEL), **scope),
        entry(f"{fa.DQ_KERNEL}.{simt}", "flash_attn_bwd.cu", 247, dq_simt,
              train["f32_launches"][f"{fa.DQ_KERNEL}.{simt}"],
              dq_simt["max_abs_err"],
              main_path="f32 training step (train_check, correctness run)",
              **scope),
        *bert_entries(fa, entry, rows[-1], bwd_rows, bert, scope)]


def bert_entries(fa, entry, fwd, bwd_rows, bert, scope):
    """The kernels line's rows of B1, B2 and B3 tc_bf16 at BERT's shape,
    non-causal."""
    replay = bert["captured"]["kernel_path"]["replay_profile"]
    tc = fa.TC

    def one(kernel, source, line, row, err, **extra):
        return entry(f"{kernel}.{tc}.bert", source, line, row,
                     bert["launches"][f"{kernel}.{tc}"], err,
                     main_path="BERT-base bf16 training step at 8 x 512, "
                               "non-causal (bert_flash)",
                     launches_per_replay_bert_flash=replay[
                         "flash_launches"][kernel], **extra)
    dkv, dq = bwd_rows["dkv"][-1], bwd_rows["dq"][-1]
    whole = bwd_rows["whole"][-1]
    return [
        # the training step's B1 also writes O in f32: its time and bound
        one(fa.KERNEL_NAME, "flash_attn_fwd_tc.cu", 114, fwd,
            fwd["max_abs_err_o"], rel_l2=fwd["rel_l2_o"],
            ms=fwd["ms_with_f32_out"],
            bound_ms=fwd["bound_us_with_f32_out"] / 1e3,
            bound_by=fwd["bound_by_with_f32_out"],
            share_of_bound=fwd["bound_us_with_f32_out"] / 1e3
            / fwd["ms_with_f32_out"],
            factor_vs_library=fwd["ms_with_f32_out"] / fwd["library_ms"],
            ms_without_f32_out=fwd["ms"]),
        one(fa.DKV_KERNEL, "flash_attn_dkv_tc.cu", 200, dkv,
            dkv["max_abs_err"],
            rel_l2={o: g["rel_l2"]
                    for o, g in dkv["rel_l2_by_output"].items()},
            whole_backward_ms=whole["ms"],
            whole_backward_bound_ms=whole["bound_us"] / 1e3, **scope),
        one(fa.DQ_KERNEL, "flash_attn_dq_tc.cu", 247, dq, dq["max_abs_err"],
            rel_l2={o: g["rel_l2"]
                    for o, g in dq["rel_l2_by_output"].items()},
            whole_backward_ms=whole["ms"],
            whole_backward_bound_ms=whole["bound_us"] / 1e3, **scope)]


PHASE_GROUPS = ("build", "kernels", "reference", "serve", "train",
                "to_static_grad", "bert", "vision")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASE_GROUPS),
                    help="comma-separated phase groups to run (default: "
                         "all); the kernels line needs all of them")
    args = ap.parse_args()
    run = set(args.phases.split(","))
    unknown = run - set(PHASE_GROUPS)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from "
                 f"{PHASE_GROUPS}")

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device visible; this script runs the "
                 "port on the card and has no host fallback")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "paddle_tpu_torch")):
        sys.exit("chip_smoke: paddle_tpu_torch/ not found beside this "
                 "script; run it from a checkout of the repository")
    sys.path.insert(0, here)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN picks its algorithms by heuristics: no autotuning runs, inside
    # a capture or out of it
    torch.backends.cudnn.benchmark = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "phases": sorted(run)})

    t0 = time.perf_counter()
    out = {}
    if "build" in run:
        phase_build()
    if "kernels" in run:
        out["rows"] = phase_kernels(torch, args.seed)
        out["bwd_rows"] = phase_kernels_bwd(torch, args.seed)
    if "reference" in run:
        phase_reference(torch, args.seed)
        phase_reference_train(torch, args.seed)
    if "serve" in run:
        out["serve"] = phase_serve(torch, args.seed)
    if "train" in run:
        out["train"] = phase_train(torch, args.seed)
        out["compiled"] = phase_compiled_train(torch, args.seed,
                                               out["train"])
        out["amp"] = phase_amp_train(torch, args.seed)
    if "to_static_grad" in run:
        phase_to_static_grad(torch, args.seed)
    if "bert" in run:
        phase_cls_train(torch, args.seed, "bert")
        phase_cls_train(torch, args.seed, "ernie")
        out["bert"] = phase_bert_flash(torch, args.seed)
    if "vision" in run:
        phase_vision_reference(torch, args.seed)
        resnet, trained = phase_resnet_train(torch, args.seed)
        phase_resnet_fused(torch, args.seed)
        _, eval_flash = phase_resnet_eval(torch, args.seed, trained)
        del trained
        lenet = phase_lenet_train(torch, args.seed)
        out["vision"] = {"resnet50_train": resnet["flash_launches"],
                         "resnet50_eval": eval_flash,
                         "lenet_train": lenet["flash_launches"]}

    if run == set(PHASE_GROUPS):
        from paddle_tpu_torch.ops.cuda import flash_attention as fa
        emit({"kernels": kernel_entries(
            fa, out["rows"], out["bwd_rows"], out["serve"], out["train"],
            out["compiled"], out["amp"], out["bert"], out["vision"])})
    emit({"phase": "done", "seconds": time.perf_counter() - t0,
          "timing": TIMING})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
