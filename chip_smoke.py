#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line:

1. build: compile every CUDA source of the port with nvcc (one process per
   source, all at once) and report the time, the libraries and ptxas's
   register/shared-memory lines.
2. kernels: hold each kernel against its plain PyTorch version on the card
   (flash attention B1: causal and not, head dim 64 and 128, bf16 and f32)
   and time kernel, plain version and a library yardstick with CUDA events.
3. serve: GPT-medium at full width (vocab 32000, hidden 1024, 24 layers,
   16 heads, random weights from --seed) serves 4 x 512-token prompts and
   64 greedy KV-cached decode steps in bf16 through the port's entry point,
   with the launch counts reset just before and read just after. The
   kernel path is then compared with the math path (use_flash_attention
   off) in bf16 and, at full width, in f32, where the greedy tokens must
   be identical. Before it, a small GPT on the card is held against the
   same model on the host (whose math path the host tests hold against
   paddle_tpu). The bf16 model is then profiled (torch.profiler) over one
   prefill and 16 decode steps: device time by kernel and busy share.

Then it prints the kernels line ({"kernels": [...]}, with each kernel's
launches on the main path, error, times and bound), the card's name and
power limit from nvidia-smi, and last {"ok": true, "device": {...}}.
Any failed check raises, so the exit code is not 0 and no ok line is
printed. It needs a CUDA card and the repository checkout it lies in.
"""
import argparse
import json
import os
import subprocess
import sys
import time

# H100 SXM dense peaks (NVIDIA data sheet) for the roofline bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

PROMPTS, PROMPT_LEN, DECODE_STEPS = 4, 512, 64
# max |O - plain O| and |LSE - plain LSE| allowed, kernel vs plain on the
# card. bf16: the two round the same f32 value to bf16 and may land one ulp
# apart (2^-7 relative; |O| < 2 for these inputs); f32: sums in another
# order over at most 1024 terms.
KERNEL_TOL = {"bfloat16": (2e-2, 1e-3), "float32": (2e-5, 1e-4)}
# max |logits| gap between the kernel path and the math path at full width:
# bf16 runs round the attention output differently (the math path rounds
# probabilities and scores to bf16) and 24 layers carry the difference
# into logits of magnitude ~3, where a bf16 ulp is 2^-6; f32 differs only
# by summation order.
LOGIT_TOL = {"bfloat16": 0.25, "float32": 1e-3}


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


def flash_bound(b, s, h, d, dtype_name, causal):
    """Least time (ms) for B1's work and what bounds it: q, k, v read once,
    O and LSE written once; 4*B*H*S^2*D flops, halved when causal."""
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4
    flops = 4 * b * h * s * s * d * (0.5 if causal else 1.0)
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
    """q, k, v as the strided views GPTAttention hands the kernel."""
    qkv = torch.randn((b, s, 3, h, d), generator=gen, device="cuda",
                      dtype=torch.float32).to(dtype)
    return qkv.unbind(dim=2)


def phase_kernels(torch, seed):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(4, 512, 16, 64, torch.bfloat16, True),
             (4, 512, 16, 64, torch.bfloat16, False),
             (4, 1024, 16, 64, torch.bfloat16, True),
             (4, 1024, 16, 64, torch.bfloat16, False),
             (2, 1024, 16, 128, torch.bfloat16, True),
             (2, 1024, 16, 128, torch.bfloat16, False),
             (4, 512, 16, 64, torch.float32, True),
             (2, 512, 16, 128, torch.float32, False)]
    rows = []
    for b, s, h, d, dtype, causal in cases:
        dname = str(dtype).split(".")[-1]
        q, k, v = qkv_views(torch, b, s, h, d, dtype, gen)
        scale = 1.0 / d ** 0.5
        out, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                            scale)
        err_o = (out.float() - ref_out.float()).abs().max().item()
        err_l = (lse - ref_lse).abs().max().item()
        assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
        tol_o, tol_l = KERNEL_TOL[dname]
        ms = cuda_time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal, scale))
        plain_ms = cuda_time_ms(torch, lambda: fa.flash_attention_fwd_reference(
            q, k, v, causal, scale), reps=10, warmup=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library_ms = cuda_time_ms(
            torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale))
        bound_ms, bound_by = flash_bound(b, s, h, d, dname, causal)
        row = {"shape": [b, s, h, d], "dtype": dname, "causal": causal,
               "max_abs_err_o": err_o, "max_abs_err_lse": err_l,
               "tol_o": tol_o, "tol_lse": tol_l, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_us": bound_ms * 1e3, "bound_by": bound_by,
               "share_of_bound": bound_ms / ms}
        emit({"phase": "kernels", "kernel": fa.KERNEL_NAME, **row})
        assert err_o <= tol_o and err_l <= tol_l, row
        rows.append(row)
    return rows


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
    from paddle_tpu_torch.ops.cuda.flash_attention import KERNEL_NAME
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
            peak = torch.cuda.max_memory_allocated()
            assert launches == cfg.num_layers, (launches, cfg.num_layers)
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
        kernels = []
        for e in prof.key_averages():
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                kernels.append((us, e.count, e.key))
        kernels.sort(reverse=True)
        device_us = sum(k[0] for k in kernels)
        emit({"phase": "profile", "window": name,
              "steps": 1 if name == "prefill" else decode_steps,
              "wall_ms": wall_s * 1e3, "device_ms": device_us / 1e3,
              "busy_share": device_us / 1e3 / (wall_s * 1e3),
              "kernel_launches": sum(k[1] for k in kernels),
              "top": [{"kernel": k[2][:90], "ms": k[0] / 1e3,
                       "count": k[1]} for k in kernels[:12]]})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})

    phase_build()
    rows = phase_kernels(torch, args.seed)
    phase_reference(torch, args.seed)
    serve = phase_serve(torch, args.seed)

    main_row = rows[0]              # the prefill's shape: 4x512x16x64 bf16
    emit({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "paddle_tpu/ops/pallas/flash_attention.py:114",
        "launches": serve["bfloat16"]["flash_launches"],
        "max_abs_err": main_row["max_abs_err_o"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_us"] / 1e3,
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
