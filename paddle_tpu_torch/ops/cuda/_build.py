"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain ``extern "C"`` interface. It is
compiled by ``nvcc`` for ``sm_90a`` into ``paddle_tpu_torch/_build/`` at
first use (the directory is git-ignored) and loaded with ``ctypes``; no
PyTorch header is compiled, so a build takes seconds. The library name
carries a hash of the source, of every shared header (``csrc/*.cuh``) and
of the flags, so an edited source or header is rebuilt and a stale library
is never loaded. ``build()`` starts one ``nvcc`` per stale source, all at
once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_DIR = PACKAGE_ROOT / "_build"
# B1 (f32 SIMT, bf16 tensor cores), f32 B2 and B3 (SIMT), bf16 B2, bf16 B3
SOURCES = ("flash_attn_fwd", "flash_attn_fwd_tc", "flash_attn_bwd",
           "flash_attn_dkv_tc", "flash_attn_dq_tc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled from "
        "paddle_tpu_torch/csrc at first use and need the CUDA toolkit")


def library_path(name):
    """Where csrc/<name>.cu's library lives: the name carries a hash of the
    source, of every csrc/*.cuh (any of which it may include) and of the
    flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Compile every stale source of ``names`` in parallel. Returns
    {name: {"path"}} plus, for each source compiled now, its "seconds"
    and ptxas's register, shared-memory and spill lines. Raises with
    nvcc's output
    if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    info = {name: {"path": str(library_path(name))} for name in names}
    failed = []
    for name, out, tmp, t0, proc in jobs:
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for *_, p in jobs:
                p.kill()
                p.communicate()
            raise
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        info[name]["seconds"] = time.perf_counter() - t0
        info[name]["ptxas"] = [ln.strip() for ln in log.splitlines()
                               if "ptxas info" in ln or "spill" in ln]
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return info


def library(name):
    """The ctypes library of csrc/<name>.cu, built first if needed."""
    with _lock:
        path = library_path(name)
        if not path.exists():
            build((name,))
        return ctypes.CDLL(str(path))
