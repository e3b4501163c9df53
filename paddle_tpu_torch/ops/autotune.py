"""Tile-size autotuning and the measured fusion policy of the kernel tier.

Port of paddle_tpu/ops/autotune.py. Two services:

* ``Autotuner``: a search over candidates per (op, signature). Each
  candidate is timed on the card after a warm-up, as replays of a CUDA
  graph of back-to-back calls (device time, no host launch cost), the
  best of ``reps`` replays counts, and the winner is memoised in the process
  and kept in a cache on disk (``PADDLE_TPU_AUTOTUNE_CACHE``, default
  ``~/.cache/paddle_tpu_torch/autotune``; tmp + ``os.replace`` writes), so
  a later process pays no search. A key carries the source version of the
  code it tuned (the CUDA sources too) and the card's name, so an edited
  kernel or another card never reads a stale answer. The search runs only
  on the card and only under ``FLAGS_autotune``; on the CPU a
  deterministic fallback answers and the disk is not touched. Flash
  attention's tiles (B1-B3) are chosen so.

* The measured fusion policy (``choose_fused``): each fused op names its
  fused and unfused forms. Under ``FLAGS_fusion_policy=auto`` the call
  runs the form ``_POLICY_FALLBACK`` names for its (op, dtype, direction):
  this card's own measurements (chip_smoke.py's fusion_policy lane), on
  the card as off it, so the decision is the same in every process and
  every run. A caller that installs a tuner made with
  ``fusion_search=True`` (``set_tuner``) asks it to time the two forms
  per signature instead (one process only: under a data-parallel group
  the table answers, see below). A form that fails to build or launch in
  that search raises; it never loses quietly.

Three rules are the port's own:

- A search is timed in a thread of its own, so nothing of the caller's
  thread-local state reaches the probes: not its stream (a discovery pass
  runs on a side stream), not a CUDA-graph capture, not the saved-tensor
  hooks of ``recompute``'s checkpoint, not its grad mode.
- A CUDA graph cannot hold a timed search. ``to_static`` and the
  ``Predictor`` run an eager discovery pass before they capture, and the
  search happens there; a capture must hit the memo, and a miss under
  ``torch.cuda.is_current_stream_capturing()`` raises naming the op and
  the signature.
- The ranks of a data-parallel job must build the same autograd graph, or
  their Reducer buckets pair up wrongly. A fusion decision changes the
  graph, so under an initialised ``torch.distributed`` group of more than
  one rank it always comes from the table, which is the same on every
  rank. A tile changes no graph: each rank chooses its own, from its own
  memo, disk cache or search, and no rank waits for another (ROADMAP,
  "Differences by design").
"""
from __future__ import annotations

import functools
import hashlib
import inspect
import json
import math
import os
import threading
import time

import torch

__all__ = ["Autotuner", "AutotuneCache", "choose_fused", "counters",
           "current_direction", "fusion_policy", "get_tuner", "measure",
           "reset_counters", "set_tuner", "shape_bucket", "short_dtype",
           "device_platform", "source_version"]

# ---------------------------------------------------------------------------
# counters (the tests' and chip_smoke's seam)

_COUNTERS = {
    "searches": 0,        # timed candidate searches performed
    "mem_hits": 0,        # in-process memo hits
    "disk_hits": 0,       # persistent-cache hits
    "fallbacks": 0,       # decisions served by a fallback or the table
    "cache_errors": 0,    # corrupt or foreign cache records ignored
    "candidate_errors": 0,  # candidates that failed to build or launch
    "policy_fused": 0,    # fusion decisions that kept the fused form
    "policy_unfused": 0,  # fusion decisions that took the unfused form
}


def counters():
    return dict(_COUNTERS)


def reset_counters():
    for k in _COUNTERS:
        _COUNTERS[k] = 0


def _record(name, value):
    """A decision as a sample of the metrics registry (the reference's
    profiler counter event)."""
    from ..profiler.metrics import get_registry
    get_registry().record_sample(name, value)


# ---------------------------------------------------------------------------
# signature helpers

def shape_bucket(shape):
    """Each dim rounded up to a power of two, so nearby shapes share one
    tuned answer (and one search)."""
    return tuple(1 if d <= 1 else 1 << (int(d) - 1).bit_length()
                 for d in shape)


_DTYPE_SHORT = {torch.bfloat16: "bf16", torch.float32: "f32",
                torch.float16: "f16", torch.float64: "f64"}


def short_dtype(dtype):
    return _DTYPE_SHORT.get(dtype, str(dtype).replace("torch.", ""))


def device_platform(*vals):
    """'cuda' or 'cpu': the lead tensor operand's ``device.type``; with no
    tensor among ``vals``, the CPU."""
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device.type
    return "cpu"


def _device_of(vals):
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def device_name(device):
    """The key's device part: the card's name, or 'cpu'."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


@functools.lru_cache(maxsize=None)
def source_version(module_name, *paths):
    """Short hash of a module's source (and of the files in ``paths``,
    a kernel's CUDA sources): a key carries it, so editing the code
    invalidates every answer it produced."""
    import importlib
    try:
        h = hashlib.sha1(inspect.getsource(
            importlib.import_module(module_name)).encode())
    except (ImportError, OSError, TypeError):
        return "unknown"
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


# ---------------------------------------------------------------------------
# persistent cache (tmp + os.replace writes; torn or foreign records miss)

def default_cache_dir():
    return os.environ.get("PADDLE_TPU_AUTOTUNE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "paddle_tpu_torch", "autotune")


class AutotuneCache:
    """One JSON file per key under the cache directory. A missing, torn or
    corrupt file, or a record of another key, is a miss; a write goes
    through a temporary file and ``os.replace``, so a reader never sees a
    partial record."""

    def __init__(self, path=None):
        self.path = path or default_cache_dir()

    def _file(self, key):
        digest = hashlib.sha1(key.encode()).hexdigest()[:24]
        return os.path.join(self.path, digest + ".json")

    def get(self, key):
        try:
            with open(self._file(key)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(rec, dict) or rec.get("key") != key:
            _COUNTERS["cache_errors"] += 1
            return None
        return rec.get("value")

    def put(self, key, value):
        try:
            os.makedirs(self.path, exist_ok=True)
            path = self._file(key)
            tmp = "%s.tmp.%d" % (path, os.getpid())
            with open(tmp, "w") as f:
                json.dump({"key": key, "value": value}, f)
            os.replace(tmp, path)
        except OSError:
            pass  # the cache saves time; an unwritable one costs a search


def _jsonable(v):
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    return v


def _tuplify(v):
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


# ---------------------------------------------------------------------------
# measurement

# the least a timed window on the card lasts: a call shorter than that is
# timed as a run of back-to-back calls, at most MAX_CALLS of them
MIN_WINDOW_MS = 1.0
MAX_CALLS = 64


def _events_ms(fn, args, calls):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


_CAPTURE_STREAMS = {}


def _capture_stream(device):
    """One side stream a device for every timed capture: cuBLAS keeps a
    workspace for each stream it runs on for the life of the process, so
    a stream a measurement would hold a workspace a measurement."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _graph_ms(fn, args, reps):
    """Best-of-``reps`` ms a call of ``fn(*args)`` on the card: a window
    of back-to-back calls captured as one CUDA graph and timed by events
    around its replay, so the host's launch cost (tens of microseconds a
    call through ctypes, more than a small kernel takes) is not in it."""
    once = _events_ms(fn, args, 1)
    calls = min(MAX_CALLS, max(1, math.ceil(MIN_WINDOW_MS / max(once,
                                                                1e-6))))
    side = _capture_stream(_device_of(args))
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            for _ in range(calls):
                fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def measure(fn, args, warmup=1, reps=3):
    """Best-of-``reps`` milliseconds a call of ``fn(*args)`` after
    ``warmup`` untimed calls: on the card, replays of a captured window
    of back-to-back calls (``_graph_ms``), what a captured step pays; on
    the host, its clock."""
    for _ in range(warmup):
        fn(*args)
    if _device_of(args).type == "cuda":
        return _graph_ms(fn, args, reps)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def synth_args(args, seed=0):
    """Probe operands: a fresh tensor of each tensor operand's shape,
    dtype and device (floating ones drawn from a seeded normal, others
    zero); the caller's tensors are never touched. Other values pass
    through."""
    gens = {}
    out = []
    for a in args:
        if not isinstance(a, torch.Tensor):
            out.append(a)
        elif a.is_floating_point():
            gen = gens.get(a.device)
            if gen is None:
                gen = gens[a.device] = torch.Generator(
                    device=a.device).manual_seed(seed)
            out.append(torch.randn(a.shape, generator=gen, device=a.device,
                                   dtype=torch.float32).to(a.dtype))
        else:
            out.append(torch.zeros(a.shape, dtype=a.dtype, device=a.device))
    return out


def _in_own_thread(fn, device):
    """``fn()`` in a fresh thread, on ``device``, and its result here."""
    box = {}
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def run():
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            box["value"] = fn()
        except BaseException as err:  # re-raised in the caller's thread
            box["error"] = err
    t = threading.Thread(target=run, name="autotune-search")
    t.start()
    t.join()
    if "error" in box:
        raise box["error"]
    return box["value"]


# ---------------------------------------------------------------------------
# the tuner

class Autotuner:
    """Candidate search with three levels: the in-process memo, the disk
    cache, then a timed search (on the card only). ``measure_fn``,
    ``searchable`` and ``cache_dir`` can be given, for tests;
    ``fusion_search`` makes ``choose_fused``'s auto time the fused and
    unfused forms instead of reading the table."""

    def __init__(self, cache_dir=None, measure_fn=None, searchable=None,
                 warmup=1, reps=3, rounds=5, fusion_search=False):
        self.fusion_search = fusion_search
        self._cache = AutotuneCache(cache_dir)
        self._measure = measure_fn or (
            lambda fn, args: measure(fn, args, warmup, reps))
        self._rounds = rounds
        self._searchable_override = searchable
        self._mem = {}
        # (key, candidate, error) of every candidate that failed
        self.errors = []

    def searchable(self, platform=None):
        """Whether a search may run for operands on ``platform`` (default:
        the card when there is one): only on the card, only under
        FLAGS_autotune."""
        if self._searchable_override is not None:
            return bool(self._searchable_override())
        from ..framework.flags import get_flag
        if not get_flag("FLAGS_autotune", True):
            return False
        if platform is None:
            platform = "cuda" if torch.cuda.is_available() else "cpu"
        return platform == "cuda"

    def get(self, op, signature, *, candidates, build, make_args, fallback,
            version="", device=None, strict=False):
        """The winning candidate of (op, signature).

        candidates: JSON-able candidate configs. build(cand): the callable
        to time, given make_args()'s probe operands (called only for a
        search, in a thread of its own on ``device``). fallback: the
        answer where no search may run, and where every candidate fails.
        strict: a candidate that fails to build or launch raises, where
        otherwise it is skipped (and counted).
        """
        device = torch.device("cpu") if device is None else device
        key = "%s|%s|v=%s|%s" % (op, signature, version, device_name(device))
        if key in self._mem:
            _COUNTERS["mem_hits"] += 1
            return self._mem[key]
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"autotune: no decision for {op} at {signature} while a CUDA "
                f"graph is being captured; a timed search cannot run inside "
                f"a capture, so run the step once eagerly first (to_static "
                f"and Predictor do so in their discovery pass)")
        got = self._resolve(key, device, candidates, build, make_args,
                            fallback, strict)
        self._mem[key] = got
        return got

    def _resolve(self, key, device, candidates, build, make_args, fallback,
                 strict):
        got = self._cache.get(key)
        if got is not None:
            _COUNTERS["disk_hits"] += 1
            return _tuplify(got)
        if not self.searchable(device.type):
            # memoised only: a later process on the card still searches
            _COUNTERS["fallbacks"] += 1
            return fallback

        def search():
            args = make_args()
            built = []
            for cand in candidates:
                try:
                    built.append((cand, build(cand)))
                except (RuntimeError, ValueError) as err:
                    # a tile that does not build, launch or match its plain
                    # version is no candidate
                    if strict:
                        raise
                    _COUNTERS["candidate_errors"] += 1
                    self.errors.append((key, cand, repr(err)))
            # rounds in alternating order, each candidate's median: a
            # candidate timed first, or while the card's clock or the
            # host's load drifts, gains nothing by it
            times = {i: [] for i in range(len(built))}
            for r in range(self._rounds):
                order = range(len(built)) if r % 2 == 0 \
                    else reversed(range(len(built)))
                for i in order:
                    try:
                        times[i].append(self._measure(built[i][1], args))
                    except (RuntimeError, ValueError) as err:
                        if strict:
                            raise
                        _COUNTERS["candidate_errors"] += 1
                        self.errors.append((key, built[i][0], repr(err)))
                        times[i].append(float("inf"))
            best, best_t = None, float("inf")
            for i, (cand, _) in enumerate(built):
                t = sorted(times[i])[len(times[i]) // 2]
                if t < best_t:
                    best, best_t = cand, t
            return best
        # the probes' kernel launches are measurements, not the caller's
        # path: the launch counts are as they were before the search
        from .cuda import launch_counts
        before = launch_counts.copy()
        try:
            best = _in_own_thread(search, device)
        finally:
            launch_counts.clear()
            launch_counts.update(before)
        _COUNTERS["searches"] += 1
        _record("autotune.search/%s" % key.split("|")[0], 1)
        if best is None:
            best = fallback
        self._cache.put(key, _jsonable(best))
        return best


_TUNER = [None]


def get_tuner():
    if _TUNER[0] is None:
        _TUNER[0] = Autotuner()
    return _TUNER[0]


def set_tuner(tuner):
    """Swap the process tuner (tests); returns the previous one."""
    old = _TUNER[0]
    _TUNER[0] = tuner
    return old


# ---------------------------------------------------------------------------
# the measured fusion policy

# The answer of FLAGS_fusion_policy=auto, on the card and off it: each
# (op, dtype, direction) that chip_smoke.py's fusion_policy lane measured
# slower fused than unfused routes unfused; everything else stays fused.
# Each factor is unfused ms over fused ms, forward and backward, at the
# shapes GPT-medium calls the op with (4 x 1024 x 1024 bf16), timed as
# replays of a captured window (``measure``), the median of six
# alternating rounds (each within 4 % of it), on an NVIDIA H100 80GB HBM3
# at 700 W. flash_attention (4.18-16.4x at GPT's and BERT's shapes, both
# directions) and fused_conv_bn (1.028x at ResNet-50's first 3x3 conv,
# batch 128) measured faster fused.
_POLICY_FALLBACK = {
    ("fused_ffn", "bf16", "fwd_bwd"): "unfused",           # 0.488x
    ("fused_residual_ln", "bf16", "fwd_bwd"): "unfused",   # 0.909x
}

# recompute() differentiates its region although grad mode alone cannot
# say so for every caller; fleet.utils.recompute sets "fwd_bwd" around it
_FORCE_DIRECTION = [None]


def fusion_policy():
    from ..framework.flags import get_flag
    pol = str(get_flag("FLAGS_fusion_policy", "auto") or "auto").lower()
    if pol not in ("auto", "always", "never"):
        raise ValueError(
            "FLAGS_fusion_policy must be auto|always|never, got %r" % pol)
    return pol


def auto_winner(fused_ms, unfused_ms):
    """The strict measured winner: fused runs only when it is not slower."""
    return "fused" if fused_ms <= unfused_ms else "unfused"


def policy_table_choice(op, dtype_short, direction):
    return _POLICY_FALLBACK.get((op, dtype_short, direction), "fused")


def current_direction():
    if _FORCE_DIRECTION[0] is not None:
        return _FORCE_DIRECTION[0]
    return "fwd_bwd" if torch.is_grad_enabled() else "fwd"


def _grad_probe(fn):
    """Forward and backward of the sum of ``fn``'s differentiable outputs
    with respect to every floating operand: what the op costs inside a
    training step, the regime the policy chooses for."""
    def probe(*args):
        args = [a.detach().requires_grad_() if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a for a in args]
        with torch.enable_grad():
            outs = fn(*args)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            total = sum(o.float().sum() for o in outs
                        if isinstance(o, torch.Tensor) and o.requires_grad)
            leaves = [a for a in args if isinstance(a, torch.Tensor)
                      and a.requires_grad]
            torch.autograd.grad(total, leaves)
    return probe


def _no_grad_probe(fn):
    def probe(*args):
        with torch.no_grad():
            fn(*args)
    return probe


def choose_fused(op, fused_fn, unfused_fn, args, *, module=None,
                 sources=()):
    """(fn, choice) for this call: ``fused_fn`` or ``unfused_fn``, and
    "fused" or "unfused". ``args`` are the op's operands (the probes of a
    search get fresh tensors of their shapes); ``module`` and ``sources``
    (the CUDA files of the fused form's kernels) version a searched
    answer. The decision is recorded as a ``fusion_policy/<op>`` sample
    (1 = fused)."""
    pol = fusion_policy()
    if pol == "always":
        choice = "fused"
    elif pol == "never":
        choice = "unfused"
    else:
        choice = _auto_choice(op, fused_fn, unfused_fn, args, module,
                              sources)
    _COUNTERS["policy_fused" if choice == "fused" else "policy_unfused"] += 1
    _record("fusion_policy/%s" % op, 1.0 if choice == "fused" else 0.0)
    return (fused_fn if choice == "fused" else unfused_fn), choice


def _data_parallel():
    """Whether this process is one rank of several."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _auto_choice(op, fused_fn, unfused_fn, args, module, sources):
    lead = args[0]
    dt = short_dtype(lead.dtype)
    direction = current_direction()
    table = policy_table_choice(op, dt, direction)
    tuner = get_tuner()
    device = _device_of(args)
    # the table is the same on every rank and in every run; a measurement
    # is neither, so it is taken only where it was asked for and only in
    # a process of its own
    if not (tuner.fusion_search and tuner.searchable(device.type)) \
            or _data_parallel():
        _COUNTERS["fallbacks"] += 1
        return table
    bucket = "x".join(str(d) for d in shape_bucket(lead.shape))
    sig = "%s|%s|%s|%s" % (bucket, dt, direction, device.type)
    version = source_version(module, *sources) if module else ""

    def build(cand):
        fn = fused_fn if cand == "fused" else unfused_fn
        return _grad_probe(fn) if direction == "fwd_bwd" \
            else _no_grad_probe(fn)

    return tuner.get("fusion.%s" % op, sig, candidates=("fused", "unfused"),
                     build=build, make_args=lambda: synth_args(args),
                     fallback=table, version=version, device=device,
                     strict=True)
