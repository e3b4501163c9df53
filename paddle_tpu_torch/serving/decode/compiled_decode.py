"""Compiled decode step: one captured program per (bucket, signature)
(port of paddle_tpu/serving/decode/compiled_decode.py).

The decode loop executes the same tiny program millions of times, so its two
compile-side pathologies are fatal at serving scale:

- **unbounded retraces** — every distinct batch shape is a fresh program
  (an XLA compilation in the reference, a CUDA graph capture here). The
  engine therefore pads the running set to a fixed bucket set
  (``serving.batcher`` discipline) and this wrapper keys its program cache
  by ``(bucket, signature)``, so the steady state builds at most once per
  key. Builds/cache-hits land in the same process-wide counters the
  training side uses (``compiled_step.compiles_total`` /
  ``cache_hits_total`` via :mod:`paddle_tpu_torch.jit.compiled_step`), and
  the same retrace-storm guard warns through the flight recorder when the
  key set outgrows ``FLAGS_compiled_step_max_retraces``;
- **KV copies** — the reference's jitted program donates the KV operand,
  after copying any host buffer onto the device so donation never aliases
  host memory. Here, on the card, a program is one CUDA graph
  (``jit/inference_graph.py``) with static buffers: each call copies the
  host rows into the program's static KV buffer (the "copy, then donate"
  step) and returns host copies of the outputs (``.cpu()`` where the
  reference's caller takes ``np.asarray``), so a returned ``new_kv`` never
  aliases a buffer the next replay overwrites. On the host the step runs
  eagerly on CPU tensors (there are no CPU graphs), under the same keys
  and counters.

``CompiledDecodeBackend`` is the reference engine backend built on this
wrapper: a deterministic token stepper whose per-stream state rides a
fixed-width KV row, bucket-padded per decode round. The chaos soak drives
it to prove the compile bound end to end.
"""
from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from ...core.device import resolve_device
from ...jit.compiled_step import _note_cache_hit, _note_compile
from ...jit.to_static import _flatten_tensors, _replace_tensors
from ..batcher import bucket_for, pow2_buckets

__all__ = ["CompiledDecodeStep", "CompiledDecodeBackend"]


def _flag(name, default):
    from ...framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


def _as_tensors(tree):
    """``tree`` (an array, or a nested tuple/list of arrays) with every
    numpy array as a tensor (a copy: the caller keeps its arrays)."""
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_tensors(v) for v in tree)
    return tree if isinstance(tree, torch.Tensor) else \
        torch.from_numpy(np.array(tree))


class CompiledDecodeStep:
    """Callable cache of decode programs, one per (bucket, signature).

    ``step_fn(tokens, positions, kv) -> (next_tokens, new_kv)`` must be a
    function of its tensors (no host syncs: it is captured as a CUDA graph
    on the card); ``tokens``/``positions`` are bucket-padded int vectors
    and ``kv`` a tensor or a (nested) tuple of tensors with a leading
    bucket dim, as numpy arrays or tensors. Outputs come back as CPU
    tensors. The cache is LRU-bounded like
    :class:`~paddle_tpu_torch.serving.batcher.BucketedExecutor`
    (``max_cached``, ``compile_count``), so even a caller that bypasses
    bucketing cannot grow it without bound. ``device`` defaults to the
    card (cuda:0); pass "cpu" for the host.
    """

    def __init__(self, step_fn, label="decode_step", max_cached=16,
                 donate_kv=True, device=None):
        # donate_kv is the reference's signature: the KV rows are always
        # copied into the program's own buffer here
        self._fn = step_fn
        self._label = label
        self.max_cached = int(max_cached)
        self.donate_kv = bool(donate_kv)
        self.device = resolve_device(device)
        self.compile_count = 0
        self.cache_hits = 0
        self._programs = {}   # key -> InferenceGraph (None on the host)
        self._last_use = {}   # key -> tick (LRU)
        self._tick = 0
        self._seen_sigs = set()
        self._storm_warned = False
        self._lock = threading.Lock()

    # -- retrace-storm guard (same contract as jit/compiled_step.py) ---------
    def _guard_retrace(self, key):
        if key in self._seen_sigs:
            return
        self._seen_sigs.add(key)
        bound = int(_flag("FLAGS_compiled_step_max_retraces", 8))
        if bound <= 0 or len(self._seen_sigs) <= bound or self._storm_warned:
            return
        self._storm_warned = True
        try:
            from ...resilience.recorder import get_recorder
            rec = get_recorder()
            entry = rec.start("compiled_step.retrace_storm", group=self._label,
                              seq=len(self._seen_sigs),
                              shapes=[str(key)[:200]])
            rec.finish(entry, status="warn")
        except Exception:
            pass  # observability must not turn a retrace into a crash
        warnings.warn(
            f"decode_step[{self._label}]: {len(self._seen_sigs)} distinct "
            f"(bucket, signature) keys compiled (> "
            f"FLAGS_compiled_step_max_retraces={bound}). The engine should "
            "be padding the running set to a fixed bucket set.",
            RuntimeWarning, stacklevel=3)

    @staticmethod
    def _key(leaves):
        sig = tuple((tuple(v.shape), str(v.dtype)) for v in leaves)
        return (int(leaves[0].shape[0]), sig)

    def run(self, tokens, positions, kv):   # hot-path: per-token decode dispatch
        """One decode step at the caller-chosen bucket. Returns
        ``(next_tokens, new_kv)`` as CPU tensors; ``kv`` itself is never
        written (its rows are copied into the program's buffer first)."""
        tokens, positions, kv = _as_tensors((tokens, positions, kv))
        leaves = _flatten_tensors((tokens, positions, kv), [])
        key = self._key(leaves)
        with self._lock:
            hit = key in self._programs
            if hit:
                prog = self._programs[key]
                self._tick += 1
                self._last_use[key] = self._tick
                self.cache_hits += 1
        if hit:
            _note_cache_hit()
            return self._call(prog, leaves, kv)
        # build: counted once per key
        with self._lock:
            self._guard_retrace(key)
            prog = self._build(leaves, kv)
            self.compile_count += 1
            self._tick += 1
            self._last_use[key] = self._tick
            if len(self._programs) >= self.max_cached:
                victim = min(self._last_use, key=self._last_use.get)
                self._programs.pop(victim, None)
                self._last_use.pop(victim, None)
            self._programs[key] = prog
        out = self._call(prog, leaves, kv)
        _note_compile()
        return out

    @staticmethod
    def _unflat(leaves, kv):
        """(tokens, positions, kv) with ``leaves`` in place of the tensors,
        ``kv`` keeping its structure."""
        return leaves[0], leaves[1], _replace_tensors(kv, iter(leaves[2:]))

    def _build(self, leaves, kv):
        if self.device.type != "cuda":
            return None
        from ...jit.inference_graph import InferenceGraph

        def fn(*xs):
            return self._fn(*self._unflat(list(xs), kv))
        return InferenceGraph(fn, [t.to(self.device) for t in leaves],
                              name=f"decode_step[{self._label}]")

    def _call(self, prog, leaves, kv):
        if prog is not None:
            return _replace_tensors(prog.out_tree, iter(prog.run(leaves)))
        with torch.inference_mode():
            nxt, new_kv = self._fn(*self._unflat(leaves, kv))
        return nxt, new_kv


def _toy_step_fn(vocab):
    """Deterministic reference stepper (bench + chaos soak): the KV row
    accumulates ``token + position`` per consumed token, and the next token
    is a pure function of that sum — so a stream replayed after a replica
    death (prefill of prompt + already-emitted tokens) lands on the exact
    same continuation, which the recovery test asserts token-for-token."""

    def step(tokens, positions, kv):
        new_kv = kv.clone()
        new_kv[:, 0] += tokens.to(kv.dtype) + positions.to(kv.dtype)
        nxt = (new_kv[:, 0].to(torch.int32) + positions + 1) % vocab
        return nxt.to(torch.int32), new_kv
    return step


def _toy_verify_fn(vocab):
    """Teacher-forced verifier for the toy stepper: consumes the last
    emitted token then each draft token in turn, emitting the target's
    greedy choice at every position. Iteration ``j=0`` is exactly
    :func:`_toy_step_fn`'s update, so verification with an empty draft
    degenerates to the plain decode step — the greedy-equivalence the
    spec-decode tests assert token-for-token. The unrolled K is a static
    shape (``drafts.shape[1]``), so the program cache keys it like any
    other signature: one build per (bucket, K)."""

    def verify(tokens, positions, kvd):
        kv, drafts = kvd
        k = drafts.shape[1]
        last, pos, cur = tokens, positions, kv
        outs, rows = [], []
        for j in range(k + 1):
            cur = cur.clone()
            cur[:, 0] += last.to(cur.dtype) + pos.to(cur.dtype)
            nxt = (cur[:, 0].to(torch.int32) + pos + 1) % vocab
            outs.append(nxt.to(torch.int32))
            rows.append(cur)
            if j < k:
                last = drafts[:, j]
                pos = pos + 1
        return torch.stack(outs, dim=1), torch.stack(rows, dim=1)
    return verify


class CompiledDecodeBackend:
    """Reference :class:`~.engine.DecodeEngine` backend over a compiled
    step. Per-stream state is one KV row (width ``kv_width``); each decode
    round gathers the running streams' rows, pads to the smallest bucket,
    and runs one (bucket, signature)-cached program on ``device`` (default
    the card, cuda:0; "cpu" for the host).
    """

    def __init__(self, step_fn=None, buckets=None, max_running=8,
                 kv_width=8, vocab=50257, max_cached=16, service=None,
                 device=None):
        self.vocab = int(vocab)
        self.kv_width = int(kv_width)
        self.buckets = sorted(buckets) if buckets else \
            pow2_buckets(max_running)
        self.step = CompiledDecodeStep(
            step_fn if step_fn is not None else _toy_step_fn(self.vocab),
            label="decode_backend", max_cached=max_cached, device=device)
        # Speculative verify rides its own program cache: (bucket, K) keys
        # are disjoint from the plain step's, so enabling speculation never
        # disturbs the step's compile bound the soaks assert. Only the
        # reference stepper has a matching verifier — a custom step_fn must
        # bring its own verify or run without speculation.
        self.vstep = CompiledDecodeStep(
            _toy_verify_fn(self.vocab), label="decode_verify",
            max_cached=max_cached, device=device) \
            if step_fn is None else None
        # optional cost hook: called (kind, n_tokens) so fake-clock harnesses
        # charge prefill/decode work to the injected clock
        self._service = service
        self._rows = {}   # stream id -> (np kv row [kv_width], consumed pos)

    # -- engine backend protocol --------------------------------------------
    def prefill_chunk(self, stream, tokens, start):
        """Consume one prompt chunk into the stream's KV row; when the
        stream has nothing left to fill, return its next token."""
        row, pos = self._rows.get(stream.id, (None, 0))
        if row is None:
            row = np.zeros((self.kv_width,), dtype="float32")
        assert pos == start, f"prefill out of order: {pos} != {start}"
        for t in tokens:
            row[0] += float(int(t) + pos)
            pos += 1
        self._rows[stream.id] = (row, pos)
        if self._service is not None:
            self._service("prefill", len(tokens))
        if stream.remaining_fill() == 0:
            return int(row[0] + pos) % self.vocab
        return None

    def decode(self, streams):
        """One token for every running stream, through the compiled step."""
        n = len(streams)
        bucket = bucket_for(n, self.buckets)
        tokens = np.zeros((bucket,), dtype="int32")
        positions = np.zeros((bucket,), dtype="int32")
        kv = np.zeros((bucket, self.kv_width), dtype="float32")
        for i, s in enumerate(streams):
            row, pos = self._rows[s.id]
            tokens[i] = s.tokens[-1]
            positions[i] = pos
            kv[i] = row
        nxt, new_kv = self.step.run(tokens, positions, kv)
        nxt = np.asarray(nxt)
        new_kv = np.asarray(new_kv)
        out = []
        for i, s in enumerate(streams):
            _, pos = self._rows[s.id]
            self._rows[s.id] = (new_kv[i].copy(), pos + 1)
            out.append(int(nxt[i]))
        if self._service is not None:
            self._service("decode", n)
        return out

    def verify(self, streams, drafts):
        """Speculative verify: teacher-force each stream's K draft tokens
        (plus one bonus position) in a single compiled pass, then accept
        host-side the longest draft prefix matching the target's greedy
        choices. Returns the per-stream emitted tokens — accepted drafts
        followed by the target's own token at the divergence (or the bonus
        token on full acceptance). The KV row installed afterwards is the
        one *at the accepted position*: rejected draft state is simply
        never adopted, which is what makes the emitted stream
        token-identical to non-speculative greedy decode.

        Cost model: one verify pass is charged like one decode round — the
        entire point of speculation is that accepted tokens ride along for
        free.
        """
        if self.vstep is None:
            from ...framework.errors import UnimplementedError
            raise UnimplementedError(
                "speculative verify requires the reference step_fn "
                "(custom steppers must bring their own verifier)")
        n = len(streams)
        k = max(len(d) for d in drafts)
        bucket = bucket_for(n, self.buckets)
        tokens = np.zeros((bucket,), dtype="int32")
        positions = np.zeros((bucket,), dtype="int32")
        kv = np.zeros((bucket, self.kv_width), dtype="float32")
        dr = np.full((bucket, k), -1, dtype="int32")
        for i, s in enumerate(streams):
            row, pos = self._rows[s.id]
            tokens[i] = s.tokens[-1]
            positions[i] = pos
            kv[i] = row
            dr[i, :len(drafts[i])] = drafts[i]
        targets, rows = self.vstep.run(tokens, positions, (kv, dr))
        targets = np.asarray(targets)
        rows = np.asarray(rows)
        out = []
        for i, s in enumerate(streams):
            d = drafts[i]
            a = 0
            while a < len(d) and int(d[a]) == int(targets[i, a]):
                a += 1
            emitted = [int(t) for t in d[:a]] + [int(targets[i, a])]
            _, pos = self._rows[s.id]
            self._rows[s.id] = (rows[i, a].copy(), pos + a + 1)
            out.append(emitted)
        if self._service is not None:
            self._service("decode", n)
        return out

    def release(self, stream):
        self._rows.pop(stream.id, None)

    def reset(self):
        """Replica death: all device-side KV state is lost. The engine
        re-prefills every live stream (prompt + emitted tokens)."""
        self._rows.clear()

    # -- KV migration hooks (serving/decode/kv_migrate.py) -------------------
    def export_state(self, stream):
        """Wire-codec-friendly snapshot of one stream's KV state, for a
        prefill→decode handoff. Returns None when the stream has no state
        here (the migrator aborts typed instead of shipping nothing)."""
        row, pos = self._rows.get(stream.id, (None, 0))
        if row is None:
            return None
        return {"row": [float(v) for v in row], "pos": int(pos)}

    def adopt_state(self, stream, state):
        """Install a migrated stream's KV state. The row/pos pair is the
        exact state :meth:`export_state` produced on the prefill replica,
        so the next :meth:`decode` round continues token-for-token."""
        self._rows[stream.id] = (
            np.asarray(state["row"], dtype="float32"), int(state["pos"]))
