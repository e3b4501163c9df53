"""Speculative decoding: draft-K proposals verified in one target step
(port of paddle_tpu/serving/decode/specdecode.py).

Continuous batching (engine.py) fixes *throughput*; per-token latency is
still one full target-model step per token. Speculative decoding
(Leviathan et al. 2023) attacks the latency itself: a cheap **draft**
proposes K tokens, the target model scores all K (plus one bonus position)
in a single batched teacher-forced pass, and the engine accepts the
longest prefix of the draft that matches the target's greedy choice,
followed by the target's own token at the first divergence. Under greedy
decoding this is *exactly* equivalent to running the target one token at a
time — the emitted stream is token-identical, speculation only changes how
many tokens arrive per step.

Split of responsibilities:

- :class:`DraftModel` (protocol) — ``propose(stream, k)`` returns up to K
  draft tokens from whatever cheap source (a smaller model, n-gram reuse
  of the stream's own context, ...). Draft quality only affects the accept
  ratio, never correctness.
- :class:`SpecDecoder` — per-engine orchestration state: runs the draft
  (chaos site ``spec.draft``; an injected fault or a draft exception just
  skips speculation for that tick), pads proposals to a fixed K so the
  verify program is built once per batch bucket, and accounts
  accepted/proposed into ``spec.*`` counters and the engine's
  ``decode.spec_accept_ratio`` gauge.
- The **verify** pass itself lives with the backend
  (``CompiledDecodeBackend.verify``): one :class:`CompiledDecodeStep`
  program per (bucket, K) teacher-forces the drafts from a copy of the KV
  rows in the program's static buffer, and the host keeps the KV row at
  the accepted position — rejected draft KV is simply never installed,
  and ``BlockTable.truncate`` returns the over-reserved pages.

Replay safety: the engine's replica-death contract replays ``prompt +
tokens`` — the *emitted* sequence — which is greedy-equivalent regardless
of how many draft tokens were accepted or rejected before the crash, so
recovery resumes token-identically through speculation.
"""
from __future__ import annotations

from ...profiler.metrics import get_registry
from ...resilience.faults import maybe_inject

__all__ = ["DraftModel", "NGramDraft", "MirrorDraft", "SpecDecoder",
           "DRAFT_PAD"]

# Padding sentinel for proposals shorter than K: never a real token id, so
# it can never match the target's choice — verification naturally rejects
# at the padding boundary.
DRAFT_PAD = -1


class DraftModel:
    """Protocol for draft proposers. ``propose(stream, k)`` returns up to
    ``k`` next-token guesses for the stream's current context (prompt +
    emitted tokens); an empty list means "no guess this tick". Drafts are
    advisory — a wrong draft costs a rejected slot, never a wrong token."""

    def propose(self, stream, k):  # pragma: no cover - protocol
        raise NotImplementedError


class NGramDraft(DraftModel):
    """Prompt-lookup drafting: no second model at all. The last ``n``
    context tokens are matched against their most recent earlier occurrence
    and the continuation after that occurrence is proposed — effective
    exactly on the repetitive traffic prefix sharing targets (templates,
    code, retrieved passages)."""

    def __init__(self, n=2):
        self.n = max(1, int(n))

    def propose(self, stream, k):
        ctx = [int(t) for t in stream.prompt] + [int(t) for t in stream.tokens]
        if len(ctx) <= self.n:
            return []
        key = tuple(ctx[-self.n:])
        for i in range(len(ctx) - self.n - 1, -1, -1):
            if tuple(ctx[i:i + self.n]) == key:
                return ctx[i + self.n:i + self.n + int(k)]
        return []


class MirrorDraft(DraftModel):
    """Perfect-knowledge draft for the reference toy backend: replays the
    toy recurrence (running sum of ``token + position``) host-side, so its
    proposals match the target exactly — accept ratio 1.0 by construction.
    ``corrupt_every`` deliberately flips every Nth proposed token to
    exercise the rejection + :meth:`BlockTable.truncate` path
    deterministically in benches and soaks."""

    def __init__(self, vocab=50257, corrupt_every=0):
        self.vocab = int(vocab)
        self.corrupt_every = int(corrupt_every)
        self._proposed = 0

    def propose(self, stream, k):
        seq = [int(t) for t in stream.prompt] + \
            [int(t) for t in stream.tokens]
        if not seq:
            return []
        s = sum(t + i for i, t in enumerate(seq[:-1]))
        pos = len(seq) - 1
        last = seq[-1]
        out = []
        for _ in range(int(k)):
            s += last + pos
            nxt = (s + pos + 1) % self.vocab
            pos += 1
            self._proposed += 1
            if self.corrupt_every and self._proposed % self.corrupt_every == 0:
                nxt = (nxt + 1) % self.vocab
            out.append(nxt)
            last = nxt
        return out


class SpecDecoder:
    """Per-engine speculation state: draft orchestration + acceptance
    accounting. The engine consults :meth:`propose` once per decode tick
    and reports per-stream outcomes through :meth:`note`."""

    def __init__(self, draft, k):
        self.draft = draft
        self.k = int(k)
        self.proposed = 0
        self.accepted = 0
        self.rounds = 0
        if self.k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.k}")

    def propose(self, streams):
        """One draft pass over the tick's runnable streams (chaos site
        ``spec.draft``). Returns a per-stream list of proposals padded to
        exactly ``k`` with :data:`DRAFT_PAD` (fixed K keeps the verify
        program cache bounded per batch bucket), or None when speculation
        should be skipped this tick — injected draft fault, or no stream
        produced a guess. A draft that raises counts as no guess: drafts
        are advisory and must never take the serving loop down."""
        try:
            maybe_inject("spec.draft", ConnectionError)
        except ConnectionError:
            return None
        drafts = []
        any_guess = False
        for s in streams:
            try:
                d = [int(t) for t in self.draft.propose(s, self.k)][:self.k]
            except Exception:
                d = []
            any_guess = any_guess or bool(d)
            drafts.append(d + [DRAFT_PAD] * (self.k - len(d)))
        if not any_guess:
            return None
        self.rounds += 1
        get_registry().inc_counter("spec.rounds_total")
        return drafts

    def note(self, proposed, accepted):
        """Record one stream's verify outcome: ``proposed`` real (non-pad)
        draft tokens, ``accepted`` of them kept."""
        self.proposed += int(proposed)
        self.accepted += int(accepted)
        reg = get_registry()
        reg.inc_counter("spec.proposed_tokens_total", int(proposed))
        reg.inc_counter("spec.accepted_tokens_total", int(accepted))

    def accept_ratio(self):
        """Lifetime accepted/proposed — the ``decode.spec_accept_ratio``
        gauge. 0.0 until the first verified draft."""
        if not self.proposed:
            return 0.0
        return self.accepted / float(self.proposed)

    def stats(self):
        return {"proposed": self.proposed, "accepted": self.accepted,
                "rounds": self.rounds,
                "accept_ratio": self.accept_ratio()}
