"""Prefix-sharing KV cache: a content-addressed radix index over the pool
(port of paddle_tpu/serving/decode/prefix.py).

Production chat traffic is dominated by a handful of long system prompts
and few-shot templates; without sharing, every stream re-prefills and
re-stores the same prefix KV. RadixAttention (SGLang, Zheng et al. 2024)
fixes both costs at once: index finished prefixes in a radix tree keyed by
**token content** at block granularity, refcount the underlying pool pages,
and let a new stream whose prompt matches a cached prefix adopt those pages
instead of recomputing them.

This module is that index. The contract, layer by layer:

- **Granularity.** Tree edges are full ``block_size`` token chunks (the
  pool's page quantum); a prompt's partial last block is indexed as a
  *tail* entry under its deepest aligned node. Matching is exact-content,
  so two prompts share exactly the pages whose token runs are identical.
- **Ownership.** The cache holds one pool reference per indexed block
  (taken at :meth:`share`), so a sharer stream finishing — and releasing
  its table — never frees a cached page out from under the next warm join.
  :meth:`lookup` takes one additional reference per matched block **for
  the caller**, who hands them to :meth:`BlockTable.adopt_shared`
  (``ref_held=True``) on admission or unrefs them on refusal; the
  lookup-to-adopt window is therefore race-free by construction.
- **Divergence.** Sharing is read-only: the first divergent write (a warm
  stream's first generated token landing in a shared tail page) triggers
  the copy-on-write fork in :meth:`BlockTable.ensure_writable` — the cache
  never observes the write, its entry stays valid for the next join.
- **Eviction.** :meth:`evict` applies refcount-then-LRU: only entries
  whose block reference is the cache's *last* one are candidates (freeing
  anything else returns no memory), and among candidates, leaf-first by
  least-recent touch — interior nodes only fall after their subtree.
  :meth:`clear` (engine drain) unconditionally drops every cache
  reference, which is why drain audits can assert refcounts return to
  zero.
- **Warm decode.** Every indexed boundary carries the backend state
  snapshot exported at that position, and terminal entries also carry the
  first generated token — a full-prompt hit therefore skips prefill
  *entirely*: the engine adopts state, emits the cached first token, and
  the stream enters the decode tick directly.

Faults degrade, never break: an injected ``prefix.lookup`` fault is a cold
miss, ``prefix.share`` skips indexing that prefix, ``prefix.evict`` is
swallowed (eviction must complete, mirroring ``decode.evict``).
"""
from __future__ import annotations

import threading

from ...profiler.metrics import get_registry
from ...resilience.faults import maybe_inject

__all__ = ["PrefixCache", "PrefixHit"]


class _Entry:
    """One indexed page: a radix node (full-block chunk) or a tail (a
    prompt's partial last block). ``state`` is the backend snapshot at the
    entry's end position (None only on interior nodes created to bridge a
    fault-skipped share); ``token`` is the first generated token when this
    entry terminated a prompt."""

    __slots__ = ("chunk", "block", "state", "token",
                 "children", "tails", "tick", "parent")

    def __init__(self, chunk, block, parent):
        self.chunk = chunk
        self.block = block
        self.state = None
        self.token = None
        self.children = {}
        self.tails = {}
        self.tick = 0
        self.parent = parent


class PrefixHit:
    """A successful :meth:`PrefixCache.lookup`: ``blocks`` (one caller-held
    pool reference each), the ``tokens`` of prompt they cover, the backend
    ``state`` at that position, and — when ``full`` — the cached first
    generated ``token`` so prefill is skipped entirely."""

    __slots__ = ("blocks", "tokens", "state", "token", "full")

    def __init__(self, blocks, tokens, state, token, full):
        self.blocks = blocks
        self.tokens = tokens
        self.state = state
        self.token = token
        self.full = full


class PrefixCache:
    """Radix index of finished prefixes over a :class:`KVBlockPool`."""

    def __init__(self, pool):
        self.pool = pool
        self._root = _Entry((), None, None)
        self._tick = 0
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        get_registry().register_gauge_fn(
            "prefix.blocks_held_count", self.held)

    # -- lookup --------------------------------------------------------------
    def lookup(self, prompt):
        """Longest usable cached prefix of ``prompt``, or None on a miss.

        The returned hit's blocks each carry one pool reference **owned by
        the caller** — hand them to ``BlockTable.adopt_shared(...,
        ref_held=True)`` on admission, or ``pool.unref`` them on refusal.
        A match is *usable* only if it leaves the stream decodable: a
        full-prompt match must carry a cached first token (else the match
        is trimmed so at least one token remains to prefill). Injected
        faults degrade to a cold miss."""
        try:
            maybe_inject("prefix.lookup", ConnectionError)
        except ConnectionError:
            get_registry().inc_counter("prefix.misses_total")
            return None
        bs = self.pool.block_size
        toks = [int(t) for t in prompt]
        with self._lock:
            self._tick += 1
            path = []
            cur = self._root
            pos = 0
            while len(toks) - pos >= bs:
                child = cur.children.get(tuple(toks[pos:pos + bs]))
                if child is None:
                    break
                cur = child
                cur.tick = self._tick
                path.append(cur)
                pos += bs
            rest = tuple(toks[pos:])
            tail = cur.tails.get(rest) if rest else None
            if tail is not None and tail.state is not None \
                    and tail.token is not None:
                tail.tick = self._tick
                blocks = [n.block for n in path] + [tail.block]
                hit = PrefixHit(blocks, len(toks), tail.state,
                                tail.token, True)
            else:
                # Deepest aligned node with a state snapshot; a whole-prompt
                # match additionally needs the cached first token, else step
                # back one block so prefill has something left to produce it.
                i = len(path) - 1
                while i >= 0 and (
                        path[i].state is None
                        or ((i + 1) * bs == len(toks)
                            and path[i].token is None)):
                    i -= 1
                if i < 0:
                    self._misses += 1
                    get_registry().inc_counter("prefix.misses_total")
                    return None
                covered = (i + 1) * bs
                blocks = [n.block for n in path[:i + 1]]
                hit = PrefixHit(blocks, covered, path[i].state,
                                path[i].token, covered == len(toks))
            self.pool.ref(hit.blocks)  # lifecycle-ok: refs handed to the caller (adopt_shared or unref on refusal)
            self._hits += 1
        get_registry().inc_counter("prefix.hits_total")
        return hit

    # -- indexing ------------------------------------------------------------
    def share(self, tokens_consumed, table, state, token=None):
        """Index the consumed prefix held by ``table``'s pages.

        Called by the engine at each block boundary during prefill (state
        snapshot only) and at prefill completion (``token`` = the first
        generated token, making the entry a terminal one). The cache takes
        its own pool reference on every newly indexed block. Returns True
        when the prefix is (now) indexed; injected faults skip indexing —
        that prefix simply stays cold."""
        try:
            maybe_inject("prefix.share", ConnectionError)
        except ConnectionError:
            return False
        if state is None or not tokens_consumed:
            return False
        bs = self.pool.block_size
        toks = [int(t) for t in tokens_consumed]
        with self._lock:
            self._tick += 1
            cur = self._root
            pos = 0
            j = 0
            while len(toks) - pos >= bs:
                chunk = tuple(toks[pos:pos + bs])
                child = cur.children.get(chunk)
                if child is None:
                    if j >= len(table.blocks):
                        return False
                    block = table.blocks[j]
                    self.pool.ref([block])  # lifecycle-ok: the cache's own ref; evict()/clear() unref it
                    child = _Entry(chunk, block, cur)
                    cur.children[chunk] = child
                child.tick = self._tick
                cur = child
                pos += bs
                j += 1
            rest = tuple(toks[pos:])
            if rest:
                tail = cur.tails.get(rest)
                if tail is None:
                    if j >= len(table.blocks):
                        return False
                    block = table.blocks[j]
                    self.pool.ref([block])  # lifecycle-ok: the cache's own ref; evict()/clear() unref it
                    tail = _Entry(rest, block, cur)
                    cur.tails[rest] = tail
                tail.tick = self._tick
                tail.state = state
                if token is not None:
                    tail.token = int(token)
            elif cur is not self._root:
                cur.state = state
                if token is not None:
                    cur.token = int(token)
        get_registry().inc_counter("prefix.shares_total")
        return True

    # -- eviction ------------------------------------------------------------
    def _entries(self):
        # requires-lock: _lock
        stack = [self._root]
        while stack:
            node = stack.pop()
            for tail in node.tails.values():
                yield tail
            for child in node.children.values():
                yield child
                stack.append(child)

    def evict(self, need):
        """Free up to ``need`` blocks, refcount-then-LRU: candidates are
        entries whose block the cache holds the *last* reference on
        (refcount == 1 — anything else frees no memory) and that index no
        deeper entries (leaf-first); among them, least-recently-touched
        falls first. Returns the number of blocks actually freed. Injected
        faults are swallowed — eviction must complete."""
        try:
            maybe_inject("prefix.evict", ConnectionError)
        except ConnectionError:
            pass
        freed = 0
        with self._lock:
            while freed < need:
                victim = None
                for e in self._entries():
                    if e.children or e.tails:
                        continue
                    if self.pool.refcount(e.block) != 1:
                        continue
                    if victim is None or e.tick < victim.tick:
                        victim = e
                if victim is None:
                    break
                parent = victim.parent
                if parent.tails.get(victim.chunk) is victim:
                    del parent.tails[victim.chunk]
                else:
                    parent.children.pop(victim.chunk, None)
                self.pool.unref([victim.block])
                freed += 1
        if freed:
            get_registry().inc_counter("prefix.evictions_total", freed)
        return freed

    def clear(self):
        """Drop every cache reference (engine drain / shutdown). Blocks
        still shared with live streams just lose the cache's reference;
        cold blocks return to the pool. After ``clear`` + stream drain the
        pool's refcount map is empty — the audit soaks assert exactly
        that."""
        try:
            maybe_inject("prefix.evict", ConnectionError)
        except ConnectionError:
            pass
        with self._lock:
            dropped = [e.block for e in self._entries()]
            self._root = _Entry((), None, None)
            for b in dropped:
                self.pool.unref([b])
        if dropped:
            get_registry().inc_counter("prefix.evictions_total", len(dropped))
        return len(dropped)

    # -- observability -------------------------------------------------------
    def blocks(self):
        """Set of block ids the cache currently holds references on."""
        with self._lock:
            return {e.block for e in self._entries()}

    def held(self):
        """Number of pool blocks the cache currently holds references on —
        subtracted from ``pool.used()`` by leak audits (cache retention is
        intentional, not a leak)."""
        with self._lock:
            return sum(1 for _ in self._entries())

    def stats(self):
        with self._lock:
            entries = sum(1 for _ in self._entries())
        return {"hits": self._hits, "misses": self._misses,
                "entries": entries}
