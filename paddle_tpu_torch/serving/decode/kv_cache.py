"""Paged KV-cache allocator: fixed block pool + per-stream block tables
(port of paddle_tpu/serving/decode/kv_cache.py).

The decode-serving memory problem (vLLM, SOSP'23): a naive per-request KV
cache reserves ``max_seq_len`` worth of memory per stream up front, so
occupancy collapses to the worst-case prompt. Paging fixes it the way an OS
does — the cache is a fixed pool of equal-size **blocks** (``block_size``
tokens each) and every stream holds a **block table**, growing one block at
a time as tokens are appended.

This allocator is the admission side of that design, mirroring the bucket
discipline of :mod:`~paddle_tpu_torch.serving.batcher`: capacity is claimed in
fixed quanta (blocks, like bucket padding) so the pool's state space is
small and exhaustively testable. Exhaustion is **OOM-safe by construction**:

- :meth:`KVBlockPool.try_allocate` returns None instead of raising when the
  pool is short — the engine turns a short *join* into a typed
  :class:`~paddle_tpu_torch.serving.batcher.ServerOverloaded` refusal (with a
  retry_after hint) and a short mid-stream *grow* into a typed
  :class:`KVCacheExhausted` eviction. Nothing in this module ever crashes
  the serving loop;
- every block is freed exactly once **per reference** (double-free raises —
  that's a server bug, not load);
- occupancy is observable: ``decode.kv_blocks_used_count`` /
  ``decode.kv_blocks_free_count`` gauges in the always-on metrics registry.

Prefix sharing (:mod:`.prefix`) adds reference counting on top: a block
allocated by one stream can be ref'd by the prefix cache and by later
streams whose prompts share the prefix it holds (RadixAttention, SGLang).
``ref``/``unref`` are the primitives; ``release`` is one ``unref`` per
block, so the exactly-once-per-reference discipline is unchanged for
callers that never share. :meth:`BlockTable.ensure_writable` is the
copy-on-write fork: the first divergent write to a shared block allocates
a private replacement and drops the shared reference.
"""
from __future__ import annotations

import threading

from ...framework.errors import ResourceExhaustedError

__all__ = ["KVCacheExhausted", "KVBlockPool", "BlockTable"]


def _flag(name, default):
    from ...framework.flags import get_flag
    v = get_flag(name, default)
    return default if v is None else v


class KVCacheExhausted(ResourceExhaustedError):
    """A running stream needed one more KV block and the pool was empty.
    The engine evicts the stream with this error (typed, carries the
    admission controller's ``retry_after`` hint) — accepted streams
    terminate, they never silently stall."""

    def __init__(self, message="", retry_after=None):
        super().__init__(message)
        self.retry_after = retry_after


class KVBlockPool:
    """Fixed pool of ``num_blocks`` KV pages, ``block_size`` tokens each.

    Pure accounting — the tensor storage the block ids index lives with the
    decode backend. Allocation is LIFO over the free list so recently freed
    (cache-warm) blocks are reused first, the same recency discipline the
    batcher's executor LRU applies to compiled programs.
    """

    def __init__(self, num_blocks=None, block_size=None):
        self.num_blocks = int(num_blocks if num_blocks is not None
                              else _flag("FLAGS_decode_kv_blocks", 256))
        self.block_size = int(block_size if block_size is not None
                              else _flag("FLAGS_decode_block_size", 16))
        if self.num_blocks < 1 or self.block_size < 1:
            raise ValueError(
                f"need >= 1 block of >= 1 token: num_blocks="
                f"{self.num_blocks} block_size={self.block_size}")
        self._free = list(range(self.num_blocks - 1, -1, -1))
        # Persistent mirror of ``_free`` for O(1) membership: release/unref
        # must not rebuild a set per call (O(pool) on every stream finish).
        # The list keeps LIFO order (warm-block reuse); the set keeps the
        # double-free check cheap. Both are only touched under ``_lock``.
        self._free_set = set(self._free)
        # Reference counts for allocated blocks only (missing == free).
        # try_allocate starts a block at 1; prefix sharing refs it higher.
        self._refs = {}
        self._lock = threading.Lock()
        from ...profiler.metrics import get_registry
        get_registry().register_gauge_fn(
            "decode.kv_blocks_used_count", self.used)
        get_registry().register_gauge_fn(
            "decode.kv_blocks_free_count", self.free)

    # -- accounting ----------------------------------------------------------
    def blocks_for(self, tokens):
        """Blocks needed to hold ``tokens`` token slots (ceil division)."""
        if tokens <= 0:
            return 0
        return -(-int(tokens) // self.block_size)

    def free(self):
        with self._lock:
            return len(self._free)

    def used(self):
        with self._lock:
            return self.num_blocks - len(self._free)

    def can_allocate(self, n):
        with self._lock:
            return len(self._free) >= n

    # -- allocation ----------------------------------------------------------
    def try_allocate(self, n):
        """Claim ``n`` blocks; returns their ids, or None when the pool is
        short — never raises on exhaustion (the caller owns the refusal /
        eviction policy)."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                return None
            taken = [self._free.pop() for _ in range(n)]
            for b in taken:
                self._free_set.discard(b)
                self._refs[b] = 1
        return taken

    # -- reference counting --------------------------------------------------
    def ref(self, block_ids):
        """Take one extra reference on each (allocated) block — the prefix
        cache and warm-join streams share pages this way. Ref'ing a free or
        out-of-range block is a server bug and raises; nothing is counted
        unless every id is valid (the check runs before any increment)."""
        with self._lock:
            for b in block_ids:
                if b in self._free_set or b not in self._refs:
                    raise ValueError(f"ref of unallocated KV block {b}")
            for b in block_ids:
                self._refs[b] += 1

    def unref(self, block_ids):
        """Drop one reference per block; a block returns to the free list
        only when its last reference is dropped. Over-unref is the
        double-free bug and raises."""
        with self._lock:
            for b in block_ids:
                n = self._refs.get(b)
                if n is None or not (0 <= b < self.num_blocks):
                    raise ValueError(f"double/invalid free of KV block {b}")
                if n > 1:
                    self._refs[b] = n - 1
                else:
                    del self._refs[b]
                    self._free.append(b)
                    self._free_set.add(b)

    def refcount(self, block):
        """Current reference count of ``block`` (0 when free)."""
        with self._lock:
            return self._refs.get(block, 0)

    def refcounts(self):
        """Snapshot of all non-zero refcounts — drain audits assert this is
        empty once every stream and the prefix cache have let go."""
        with self._lock:
            return dict(self._refs)

    def release(self, block_ids):
        """Return blocks to the pool — exactly one ``unref`` per block, so
        a table release frees privately-owned pages and merely detaches
        from shared ones. Double-free is a server bug and raises — silent
        double-frees corrupt the table-to-storage mapping."""
        self.unref(block_ids)


class BlockTable:
    """One stream's page table: the ordered block ids holding its KV cache.

    ``ensure(tokens)`` grows the table to cover ``tokens`` token slots,
    claiming blocks from the pool; it returns False (stream must be evicted
    or refused) instead of raising when the pool is exhausted.
    """

    __slots__ = ("pool", "blocks", "num_tokens")

    def __init__(self, pool):
        self.pool = pool
        self.blocks = []
        self.num_tokens = 0

    def capacity(self):
        return len(self.blocks) * self.pool.block_size

    def ensure(self, tokens):
        """Grow to hold ``tokens`` slots. True on success; False when the
        pool can't supply the missing blocks (nothing is claimed then —
        a partial grow would leak on the eviction that must follow)."""
        need = self.pool.blocks_for(tokens) - len(self.blocks)
        if need > 0:
            got = self.pool.try_allocate(need)
            if got is None:
                return False
            self.blocks.extend(got)
        self.num_tokens = max(self.num_tokens, int(tokens))
        return True

    def truncate(self, tokens):
        """Shrink to hold ``tokens`` slots, returning now-unused whole
        blocks to the pool — the cleanup after rejected draft tokens
        (specdecode) so speculation never inflates steady-state KV
        footprint. The partially-filled tail block is kept. Never fails;
        returns the number of blocks released."""
        tokens = max(0, int(tokens))
        self.num_tokens = min(self.num_tokens, tokens)
        keep = self.pool.blocks_for(tokens)
        if keep >= len(self.blocks):
            return 0
        dropped, self.blocks = self.blocks[keep:], self.blocks[:keep]
        self.pool.release(dropped)
        return len(dropped)

    def adopt_shared(self, blocks, tokens, ref_held=False):
        """Append already-allocated **shared** blocks (a prefix-cache hit)
        covering ``tokens`` token slots. Takes one pool reference per block
        unless the caller already holds them (``ref_held=True``, the
        lookup-then-adopt handoff); either way this table now owns one
        reference per page and ``release()``/``truncate()`` drop them."""
        blocks = list(blocks)
        if not ref_held and blocks:
            self.pool.ref(blocks)  # lifecycle-ok: refs owned by this table; release()/truncate() unref them
        self.blocks.extend(blocks)
        self.num_tokens = max(self.num_tokens, int(tokens))

    def ensure_writable(self, pos):
        """Copy-on-write fork: before writing token slot ``pos`` (and
        beyond), every covering block must be privately owned. Each shared
        block from ``pos``'s block onward is forked — a fresh block claimed
        from the pool replaces it in this table and the shared original
        loses one reference. Returns False when the pool cannot supply a
        fork block (nothing is changed for that block; the caller evicts or
        refuses, same contract as ``ensure``).

        Pure accounting, like the pool itself: the reference backend keys
        KV state by stream, so the fork needs no data copy; a real paged
        backend would copy the page at the ids this method reports via the
        table's block list."""
        i = max(0, int(pos)) // self.pool.block_size
        for k in range(i, len(self.blocks)):
            b = self.blocks[k]
            if self.pool.refcount(b) <= 1:
                continue
            got = self.pool.try_allocate(1)
            if got is None:
                return False
            self.blocks[k] = got[0]
            self.pool.unref([b])
        return True

    def pages(self):
        """``(block_id, tokens_held)`` per page in table order — the unit a
        KV migration (serving/decode/kv_migrate.py) exports one wire frame
        for. The final page may be partially filled."""
        remaining = self.num_tokens
        for b in self.blocks:
            held = min(self.pool.block_size, max(0, remaining))
            remaining -= held
            yield b, held

    def release(self):
        """Free every block exactly once (idempotent per table)."""
        blocks, self.blocks = self.blocks, []
        self.num_tokens = 0
        if blocks:
            self.pool.release(blocks)

    def describe(self):
        return {"blocks": list(self.blocks), "tokens": self.num_tokens,
                "capacity": self.capacity()}
