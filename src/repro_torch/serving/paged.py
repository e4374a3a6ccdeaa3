"""Paged KV pool bookkeeping: ref-counted blocks, prefix dedup, COW, LRU.

A copy of ``repro.serving.paged`` (pure Python, no framework): the port
keeps its own so it imports nothing of ``repro``.

The device side of the paged cache is a dict of tensors (see
``model.init_paged_cache``): every KV leaf is ``(repeats, num_blocks,
block_tokens, ...)`` and each scheduler slot owns a row of an ``(slots,
max_blocks)`` int32 block table.  This module is the HOST side: which
physical block holds which chained prefix hash, who references it, and
what to copy when a shared block must be written (copy-on-write).

Invariants:

* Physical block 0 is the TRASH block — never allocated, never hashed.
  Unmapped table entries point at it, so decode writes from freed slots
  and pad positions land somewhere harmless instead of corrupting live
  rows.
* A block with ``ref > 0`` is pinned: eviction only ever pops
  unreferenced blocks (LRU order), so "eviction never corrupts a live
  row" holds by construction.
* A hash-registered block is immutable: writers must go through
  :meth:`ensure_writable`, which COWs any block that is shared
  (``ref > 1``) **or** discoverable via the hash map — otherwise a
  future prefix match would read half-rewritten content.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

TRASH_BLOCK = 0


@dataclass
class _Block:
    ref: int = 0
    hash: Optional[int] = None   # chain hash when registered (immutable)


@dataclass
class PoolStats:
    hit_blocks: int = 0          # matched (reused) full blocks at admission
    miss_blocks: int = 0         # freshly allocated blocks at admission
    cow_copies: int = 0
    evictions: int = 0
    cached_tokens: int = 0       # prompt tokens served from cache
    prefill_tokens: int = 0      # prompt tokens actually prefilled

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class BlockPool:
    """Host-side allocator for one member's paged KV pool.

    ``num_blocks`` counts physical blocks INCLUDING the reserved trash
    block; callers size it at least ``1 + slots * max_blocks_per_row``
    so a full batch of uncached rows always fits, plus headroom for the
    retained (ref == 0, hash-registered) cache that prefix matches feed
    on.  Thread-safe, though the scheduler already serializes access.
    """

    def __init__(self, num_blocks: int, block_tokens: int):
        if num_blocks < 2:
            raise ValueError("need at least one non-trash block")
        self.num_blocks = num_blocks
        self.block_tokens = block_tokens
        self._blocks: List[_Block] = [_Block() for _ in range(num_blocks)]
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # pop()->1
        self._hash2blk: Dict[int, int] = {}
        # ref==0 hash-registered blocks, LRU order (oldest first)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._lock = threading.Lock()
        self.stats = PoolStats()

    # -- queries ------------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free) + len(self._lru)

    def ref(self, bid: int) -> int:
        return self._blocks[bid].ref

    def live_refs(self) -> int:
        """Total outstanding references across all blocks — 0 when every
        row has released (leak check for preemption park/resume)."""
        with self._lock:
            return sum(b.ref for b in self._blocks)

    def releasable(self, row: Sequence[int]) -> int:
        """How many of ``row``'s blocks would actually free up if the row
        released them now — blocks shared with another row (``ref > 1``)
        stay pinned.  The preemption precheck uses this to decide whether
        parking a victim can possibly make an admission fit."""
        with self._lock:
            return sum(1 for bid in row
                       if bid != TRASH_BLOCK and self._blocks[bid].ref == 1)

    def register(self, row: Sequence[int], hashes: Sequence[int]) -> None:
        """Register chain hashes for a row's (already written) full blocks
        so later admissions can prefix-match them.  Called at PREFILL
        COMPLETION, not admission: under chunked prefill a block's hash
        must not be discoverable before its KV content exists."""
        with self._lock:
            for bid, h in zip(row, hashes):
                self._register_locked(bid, h)

    def match(self, hashes: Sequence[int]) -> int:
        """Number of leading full blocks already resident (chain hashes
        make any hit a prefix hit, so a simple count suffices)."""
        with self._lock:
            n = 0
            for h in hashes:
                if h in self._hash2blk:
                    n += 1
                else:
                    break
            return n

    # -- admission ----------------------------------------------------------

    def admit(self, matched_hashes: Sequence[int], total_blocks: int,
              new_hashes: Sequence[int] = ()) -> Optional[List[int]]:
        """Build a row's block list: ref the ``matched_hashes`` blocks,
        allocate ``total_blocks - len(matched)`` fresh ones.

        ``new_hashes`` are chain hashes for the row's *own* full prompt
        blocks beyond the matched prefix; they are registered eagerly
        (vLLM-style "cached while computing") so concurrent admissions
        in the same batch dedup against this row too.  Returns the block
        ids (table order) or ``None`` if the pool cannot satisfy the
        request — callers leave the request queued.
        """
        with self._lock:
            matched: List[int] = []
            for h in matched_hashes:
                bid = self._hash2blk.get(h)
                if bid is None:       # raced with eviction: treat as miss
                    break
                matched.append(bid)
            need = total_blocks - len(matched)
            if need > len(self._free) + len(self._lru):
                return None           # OOM: caller retries later
            for bid in matched:
                self._ref_inc(bid)
            fresh: List[int] = []
            for i in range(need):
                bid = self._alloc_locked()
                self._blocks[bid].ref = 1
                fresh.append(bid)
            for i, h in enumerate(new_hashes):
                if i < len(fresh):
                    self._register_locked(fresh[i], h)
            self.stats.hit_blocks += len(matched)
            self.stats.miss_blocks += len(fresh)
            return matched + fresh

    def ensure_writable(self, row: List[int], first_write_block: int,
                        exempt=()) -> List[Tuple[int, int]]:
        """COW every block of ``row`` from ``first_write_block`` on that
        is unsafe to write in place (shared, or hash-registered — a later
        matcher must never read half-rewritten content).  ``exempt``
        blocks were freshly allocated for this very row and are writable
        even though eagerly registered.  Updates ``row`` ids in place;
        returns ``(src, dst)`` device-copy pairs."""
        copies: List[Tuple[int, int]] = []
        exempt = set(exempt)
        with self._lock:
            for i in range(first_write_block, len(row)):
                bid = row[i]
                if bid in exempt:
                    continue
                blk = self._blocks[bid]
                if blk.ref == 1 and blk.hash is None:
                    continue
                dst = self._alloc_locked()
                self._blocks[dst].ref = 1
                self._ref_dec(bid)
                row[i] = dst
                copies.append((bid, dst))
                self.stats.cow_copies += 1
            return copies

    def release(self, row: Sequence[int],
                full_hashes: Sequence[int] = ()) -> None:
        """Drop a finished row's references.  ``full_hashes`` chains the
        row's full blocks (prompt + decoded tokens) so its KV content
        stays discoverable for future prefix matches until evicted."""
        with self._lock:
            for i, bid in enumerate(row):
                if bid == TRASH_BLOCK:
                    continue
                if i < len(full_hashes):
                    self._register_locked(bid, full_hashes[i])
                self._ref_dec(bid)

    # -- internals (call with lock held) ------------------------------------

    def _alloc_locked(self) -> int:
        if self._free:
            return self._free.pop()
        if self._lru:                     # evict coldest retained block
            bid, _ = self._lru.popitem(last=False)
            blk = self._blocks[bid]
            if blk.hash is not None and self._hash2blk.get(blk.hash) == bid:
                del self._hash2blk[blk.hash]
            blk.hash = None
            self.stats.evictions += 1
            return bid
        raise RuntimeError("BlockPool exhausted (admit() guards this)")

    def _register_locked(self, bid: int, h: int) -> None:
        blk = self._blocks[bid]
        if blk.hash == h:
            return
        if h in self._hash2blk:           # duplicate content: keep first
            return
        blk.hash = h
        self._hash2blk[h] = bid

    def _ref_inc(self, bid: int) -> None:
        blk = self._blocks[bid]
        if blk.ref == 0:
            self._lru.pop(bid, None)      # un-retire
        blk.ref += 1

    def _ref_dec(self, bid: int) -> None:
        blk = self._blocks[bid]
        assert blk.ref > 0, f"double free of block {bid}"
        blk.ref -= 1
        if blk.ref == 0:
            if blk.hash is not None:
                self._lru[bid] = None     # retained: evictable, matchable
                self._lru.move_to_end(bid)
            else:
                self._free.append(bid)    # partial block: recycle now
