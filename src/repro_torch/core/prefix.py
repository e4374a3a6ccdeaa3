"""Prefix-cache index: chained token-block hashes + a hashtrie over them.
A copy of ``repro.core.prefix``.

The router and the serving engine share one view of "which prefixes are
hot where" through two primitives:

* :func:`chain_hashes` — vLLM-style chained block hashes over token ids.
  The hash of block ``i`` folds in the hash of block ``i-1``, so holding
  hash ``h_k`` implies holding the entire k-block prefix; a flat
  ``hash -> holder`` map therefore behaves like a trie without storing
  edges.  Only FULL blocks are hashed — a partial tail block is never
  shareable.
* :class:`PrefixIndex` — the trie itself, mapping each chain hash to the
  set of *holders* (fleet members / endpoints) whose KV pool contains
  that block.  ``match()`` walks the chain until it falls off the trie
  and reports the deepest match per holder, which ``stage_select`` turns
  into an affinity score composable with every selection algorithm.

Routers see text, not engine tokens, so :func:`text_block_hashes`
canonicalizes a request body the same way the local fleet's stub
tokenizer does (one hash token per whitespace word, fixed vocab) —
optimistic but deterministic, and exact for the local fleet.  The engine
side (``serving/paged.py``) uses :func:`chain_hashes` over real token
ids for the authoritative block dedup.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

# Token-block granularity shared by the router index and the paged KV
# pool.  Smaller blocks match more aggressively but cost more table
# entries; 16 matches the reduced-config max_seq (160) at 10 blocks/row.
BLOCK_TOKENS = 16

_SEED = 0x5F3759DF  # chain seed, any fixed value


def _hash_block(prev: int, ids: Sequence[int]) -> int:
    h = hashlib.blake2s(digest_size=8)
    h.update(prev.to_bytes(8, "little"))
    for t in ids:
        h.update(int(t).to_bytes(4, "little", signed=False))
    return int.from_bytes(h.digest(), "little")


def chain_hashes(ids: Sequence[int], block_tokens: int = BLOCK_TOKENS
                 ) -> List[int]:
    """Chained hashes of the FULL blocks of ``ids`` (partial tail dropped).

    ``out[i]`` identifies the entire ``(i+1)*block_tokens``-token prefix.
    """
    out: List[int] = []
    prev = _SEED ^ block_tokens
    for s in range(0, len(ids) - block_tokens + 1, block_tokens):
        prev = _hash_block(prev, ids[s:s + block_tokens])
        out.append(prev)
    return out


def text_token_ids(text: str, vocab: int = 4096) -> List[int]:
    """Canonical router-side tokenization: one stable hash token per
    whitespace word (mirrors the local fleet's stub tokenizer, modulo
    vocab size — chain hashes only need determinism, not the same ids)."""
    return [int.from_bytes(hashlib.blake2s(w.encode("utf-8", "ignore"),
                                           digest_size=4).digest(), "little")
            % vocab for w in text.split()]


def text_block_hashes(text: str, block_tokens: int = BLOCK_TOKENS
                      ) -> List[int]:
    return chain_hashes(text_token_ids(text), block_tokens)


class _Node:
    __slots__ = ("holders", "children", "depth")

    def __init__(self, depth: int):
        self.holders: Dict[str, int] = {}   # holder -> touch tick
        self.children: set = set()          # child chain hashes
        self.depth = depth


class PrefixIndex:
    """Hashtrie over chained block hashes: holder -> cached-prefix depth.

    Thread-safe; bounded by ``max_nodes`` with LRU eviction (evicting a
    node removes its whole subtree — a chain broken mid-way is
    unreachable anyway, because ``match`` walks from the root hash).
    This is an *optimistic* index: it says where a prefix is likely
    cached, the engine's ref-counted pool is the ground truth, so a
    stale entry costs a wasted preference, never correctness.
    """

    def __init__(self, max_nodes: int = 100_000):
        self.max_nodes = max_nodes
        self._nodes: "OrderedDict[int, _Node]" = OrderedDict()
        self._lock = threading.Lock()
        self._tick = 0
        self.inserts = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def insert(self, holder: str, hashes: Sequence[int]) -> None:
        """Record that ``holder`` now caches the blocks of ``hashes``."""
        if not hashes:
            return
        with self._lock:
            self._tick += 1
            prev: Optional[_Node] = None
            for depth, h in enumerate(hashes):
                node = self._nodes.get(h)
                if node is None:
                    node = _Node(depth)
                    self._nodes[h] = node
                node.holders[holder] = self._tick
                self._nodes.move_to_end(h)
                if prev is not None:
                    prev.children.add(h)
                prev = node
            self.inserts += 1
            while len(self._nodes) > self.max_nodes:
                self._evict_one()

    def match(self, hashes: Sequence[int],
              holders: Optional[Iterable[str]] = None) -> Dict[str, int]:
        """Deepest cached-prefix depth (in blocks) per holder.

        Walks the chain from the root; a holder's depth is the number of
        consecutive leading blocks it caches.  ``holders`` restricts the
        candidate set (e.g. the decision's model pool)."""
        want = set(holders) if holders is not None else None
        best: Dict[str, int] = {}
        with self._lock:
            alive = None if want is None else set(want)
            for depth, h in enumerate(hashes, start=1):
                node = self._nodes.get(h)
                if node is None:
                    break
                here = set(node.holders)
                if alive is not None:
                    here &= alive
                if not here:
                    break
                for hld in here:
                    best[hld] = depth
                alive = here
                self._nodes.move_to_end(h)
            return best

    def remove_holder(self, holder: str) -> None:
        """Drop every block attributed to ``holder`` (e.g. endpoint gone)."""
        with self._lock:
            dead = []
            for h, node in self._nodes.items():
                node.holders.pop(holder, None)
                if not node.holders:
                    dead.append(h)
            for h in dead:
                self._drop_subtree(h)

    # -- internals ----------------------------------------------------------

    def _evict_one(self) -> None:
        h = next(iter(self._nodes))
        self._drop_subtree(h)
        self.evictions += 1

    def _drop_subtree(self, h: int) -> None:
        node = self._nodes.pop(h, None)
        if node is None:
            return
        for c in list(node.children):
            self._drop_subtree(c)
