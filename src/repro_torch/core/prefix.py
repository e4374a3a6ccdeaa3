"""Chained token-block hashes (copy of ``repro.core.prefix.chain_hashes``).

vLLM-style chained block hashes over token ids: the hash of block ``i``
folds in the hash of block ``i-1``, so holding hash ``h_k`` implies
holding the entire k-block prefix.  Only FULL blocks are hashed — a
partial tail block is never shareable.  The chaining (blake2s, seed,
little-endian packing) is byte-identical to the reference, so both
packages key the same prefixes to the same hashes.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

# Token-block granularity shared by the router index and the paged KV pool.
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
