"""The one traffic generator: every mix is a data file of parameters
(``mixes/<name>.json``) that this module reads.

Requests are indexed by their place in the stream.  Request ``i`` is a
pure function of ``(seed, mix, i)``, so the same seed gives the same
requests, and any prefix of the stream can be regenerated.

So that seeds change the order of the work and not its amount, sizes and
arrival gaps are stratified: within each block of ``block`` requests the
prompt lengths are the ``block`` mid-quantiles of the length law (log-uniform
between ``low`` and ``high``), in an order drawn from the seed; the open
loop's gaps are the mid-quantiles of the exponential law, normalised to a
mean of ``1 / rate_per_s`` and shuffled the same way, each block starting
at exactly ``block / rate_per_s`` times its index.  A window that spans
whole blocks thus holds the same requests' sizes and gaps under every
seed, in another order.  Exactly one request
of each group of ``pii_every`` carries a social security number (the
router blocks it); which one is drawn from the seed.

Words come from a fixed lexicon of lowercase consonant-vowel pseudo-words,
so a prompt of ``n`` words is ``n`` tokens to the fleet's whitespace
tokenizer, no word is a keyword of the demo policy, and no word looks like
personal data.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional

import numpy as np

SSN_WORDS = ("my", "ssn", "is", "123-45-6789")

_CONS = "bcdfghklmnprstvz"
_VOWELS = "aeiou"


@lru_cache(maxsize=1)
def lexicon() -> tuple:
    """4096 distinct pseudo-words of three consonant-vowel syllables."""
    syl = [c + v for c in _CONS for v in _VOWELS]          # 80 syllables
    words = []
    for i in range(4096):
        a, b, c = i % 80, (i // 80) % 80, (i * 7 + 3) % 80
        words.append(syl[a] + syl[b] + syl[c])
    assert len(set(words)) == len(words)
    return tuple(words)


def _seed_words(seed: int) -> int:
    return int(seed) % (1 << 64)


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([_seed_words(seed), *keys])


def _mid_quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _log_uniform(q: np.ndarray, low: int, high: int) -> np.ndarray:
    lo, hi = math.log(low), math.log(high)
    return np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)


@dataclass(frozen=True)
class TrafficRequest:
    index: int
    text: str
    words: int            # whitespace-separated words == fleet tokens
    pii: bool             # carries an SSN: the router must block it
    due_s: float = 0.0    # open loop: offset of its due time from the start


class Traffic:
    """The stream of requests of one mix under one seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.seed = int(seed)
        self.block = int(mix["block"])
        self.pii_every = int(mix["pii_every"])
        if "question_words" in mix and math.gcd(5, self.block) != 1:
            raise ValueError("a mix with questions needs a block size "
                             "coprime to 5")
        self._lengths: dict = {}
        self._gaps: dict = {}

    # -- stratified laws ---------------------------------------------------
    def _block_lengths(self, b: int, key: str, pair: int = 1) -> np.ndarray:
        """Block ``b``'s lengths of the law ``key``, in the block's order.
        A second law (the question) is paired with the first by the fixed
        map k -> (pair * k + 3) mod block of their quantile ranks, so every
        seed holds the same (document, question) pairs."""
        k = (b, key)
        if k not in self._lengths:
            law = self.mix[key]
            vals = _log_uniform(_mid_quantiles(self.block), law["low"],
                                law["high"])
            rank = _rng(self.seed, b, 1).permutation(self.block)
            if pair != 1:
                rank = (pair * rank + 3) % self.block
            self._lengths[k] = vals[rank]
        return self._lengths[k]

    def _block_gaps(self, b: int) -> np.ndarray:
        if b not in self._gaps:
            g = -np.log1p(-_mid_quantiles(self.block))
            g = g / g.mean() / float(self.mix["rate_per_s"])
            self._gaps[b] = g[_rng(self.seed, b, 4).permutation(self.block)]
        return self._gaps[b]

    def prompt_words(self, i: int) -> int:
        b, j = divmod(i, self.block)
        n = int(self._block_lengths(b, "prompt_words")[j])
        if "question_words" in self.mix:
            n += int(self._block_lengths(b, "question_words", pair=5)[j])
        return n

    def is_pii(self, i: int) -> bool:
        g, j = divmod(i, self.pii_every)
        return j == int(_rng(self.seed, g, 3).integers(self.pii_every))

    def due_s(self, i: int) -> float:
        """Open loop: seconds from the start at which request ``i`` is due
        (the first is due at 0)."""
        if self.mix["loop"] != "open":
            return 0.0
        b, j = divmod(i, self.block)
        start = b * self.block / float(self.mix["rate_per_s"])
        return start + float(self._block_gaps(b)[:j].sum())

    # -- requests ----------------------------------------------------------
    def request(self, i: int) -> TrafficRequest:
        n = self.prompt_words(i)
        pii = self.is_pii(i)
        lex = lexicon()
        k = n - len(SSN_WORDS) if pii else n
        ids = _rng(self.seed, i, 5).integers(len(lex), size=k)
        words = [lex[w] for w in ids]
        if pii:
            words = list(SSN_WORDS) + words
        return TrafficRequest(index=i, text=" ".join(words), words=n,
                              pii=pii, due_s=self.due_s(i))

    def requests(self, n: int, start: int = 0) -> List[TrafficRequest]:
        return [self.request(i) for i in range(start, start + n)]


def warmup_requests(mix: dict, n: int, seed: int) -> List[TrafficRequest]:
    """``n`` requests that the router blocks (each carries an SSN), at the
    mix's longest prompt: they run every router stage at the batch sizes of
    the traffic and never reach the member.  A stream of their own, drawn
    apart from the timed one."""
    lex = lexicon()
    rng = _rng(seed, 1 << 40)
    hi = int(mix["prompt_words"]["high"])
    out = []
    for i in range(n):
        ids = rng.integers(len(lex), size=hi - len(SSN_WORDS))
        text = " ".join(list(SSN_WORDS) + [lex[w] for w in ids])
        out.append(TrafficRequest(index=-1 - i, text=text, words=hi,
                                  pii=True))
    return out


def prompt_cap(mix: dict) -> int:
    """The longest prompt the member admits: its ``max_seq`` less the
    answer and the token it is sampled from.  Longer prompts keep their
    tail."""
    return int(mix["max_seq"]) - int(mix["answer_tokens"]) - 1


def user_of(i: int) -> str:
    return f"user{i % 16}"


def lateness(due: List[float], sent: List[float]) -> Optional[float]:
    """How late the open-loop generator ran: the largest delay of a submit
    behind its due time, in seconds (None without requests)."""
    if not due:
        return None
    return max(s - d for d, s in zip(due, sent))
