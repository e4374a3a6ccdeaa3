"""Host-side text statistics, a copy of ``repro.core.textstats``: the
analogue of the paper's Rust "NLP binding" runtime (§11.7) — BM25,
character n-gram Jaccard, and statistical language identification.  These
are sub-millisecond string algorithms with no accelerator analogue.
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_WORD_RE = re.compile(r"[\w']+")


def tokenize_words(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def char_ngrams(text: str, n: int = 3) -> set:
    t = f" {text.lower()} "
    return {t[i: i + n] for i in range(max(0, len(t) - n + 1))}


def jaccard(a: set, b: set) -> float:
    if not a and not b:
        return 0.0
    inter = len(a & b)
    return inter / max(1, len(a) + len(b) - inter)


def ngram_similarity(a: str, b: str, n: int = 3) -> float:
    return jaccard(char_ngrams(a, n), char_ngrams(b, n))


class BM25:
    """Okapi BM25 over a small corpus (keyword rules / RAG rerank)."""

    def __init__(self, docs: Sequence[str], k1: float = 1.2, b: float = 0.75):
        self.k1, self.b = k1, b
        self.docs = [tokenize_words(d) for d in docs]
        self.doc_len = [len(d) for d in self.docs]
        self.avg_len = sum(self.doc_len) / max(1, len(self.docs))
        self.tf: List[Counter] = [Counter(d) for d in self.docs]
        df: Counter = Counter()
        for d in self.docs:
            df.update(set(d))
        n = max(1, len(self.docs))
        self.idf = {t: math.log(1 + (n - c + 0.5) / (c + 0.5))
                    for t, c in df.items()}

    def score(self, query: str, doc_idx: int) -> float:
        q = tokenize_words(query)
        tf = self.tf[doc_idx]
        dl = self.doc_len[doc_idx] or 1
        s = 0.0
        for term in q:
            if term not in tf:
                continue
            f = tf[term]
            idf = self.idf.get(term, 0.0)
            s += idf * f * (self.k1 + 1) / (
                f + self.k1 * (1 - self.b + self.b * dl / self.avg_len))
        return s

    def scores(self, query: str) -> List[float]:
        return [self.score(query, i) for i in range(len(self.docs))]


def bm25_keyword_score(keyword: str, text: str, k1=1.2, b=0.75) -> float:
    """Score one keyword against the request text (keyword-signal BM25
    method): the request is the document, the keyword the query."""
    bm = BM25([text], k1=k1, b=b)
    return bm.score(keyword, 0)


# ---------------------------------------------------------------------------
# language identification: character n-gram profiles (van Noord-style)
# ---------------------------------------------------------------------------

_LANG_PROFILES: Dict[str, Dict[str, float]] = {
    "en": {" th": 3.0, "the": 3.0, " an": 1.5, "and": 1.6, "ing": 1.8,
           " of": 1.4, "ion": 1.2, " to": 1.4, "ed ": 1.2, " is": 1.1,
           "at ": 0.9, "er ": 0.9, " wh": 0.8, "ou": 0.6, "ly ": 0.8},
    "es": {" de": 2.6, " la": 2.0, "os ": 1.6, " el": 1.5, "de ": 2.2,
           "ión": 1.4, " qu": 1.4, "ar ": 1.2, " es": 1.5, "ción": 1.3,
           "ñ": 2.0, "¿": 3.0, " un": 1.2, "la ": 1.6},
    "fr": {" de": 2.4, " le": 2.0, "es ": 1.6, " la": 1.6, "ent": 1.4,
           "ou": 1.0, " qu": 1.4, "é": 1.8, "è": 1.6, " un": 1.1,
           "tion": 1.2, " es": 0.8, "aux": 0.9, "ç": 1.8},
    "de": {" de": 1.8, "der": 2.0, "ie ": 1.8, "ein": 1.6, "sch": 1.8,
           "ich": 1.8, "und": 2.2, " zu": 1.3, "ung": 1.6, "ä": 1.5,
           "ö": 1.4, "ü": 1.5, "ß": 2.0, "en ": 1.6},
    "zh": {}, "ja": {}, "ko": {}, "ru": {}, "ar": {}, "hi": {},
}


def detect_language(text: str) -> Tuple[str, float]:
    """Returns (lang_code, confidence).  Script-based for CJK etc.,
    n-gram profile scoring for latin languages."""
    if not text:
        return "en", 0.0
    counts = Counter()
    for ch in text:
        cp = ord(ch)
        if 0x4E00 <= cp <= 0x9FFF:
            counts["zh"] += 1
        elif 0x3040 <= cp <= 0x30FF:
            counts["ja"] += 1
        elif 0xAC00 <= cp <= 0xD7AF:
            counts["ko"] += 1
        elif 0x0400 <= cp <= 0x04FF:
            counts["ru"] += 1
        elif 0x0600 <= cp <= 0x06FF:
            counts["ar"] += 1
        elif 0x0900 <= cp <= 0x097F:
            counts["hi"] += 1
    n_script = sum(counts.values())
    if n_script > max(3, 0.2 * len(text)):
        lang, c = counts.most_common(1)[0]
        return lang, min(1.0, c / max(1, n_script))

    low = f" {text.lower()} "
    scores = {}
    for lang, prof in _LANG_PROFILES.items():
        if not prof:
            continue
        s = sum(w * low.count(g) for g, w in prof.items())
        scores[lang] = s / max(1.0, len(low) / 10.0)
    if not scores:
        return "en", 0.1
    best = max(scores, key=scores.get)
    total = sum(scores.values()) or 1.0
    return best, min(1.0, scores[best] / total)


def estimate_tokens(text: str) -> int:
    """~4 chars/token heuristic (paper §10.8 uses the same estimate)."""
    return max(1, len(text) // 4)
