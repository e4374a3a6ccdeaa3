"""Episodic conversation memory with ReflectionGate (§13.1).
A copy of ``repro.core.memory``.

Write path: entropy gate -> sanitize (UTF-8, 16KB cap) -> Q:/A: chunk ->
embed -> store; every s turns an additional sliding-window chunk over the
last w turns (defaults s=3, w=5).

Read path: heuristic retrieval gate -> hybrid search (vector + BM25 +
n-gram) -> ReflectionGate (safety blocklist, recency decay, Jaccard dedup,
budget cap) -> injection as a separate context message.

Background consolidation: greedy single-linkage clustering on word Jaccard.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core import textstats as TS
from repro_torch.core.plugins.base import register_plugin
from repro_torch.core.types import Message, Request, Response

MAX_ENTRY_BYTES = 16 * 1024
_GREETINGS = ("hi", "hello", "hey", "thanks", "thank you", "ok", "okay",
              "yes", "no", "bye", "goodbye", "cool", "great", "sure")
_BLOCK_PATTERNS = [re.compile(p, re.I) for p in (
    r"ignore (all )?previous instructions", r"system prompt",
    r"you are now", r"developer mode")]


@dataclass
class MemoryChunk:
    text: str
    embedding: np.ndarray
    user: str
    turn: int
    kind: str = "episodic"            # episodic | window | summary
    created: float = field(default_factory=time.time)


def entropy_gate(user_msg: str, assistant_msg: str) -> bool:
    """Discard turns with no retrievable signal (greetings, one-worders)."""
    words = TS.tokenize_words(user_msg)
    if len(words) <= 2 and " ".join(words) in _GREETINGS:
        return False
    if len(words) < 2 and len(TS.tokenize_words(assistant_msg)) < 4:
        return False
    uniq = len(set(words)) / max(1, len(words))
    return not (len(words) < 4 and uniq < 0.5)


def retrieval_gate(query: str) -> bool:
    """Skip memory lookup for queries where personal context is irrelevant."""
    ql = query.lower().strip()
    if not ql or ql in _GREETINGS:
        return False
    if any(ql.startswith(c) for c in ("what year", "who invented",
                                      "capital of", "define ")):
        return False
    return True


class MemoryStore:
    def __init__(self, embed_fn, window_every: int = 3, window_size: int = 5):
        self.embed_fn = embed_fn
        self.s, self.w = window_every, window_size
        self.chunks: Dict[str, List[MemoryChunk]] = {}
        self.history: Dict[str, List[tuple]] = {}

    # -- write path ----------------------------------------------------------
    def write_turn(self, user: str, user_msg: str, assistant_msg: str):
        hist = self.history.setdefault(user, [])
        hist.append((user_msg, assistant_msg))
        chunk = None
        if entropy_gate(user_msg, assistant_msg):
            text = f"Q: {user_msg}\nA: {assistant_msg}"
            text = text.encode("utf-8", "ignore")[:MAX_ENTRY_BYTES].decode(
                "utf-8", "ignore")
            chunk = MemoryChunk(text, self.embed_fn([text])[0], user,
                                len(hist))
            self.chunks.setdefault(user, []).append(chunk)
        # window chunks fire every s *turns* regardless of the entropy gate
        if len(hist) % self.s == 0:
            win = hist[-self.w:]
            wtext = "\n".join(f"Q: {q}\nA: {a}" for q, a in win)
            wtext = wtext.encode("utf-8", "ignore")[:MAX_ENTRY_BYTES].decode(
                "utf-8", "ignore")
            self.chunks.setdefault(user, []).append(MemoryChunk(
                wtext, self.embed_fn([wtext])[0], user, len(hist), "window"))
        return chunk

    # -- read path -------------------------------------------------------------
    def retrieve(self, user: str, query: str, *, top_k: int = 8,
                 mode: str = "weighted", weights=(0.7, 0.2, 0.1),
                 rrf_k: int = 60, embed_fn=None) -> List[MemoryChunk]:
        chunks = self.chunks.get(user, [])
        if not chunks or not retrieval_gate(query):
            return []
        q_emb = (embed_fn or self.embed_fn)([query])[0]
        vec = np.stack([c.embedding for c in chunks]) @ q_emb
        bm = np.asarray(TS.BM25([c.text for c in chunks]).scores(query))
        ng = np.asarray([TS.ngram_similarity(query, c.text)
                         for c in chunks])
        if mode == "rrf":
            score = np.zeros(len(chunks))
            for arr in (vec, bm, ng):
                ranks = np.argsort(-arr)
                for r, i in enumerate(ranks):
                    score[i] += 1.0 / (rrf_k + r + 1)
        else:
            bmn = bm / bm.max() if bm.max() > 0 else bm
            score = weights[0] * vec + weights[1] * bmn + weights[2] * ng
        order = np.argsort(-score)[: top_k * 2]
        return [chunks[i] for i in order]

    # -- consolidation --------------------------------------------------------
    def consolidate(self, user: str, threshold: float = 0.6):
        """Greedy single-linkage clustering on word-level Jaccard; each
        cluster collapses to one summary chunk."""
        chunks = self.chunks.get(user, [])
        if len(chunks) < 2:
            return 0
        sets = [set(TS.tokenize_words(c.text)) for c in chunks]
        clusters: List[List[int]] = []
        for i in range(len(chunks)):
            placed = False
            for cl in clusters:
                if any(TS.jaccard(sets[i], sets[j]) >= threshold for j in cl):
                    cl.append(i)
                    placed = True
                    break
            if not placed:
                clusters.append([i])
        merged = 0
        out: List[MemoryChunk] = []
        for cl in clusters:
            if len(cl) == 1:
                out.append(chunks[cl[0]])
                continue
            rep = max((chunks[j] for j in cl), key=lambda c: len(c.text))
            out.append(MemoryChunk(rep.text, rep.embedding, user, rep.turn,
                                   "summary"))
            merged += len(cl) - 1
        self.chunks[user] = out
        return merged


# ---------------------------------------------------------------------------
# ReflectionGate (§13.1 post-retrieval filtering)
# ---------------------------------------------------------------------------

def reflection_gate(chunks: List[MemoryChunk], *, now: Optional[float] = None,
                    half_life_s: float = 3600.0, dedup_threshold: float = 0.8,
                    budget: int = 4) -> List[MemoryChunk]:
    now = now or time.time()
    # 1. safety block-list
    safe = [c for c in chunks
            if not any(p.search(c.text) for p in _BLOCK_PATTERNS)]
    # 2. recency decay re-ranking
    scored = sorted(
        safe, key=lambda c: -(0.5 ** ((now - c.created) / half_life_s)
                              + (1.0 if c.kind == "summary" else 0.0) * 0.01))
    # 3. Jaccard dedup (keep first representative)
    kept: List[MemoryChunk] = []
    kept_sets: List[set] = []
    for c in scored:
        s = set(TS.tokenize_words(c.text))
        if any(TS.jaccard(s, ks) >= dedup_threshold for ks in kept_sets):
            continue
        kept.append(c)
        kept_sets.append(s)
    # 4. budget cap
    return kept[:budget]


# ---------------------------------------------------------------------------
# plugins
# ---------------------------------------------------------------------------

def memory_plugin(req: Request, ctx: Dict[str, Any], cfg: Dict[str, Any]):
    store: MemoryStore = ctx["memory"]
    user = req.user or "anonymous"
    hits = store.retrieve(user, req.latest_user_text,
                          top_k=cfg.get("top_k", 8),
                          mode=cfg.get("mode", "weighted"),
                          embed_fn=ctx.get("embed"))
    hits = reflection_gate(hits, budget=cfg.get("budget", 4),
                           half_life_s=cfg.get("half_life_s", 3600.0))
    if hits:
        # separate context message after system, before user turns
        block = "Relevant memory:\n" + "\n---\n".join(c.text for c in hits)
        msgs = list(req.messages)
        idx = next((i for i, m in enumerate(msgs) if m.role != "system"), 0)
        msgs.insert(idx, Message("system", block))
        req.messages = msgs
        req.metadata["memory_hits"] = len(hits)
    return req, None


def memory_write_plugin(req: Request, ctx, cfg):
    store: MemoryStore = ctx["memory"]
    resp: Response = cfg["response"]
    store.write_turn(req.user or "anonymous", req.latest_user_text,
                     resp.content)
    return req, None


register_plugin("memory", memory_plugin)
register_plugin("memory_write", memory_write_plugin)
