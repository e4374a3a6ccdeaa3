"""Retrieval-augmented generation plugin (§13.2).
A copy of ``repro.core.rag``.

Indexing: chunk (size/overlap) -> embed -> vector store.
Hybrid retrieval: vector cosine + BM25 (k1, b) + char-n-gram Jaccard,
fused by weighted sum or Reciprocal Rank Fusion; backends without native
hybrid search rerank a 4x top-k vector candidate set.  Score-range
awareness: RRF scores bypass cosine-calibrated thresholds (§13.2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.core import textstats as TS
from repro_torch.core.plugins.base import register_plugin
from repro_torch.core.types import Message, Request


@dataclass
class DocChunk:
    doc_id: str
    text: str
    embedding: np.ndarray


class VectorStoreBackend:
    """Common interface (§13.2): in-memory | milvus | llama_stack |
    external | mcp | openai_file_search.  Only in-memory executes here;
    the rest are deployment bindings that carry their connection config."""

    name = "memory"
    native_hybrid = False

    def __init__(self, embed_fn):
        self.embed_fn = embed_fn
        self.chunks: List[DocChunk] = []

    def index(self, docs: Dict[str, str], *, chunk_size: int = 512,
              overlap: int = 64):
        for doc_id, text in docs.items():
            step = max(1, chunk_size - overlap)
            for i in range(0, max(1, len(text) - overlap), step):
                piece = text[i: i + chunk_size]
                if piece.strip():
                    self.chunks.append(DocChunk(
                        doc_id, piece, self.embed_fn([piece])[0]))

    def vector_search(self, query: str, k: int,
                      embed_fn=None) -> List[Tuple[int, float]]:
        if not self.chunks:
            return []
        q = (embed_fn or self.embed_fn)([query])[0]
        sims = np.stack([c.embedding for c in self.chunks]) @ q
        order = np.argsort(-sims)[:k]
        return [(int(i), float(sims[i])) for i in order]


class HybridRetriever:
    def __init__(self, store: VectorStoreBackend, *, mode: str = "weighted",
                 weights=(0.7, 0.2, 0.1), bm25_k1=1.2, bm25_b=0.75,
                 ngram_n=3, rrf_k=60, threshold: float = 0.0):
        self.store = store
        self.mode = mode
        self.weights = weights
        self.bm25_k1, self.bm25_b = bm25_k1, bm25_b
        self.ngram_n = ngram_n
        self.rrf_k = rrf_k
        self.threshold = threshold

    def retrieve(self, query: str, top_k: int = 4,
                 embed_fn=None) -> List[DocChunk]:
        # generic rerank path: expand 4x candidates from vector search
        cands = self.store.vector_search(query, 4 * top_k, embed_fn=embed_fn)
        if not cands:
            return []
        idxs = [i for i, _ in cands]
        texts = [self.store.chunks[i].text for i in idxs]
        vec = np.asarray([s for _, s in cands])
        bm = np.asarray(TS.BM25(texts, self.bm25_k1, self.bm25_b)
                        .scores(query))
        ng = np.asarray([TS.ngram_similarity(query, t, self.ngram_n)
                         for t in texts])
        if self.mode == "rrf":
            score = np.zeros(len(idxs))
            for arr in (vec, bm, ng):
                for r, j in enumerate(np.argsort(-arr)):
                    score[j] += 1.0 / (self.rrf_k + r + 1)
            keep = np.argsort(-score)[:top_k]        # score-range awareness:
            # RRF scores are O(1/k); never threshold them on a cosine scale.
            return [self.store.chunks[idxs[j]] for j in keep]
        bmn = bm / bm.max() if bm.max() > 0 else bm
        score = (self.weights[0] * vec + self.weights[1] * bmn
                 + self.weights[2] * ng)
        keep = [j for j in np.argsort(-score)[:top_k]
                if score[j] >= self.threshold]
        return [self.store.chunks[idxs[j]] for j in keep]


def rag_plugin(req: Request, ctx: Dict[str, Any], cfg: Dict[str, Any]):
    retriever: HybridRetriever = ctx["rag"]
    hits = retriever.retrieve(req.latest_user_text,
                              top_k=cfg.get("top_k", 4),
                              embed_fn=ctx.get("embed"))
    if hits:
        block = "Context documents:\n" + "\n---\n".join(
            f"[{c.doc_id}] {c.text}" for c in hits)
        msgs = list(req.messages)
        idx = next((i for i, m in enumerate(msgs) if m.role != "system"), 0)
        msgs.insert(idx, Message("system", block))
        req.messages = msgs
        req.metadata["rag_chunks"] = len(hits)
    return req, None


register_plugin("rag", rag_plugin)
