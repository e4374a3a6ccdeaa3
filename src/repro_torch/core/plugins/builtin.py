"""Built-in plugins (§5.3-§5.6): semantic cache, fast response, system
prompt injection, header mutation, modality annotation + response-side
cache write.  HaluGate / memory / RAG register from their own modules.
A copy of ``repro.core.plugins.builtin``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.plugins.base import register_plugin
from repro_torch.core.types import Message, Request, Response


# ---------------------------------------------------------------------------
# semantic cache (§5.3) — exact + cosine match, pluggable backends
# ---------------------------------------------------------------------------

@dataclass
class CacheEntry:
    key_text: str
    embedding: np.ndarray
    response: Optional[Response]
    pending: bool
    created: float = field(default_factory=time.time)
    hits: int = 0


class SemanticCache:
    """In-memory backend (the HNSW/Redis/Milvus tiers of §5.3 share this
    interface; `backend` records the deployment intent)."""

    def __init__(self, embed_fn, backend: str = "memory",
                 max_entries: int = 4096):
        self.embed_fn = embed_fn
        self.backend = backend
        self.max_entries = max_entries
        self.entries: List[CacheEntry] = []
        self.lookups = 0
        self.hits = 0

    def lookup(self, text: str, threshold: float, embed_fn=None):
        self.lookups += 1
        if not self.entries:
            return None, None
        q = (embed_fn or self.embed_fn)([text])[0]
        mats = np.stack([e.embedding for e in self.entries])
        sims = mats @ q
        i = int(np.argmax(sims))
        if sims[i] >= threshold:
            e = self.entries[i]
            if e.pending:
                return None, e       # concurrent identical query in flight
            e.hits += 1
            self.hits += 1
            return e.response, e
        return None, None

    def begin(self, text: str, embed_fn=None) -> CacheEntry:
        """Write-through protocol: register pending before model call."""
        e = CacheEntry(text, (embed_fn or self.embed_fn)([text])[0], None,
                       pending=True)
        self.entries.append(e)
        if len(self.entries) > self.max_entries:
            self.entries.pop(0)
        return e

    def complete(self, entry: CacheEntry, resp: Response):
        entry.response = resp
        entry.pending = False

    def abandon(self, entry: CacheEntry):
        """Drop a pending write-through entry whose model call failed —
        otherwise it forces cache misses for its text forever.  (Identity
        comparison: dataclass == on the ndarray field is ambiguous.)"""
        if entry.pending:
            self.entries = [e for e in self.entries if e is not entry]

    @property
    def hit_rate(self):
        return self.hits / max(1, self.lookups)


def cache_plugin(req: Request, ctx: Dict[str, Any], cfg: Dict[str, Any]
                 ) -> Tuple[Request, Optional[Response]]:
    cache: SemanticCache = ctx["cache"]
    thr = cfg.get("threshold", 0.92)
    embed = ctx.get("embed")      # batch's shared EmbeddingPlan, when routed
    resp, entry = cache.lookup(req.latest_user_text, thr, embed_fn=embed)
    if resp is not None:
        out = Response(resp.content, resp.model, usage=dict(resp.usage),
                       headers={"x-vsr-cache-hit": "true"})
        ctx.setdefault("outcome", {})["cache_hit"] = True
        return req, out
    begun = ctx.get("pending_begun")    # entries begun in THIS batch
    identical_pending = entry is not None and entry.pending and \
        entry.key_text == req.latest_user_text
    if identical_pending and begun is not None and id(entry) in begun:
        # IDENTICAL query in flight in the same batch: join its
        # write-through entry — the pipeline defers this request and
        # back-fills it from the owner's completed entry, exactly one
        # upstream call per text.  Merely similar queries must NOT join.
        ctx["cache_join_entry"] = entry
        return req, None
    if identical_pending:
        # stale pending entry from a dead/failed earlier request: joining
        # would error forever — drop it and write through afresh
        cache.abandon(entry)
    e = cache.begin(req.latest_user_text, embed_fn=embed)
    if begun is not None:
        begun.add(id(e))
    ctx["cache_entry"] = e
    return req, None


def cache_write_plugin(req: Request, ctx, cfg):
    entry = ctx.pop("cache_entry", None)
    resp: Response = cfg["response"]
    if entry is not None and "cache" in ctx:
        ctx["cache"].complete(entry, resp)
    return req, None


# ---------------------------------------------------------------------------
# fast response (§5.6) — safety short-circuit / canned answers
# ---------------------------------------------------------------------------

def sse_chunks(message: str, model: str) -> List[str]:
    """OpenAI-compatible SSE stream for `stream: true` requests."""
    out = ['data: {"choices":[{"delta":{"role":"assistant"}}],'
           f'"model":"{model}","object":"chat.completion.chunk"}}']
    for word in message.split(" "):
        out.append('data: {"choices":[{"delta":{"content":"%s "}}]}' % word)
    out.append('data: {"choices":[{"delta":{},"finish_reason":"stop"}]}')
    out.append("data: [DONE]")
    return out


def fast_response_plugin(req, ctx, cfg):
    msg = cfg.get("message", "This request cannot be processed.")
    resp = Response(msg, model="fast-response",
                    headers={"x-vsr-fast-response": "true"})
    if req.stream:
        resp.annotations["sse"] = sse_chunks(msg, "fast-response")
    return req, resp


# ---------------------------------------------------------------------------
# system prompt injection (§5.4)
# ---------------------------------------------------------------------------

def system_prompt_plugin(req, ctx, cfg):
    mode = cfg.get("mode", "insert")
    prompt = cfg.get("prompt", "")
    msgs = list(req.messages)
    sys_idx = next((i for i, m in enumerate(msgs) if m.role == "system"),
                   None)
    if mode == "replace" or sys_idx is None:
        if sys_idx is not None:
            msgs[sys_idx] = Message("system", prompt)
        else:
            msgs.insert(0, Message("system", prompt))
    else:  # insert: prepend to existing system message
        msgs[sys_idx] = Message("system", prompt + "\n" +
                                msgs[sys_idx].content)
    req.messages = msgs
    return req, None


# ---------------------------------------------------------------------------
# header mutation (§5.5)
# ---------------------------------------------------------------------------

def headers_plugin(req, ctx, cfg):
    for k, v in cfg.get("add", {}).items():
        req.headers.setdefault(k, v)
    for k, v in cfg.get("update", {}).items():
        req.headers[k] = v
    for k in cfg.get("delete", []):
        req.headers.pop(k, None)
    return req, None


# ---------------------------------------------------------------------------
# modality annotation (§12.2 stage 7): route text vs diffusion backends
# ---------------------------------------------------------------------------

def modality_plugin(req, ctx, cfg):
    backend = ctx.get("signals")
    label = "autoregressive"
    if backend is not None:
        m = backend.matches.get("modality:" + cfg.get("rule", "modality"))
        if m is not None:
            label = m.detail.get("label", label)
    req.metadata["modality"] = label
    return req, None


register_plugin("cache", cache_plugin)
register_plugin("cache_write", cache_write_plugin)
register_plugin("fast_response", fast_response_plugin)
register_plugin("system_prompt", system_prompt_plugin)
register_plugin("headers", headers_plugin)
register_plugin("modality", modality_plugin)
