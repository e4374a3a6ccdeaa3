"""Heuristic signals (§3.2): keyword / context-length / language / authz.
Deterministic, sub-millisecond, no neural inference.
A copy of ``repro.core.signals.heuristic``."""

from __future__ import annotations

import re
from typing import Any, Dict

from repro_torch.core import textstats as TS
from repro_torch.core.types import Request, SignalKey, SignalMatch


def eval_keyword(name: str, cfg: Dict[str, Any], req: Request) -> SignalMatch:
    """cfg: {keywords: [...], operator: any|all|none (AND/OR/NOR),
    method: regex|bm25|ngram, threshold, case_sensitive}."""
    patterns = cfg.get("keywords", [])
    op = cfg.get("operator", "any").lower()
    method = cfg.get("method", "regex")
    text = req.full_text
    if not cfg.get("case_sensitive", False):
        text_m = text.lower()
    else:
        text_m = text

    scores = []
    hits = []
    for p in patterns:
        pm = p if cfg.get("case_sensitive", False) else p.lower()
        if method == "regex":
            hit = re.search(rf"\b{re.escape(pm)}\b", text_m) is not None
            scores.append(1.0 if hit else 0.0)
        elif method == "bm25":
            thr = cfg.get("threshold", 0.1)
            s = TS.bm25_keyword_score(pm, text_m)
            hit = s > thr
            scores.append(min(1.0, s))
        elif method == "ngram":
            thr = cfg.get("threshold", 0.4)
            n = cfg.get("ngram_size", 3)
            warp = cfg.get("warp", 3.0)   # ngrammatic-style warp exponent
            raw = max((TS.ngram_similarity(pm, w, n)
                       for w in TS.tokenize_words(text_m)), default=0.0)
            s = raw ** (1.0 / warp)
            hit = s > thr
            scores.append(s)
        else:
            raise ValueError(f"keyword method {method!r}")
        hits.append(hit)

    if op in ("any", "or"):
        matched = any(hits)
    elif op in ("all", "and"):
        matched = all(hits) and bool(hits)
    elif op in ("none", "nor"):
        matched = not any(hits)
    else:
        raise ValueError(f"keyword operator {op!r}")
    conf = max(scores) if (matched and scores and method != "regex") else \
        (1.0 if matched else 0.0)
    return SignalMatch(SignalKey("keyword", name), matched, conf,
                       detail={"hits": sum(map(bool, hits))})


def eval_context(name: str, cfg: Dict[str, Any], req: Request) -> SignalMatch:
    """cfg: {min_tokens, max_tokens} token-count interval [l, u]."""
    t = TS.estimate_tokens(req.full_text)
    lo = cfg.get("min_tokens", 0)
    hi = cfg.get("max_tokens", 1 << 60)
    matched = lo <= t <= hi
    return SignalMatch(SignalKey("context", name), matched,
                       1.0 if matched else 0.0, detail={"tokens": t})


def eval_language(name: str, cfg: Dict[str, Any], req: Request) -> SignalMatch:
    """cfg: {languages: ["zh", ...]} - matches when detected code is bound."""
    lang, conf = TS.detect_language(req.latest_user_text or req.full_text)
    want = cfg.get("languages", [])
    matched = lang in want
    return SignalMatch(SignalKey("language", name), matched,
                       conf if matched else 0.0, detail={"lang": lang})


def eval_authz(name: str, cfg: Dict[str, Any], req: Request) -> SignalMatch:
    """Inbound RBAC (§3.2): resolve identity from headers via a pluggable
    extractor chain, then match role bindings.
    cfg: {roles: [...], header: "x-user-role", api_keys: {key: role}}."""
    want = set(cfg.get("roles", []))
    role = None
    hdr = cfg.get("header", "x-user-role")
    if hdr in req.headers:
        role = req.headers[hdr]
    if role is None and "authorization" in req.headers:
        token = req.headers["authorization"].removeprefix("Bearer ").strip()
        role = cfg.get("api_keys", {}).get(token)
    if role is None and req.user:
        role = cfg.get("users", {}).get(req.user)
    matched = role in want
    return SignalMatch(SignalKey("authz", name), matched,
                       1.0 if matched else 0.0, detail={"role": role})


HEURISTIC_EVALUATORS = {
    "keyword": eval_keyword,
    "context": eval_context,
    "language": eval_language,
    "authz": eval_authz,
}
