"""HaluGate (§8): gated three-stage hallucination detection.
A copy of ``repro.core.halugate``.

Stage 1 Sentinel: binary fact-check gate on the request path (doubles as the
  fact_check signal).
Stage 2 Detector: token/sentence-level identification of response spans
  unsupported by the grounding context.
Stage 3 Explainer: NLI classification (ENTAILMENT / CONTRADICTION / NEUTRAL)
  per flagged span.

Action policies (Table 1): block | header | body | none.
Cost model (Equation 27): E[cost] = C_sent + p_factual*(C_det + k*C_nli).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


from repro_torch.classifiers.backend import ClassifierBackend
from repro_torch.core import textstats as TS
from repro_torch.core.plugins.base import register_plugin
from repro_torch.core.types import Request, Response

_SENT_SPLIT = re.compile(r"(?<=[.!?])\s+")
_HEDGE = ("probably", "i think", "might", "may have", "reportedly",
          "some say", "allegedly", "it is believed")


@dataclass
class SpanResult:
    start: int
    end: int
    text: str
    confidence: float
    nli: Optional[str] = None


@dataclass
class HaluGateResult:
    gated: bool                      # False => stages 2-3 skipped
    hallucinated: bool = False
    spans: List[SpanResult] = field(default_factory=list)
    cost: Dict[str, float] = field(default_factory=dict)


class HaluGate:
    # per-stage unit costs used by the cost model / Table reproduction
    C_SENT, C_DET, C_NLI = 1.0, 4.0, 2.5

    def __init__(self, backend: ClassifierBackend,
                 detector_threshold: float = 0.5,
                 embed_backend: Optional[ClassifierBackend] = None):
        """``backend`` powers the classifier stages (sentinel / detector /
        NLI); ``embed_backend`` the heuristic detector's semantic-support
        embeddings (defaults to ``backend``).  When ``backend`` carries
        trained ``detector``/``nli`` encoder heads, stages 2-3 upgrade to
        them automatically."""
        self.backend = backend
        self.embed_backend = embed_backend or backend
        self.detector_threshold = detector_threshold
        self.stats = {"queries": 0, "gated_in": 0, "spans": 0,
                      "cost_units": 0.0}

    def _head(self, task: str) -> bool:
        """True when the backend serves ``task`` from a trained encoder
        head (rather than the lexical fallback)."""
        return task in (getattr(self.backend, "trained", None) or set())

    # -- Stage 1 ------------------------------------------------------------
    def sentinel(self, query: str) -> Tuple[bool, float]:
        labels, probs = self.backend.classify("fact_check", [query])
        return labels[0] == "NEEDS_FACT_CHECK", float(probs[0][1])

    # -- Stage 2: span support vs grounding context ---------------------------
    def _sentences(self, answer: str) -> List[Tuple[int, int, str]]:
        out, pos = [], 0
        for sent in _SENT_SPLIT.split(answer):
            if not sent.strip():
                continue
            start = answer.find(sent, pos)
            end = start + len(sent)
            pos = end
            out.append((start, end, sent))
        return out

    def detect(self, query: str, context: str, answer: str
               ) -> List[SpanResult]:
        """Sentence-level grounding check: a sentence is flagged when its
        lexical+semantic support in the context falls below threshold.
        A trained encoder ``detector`` head upgrades this to one batched
        classification over all answer sentences."""
        sents = self._sentences(answer)
        if not sents:
            return []
        if self._head("detector") and hasattr(self.backend, "detector"):
            # one batched (sentence, context) cross-encoder pass — the
            # verdict must depend on the grounding context, not the
            # sentence alone
            _labels, probs = self.backend.detector(
                [s for _, _, s in sents], [context] * len(sents))
            return [SpanResult(start, end, s, float(p[1]))
                    for (start, end, s), p in zip(sents, probs)
                    if float(p[1]) >= self.detector_threshold]
        spans: List[SpanResult] = []
        ctx_grams = TS.char_ngrams(context, 3)
        ctx_emb = self.embed_backend.embed([context])[0] if context else None
        for start, end, sent in sents:
            lex = TS.jaccard(TS.char_ngrams(sent, 3), ctx_grams)
            sem = 0.0
            if ctx_emb is not None:
                sem = float(self.embed_backend.embed([sent])[0] @ ctx_emb)
            support = 0.5 * lex + 0.5 * max(0.0, sem)
            hedged = any(h in sent.lower() for h in _HEDGE)
            conf = 1.0 - support + (0.1 if hedged else 0.0)
            if conf >= self.detector_threshold:
                spans.append(SpanResult(start, end, sent, min(1.0, conf)))
        return spans

    # -- Stage 3: NLI explanation ----------------------------------------------
    def explain(self, span: str, context: str) -> str:
        """ENTAILMENT / CONTRADICTION / NEUTRAL via cross-similarity +
        negation cues; a trained encoder ``nli`` head upgrades this to
        the cross-encoder pair classifier."""
        if self._head("nli") and hasattr(self.backend, "nli"):
            labels, _probs = self.backend.nli([span], [context])
            return labels[0]
        sim = TS.jaccard(TS.char_ngrams(span, 3), TS.char_ngrams(context, 3))
        negs = ("not", "never", "no ", "none", "isn't", "wasn't")
        sn = sum(1 for n in negs if n in span.lower())
        cn = sum(1 for n in negs if n in context.lower())
        if sim > 0.55:
            return "ENTAILMENT" if (sn % 2) == (cn % 2) else "CONTRADICTION"
        if sim > 0.3 and (sn % 2) != (cn % 2):
            return "CONTRADICTION"
        return "NEUTRAL"

    # -- full pipeline ------------------------------------------------------------
    def run(self, query: str, context: str, answer: str) -> HaluGateResult:
        self.stats["queries"] += 1
        cost = self.C_SENT
        gated, p = self.sentinel(query)
        if not gated:
            self.stats["cost_units"] += cost
            return HaluGateResult(False, cost={"units": cost})
        self.stats["gated_in"] += 1
        cost += self.C_DET
        spans = self.detect(query, context, answer)
        if spans and self._head("nli") and hasattr(self.backend, "nli"):
            # one batched cross-encoder pass explains every flagged span
            labels, _probs = self.backend.nli(
                [s.text for s in spans], [context] * len(spans))
            for s, lab in zip(spans, labels):
                s.nli = lab
                cost += self.C_NLI
        else:
            for s in spans:
                s.nli = self.explain(s.text, context)
                cost += self.C_NLI
        self.stats["spans"] += len(spans)
        self.stats["cost_units"] += cost
        return HaluGateResult(True, bool(spans), spans, {"units": cost})

    @staticmethod
    def expected_cost(p_factual: float, k_spans: float) -> float:
        """Equation 27."""
        return HaluGate.C_SENT + p_factual * (
            HaluGate.C_DET + k_spans * HaluGate.C_NLI)


def halugate_plugin(req: Request, ctx: Dict[str, Any], cfg: Dict[str, Any]):
    gate: HaluGate = ctx["halugate"]
    resp: Response = cfg["response"]
    action = cfg.get("action", "header")
    context = "\n".join(m.content for m in req.messages
                        if m.role in ("system", "tool"))
    res = gate.run(req.latest_user_text, context, resp.content)
    if not res.gated or not res.hallucinated:
        if res.gated:
            resp.headers["x-vsr-halugate"] = "clean"
        return req, resp
    resp.headers["x-vsr-halugate"] = "flagged"
    resp.headers["x-vsr-halugate-spans"] = str(len(res.spans))
    resp.annotations["halugate"] = [
        {"text": s.text, "confidence": round(s.confidence, 3), "nli": s.nli}
        for s in res.spans]
    if action == "block":
        return req, Response(
            "Response blocked: potential hallucination detected.",
            model=resp.model, finish_reason="content_filter",
            headers=resp.headers, annotations=resp.annotations)
    if action == "body":
        resp.content = ("[warning: the following response contains "
                        "potentially unsupported claims]\n" + resp.content)
    return req, resp


register_plugin("halugate", halugate_plugin)
