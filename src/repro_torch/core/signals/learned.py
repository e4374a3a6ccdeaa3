"""Learned signals (§3.3): embedding, domain, complexity, jailbreak (BERT +
contrastive max-chain), PII, fact-check, feedback, modality, preference.
A copy of ``repro.core.signals.learned``.
All neural inference goes through the pluggable ClassifierBackend.
Per-call overrides let a batch's shared plans serve the evaluators:
``embed`` (the EmbeddingPlan) replaces per-evaluator re-embedding, and
``classify``/``token_classify`` (the SignalPlan) replace per-evaluator
classifier calls with demuxed rows of one fused per-batch
``classify_all``/``token_classify`` pass.  ``classifier`` may be a
different backend than the embedding one (e.g. hash embeddings + encoder
classifier heads)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.classifiers.backend import ClassifierBackend
from repro_torch.core.types import Request, SignalKey, SignalMatch


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a @ b.T  # embeddings are L2-normalized


class LearnedSignals:
    # insertion-order bound on cached exemplar embeddings: policy
    # hot-reloads with edited exemplar sets add new content-addressed
    # entries, so an unbounded cache would leak across a long-running
    # --watch deployment.  Evicting a live entry only costs a re-embed.
    MAX_REF_CACHE = 512

    def __init__(self, backend: ClassifierBackend,
                 classifier: Optional[ClassifierBackend] = None):
        self.backend = backend
        self.classifier = classifier or backend
        self._ref_cache: Dict[Any, np.ndarray] = {}

    # -- exemplar embeddings precomputed at init (paper: concurrent pool) --
    def preload(self, signals_cfg: Dict[str, Dict[str, Dict[str, Any]]]):
        for name, cfg in signals_cfg.get("embedding", {}).items():
            self._refs(f"emb:{name}", cfg.get("reference_texts", []))
        for name, cfg in signals_cfg.get("complexity", {}).items():
            self._refs(f"cpx_h:{name}", cfg.get("hard_examples", []))
            self._refs(f"cpx_e:{name}", cfg.get("easy_examples", []))
        for name, cfg in signals_cfg.get("jailbreak", {}).items():
            if cfg.get("method") == "contrastive":
                self._refs(f"jb:{name}", cfg.get("jailbreak_examples", []))
                self._refs(f"ben:{name}", cfg.get("benign_examples", []))
        for name, cfg in signals_cfg.get("preference", {}).items():
            for prof, texts in cfg.get("profiles", {}).items():
                self._refs(f"pref:{name}:{prof}", texts)

    def _refs(self, key: str, texts: List[str]) -> np.ndarray:
        # content-addressed: two POLICIES may declare the same signal name
        # with different exemplar sets (multi-tenant registry), so the
        # cache key includes the texts themselves, not just the name
        ck = (key, tuple(texts))
        if ck not in self._ref_cache:
            self._ref_cache[ck] = (self.backend.embed(texts)
                                   if texts else np.zeros((0, 1), np.float32))
            while len(self._ref_cache) > self.MAX_REF_CACHE:
                self._ref_cache.pop(next(iter(self._ref_cache)))
        return self._ref_cache[ck]

    # ------------------------------------------------------------------
    def eval_embedding(self, name, cfg, req: Request, embed=None,
                       classify=None, token_classify=None) -> SignalMatch:
        refs = self._refs(f"emb:{name}", cfg.get("reference_texts", []))
        thr = cfg.get("threshold", 0.75)
        if refs.shape[0] == 0:
            return SignalMatch(SignalKey("embedding", name), False, 0.0)
        q = (embed or self.backend.embed)([req.latest_user_text])[0]
        sim = float(_cos(q[None], refs).max())
        return SignalMatch(SignalKey("embedding", name), sim >= thr,
                           max(0.0, sim), detail={"sim": sim})

    def eval_domain(self, name, cfg, req: Request, embed=None,
                    classify=None, token_classify=None) -> SignalMatch:
        cats = [c.lower() for c in cfg.get("mmlu_categories", [])]
        labels, probs = (classify or self.classifier.classify)(
            "domain", [req.latest_user_text])
        conf = float(probs[0].max())
        matched = labels[0].lower() in cats
        return SignalMatch(SignalKey("domain", name), matched,
                           conf if matched else 0.0,
                           detail={"label": labels[0]})

    def eval_fact_check(self, name, cfg, req: Request, embed=None,
                        classify=None, token_classify=None) -> SignalMatch:
        labels, probs = (classify or self.classifier.classify)(
            "fact_check", [req.latest_user_text])
        thr = cfg.get("threshold", 0.5)
        conf = float(probs[0][1])
        return SignalMatch(SignalKey("fact_check", name),
                           conf >= thr, conf, detail={"label": labels[0]})

    def eval_user_feedback(self, name, cfg, req: Request, embed=None,
                           classify=None, token_classify=None
                           ) -> SignalMatch:
        want = cfg.get("categories", ["dissatisfied"])
        labels, probs = (classify or self.classifier.classify)(
            "user_feedback", [req.latest_user_text])
        conf = float(probs[0].max())
        matched = labels[0] in want
        return SignalMatch(SignalKey("user_feedback", name), matched,
                           conf if matched else 0.0,
                           detail={"label": labels[0]})

    def eval_modality(self, name, cfg, req: Request, embed=None,
                      classify=None, token_classify=None) -> SignalMatch:
        want = cfg.get("modalities", ["diffusion"])
        labels, probs = (classify or self.classifier.classify)(
            "modality", [req.latest_user_text])
        conf = float(probs[0].max())
        matched = labels[0] in want
        return SignalMatch(SignalKey("modality", name), matched,
                           conf if matched else 0.0,
                           detail={"label": labels[0]})

    def eval_complexity(self, name, cfg, req: Request, embed=None,
                        classify=None, token_classify=None) -> SignalMatch:
        """Contrastive difficulty (Equation 4)."""
        hard = self._refs(f"cpx_h:{name}", cfg.get("hard_examples", []))
        easy = self._refs(f"cpx_e:{name}", cfg.get("easy_examples", []))
        thr = cfg.get("threshold", 0.08)
        want = cfg.get("level", "hard")
        q = (embed or self.backend.embed)([req.latest_user_text])[0]
        sh = float(_cos(q[None], hard).max()) if hard.shape[0] else 0.0
        se = float(_cos(q[None], easy).max()) if easy.shape[0] else 0.0
        delta = sh - se
        level = "hard" if delta > thr else ("easy" if delta < -thr
                                            else "medium")
        matched = level == want
        conf = min(1.0, abs(delta) / max(thr, 1e-6) * 0.5) if matched else 0.0
        if matched and level == "medium":
            conf = max(conf, 0.5)
        return SignalMatch(SignalKey("complexity", name), matched, conf,
                           detail={"delta": delta, "level": level})

    def eval_jailbreak(self, name, cfg, req: Request, embed=None,
                       classify=None, token_classify=None) -> SignalMatch:
        method = cfg.get("method", "classifier")
        thr = cfg.get("threshold", 0.65 if method == "classifier" else 0.10)
        include_history = cfg.get("include_history", False)
        texts = req.user_texts if include_history else [req.latest_user_text]
        if method == "classifier":
            labels, probs = (classify or self.classifier.classify)(
                "jailbreak", texts)
            best = 0.0
            lab = "BENIGN"
            for l, p in zip(labels, probs):
                c = float(p[1] + p[2])
                if l != "BENIGN" and c > best:
                    best, lab = c, l
            return SignalMatch(SignalKey("jailbreak", name),
                               lab != "BENIGN" and best >= thr, best,
                               detail={"label": lab, "method": method})
        # contrastive max-chain (Equations 5/22)
        jb = self._refs(f"jb:{name}", cfg.get("jailbreak_examples", []))
        ben = self._refs(f"ben:{name}", cfg.get("benign_examples", []))
        embs = (embed or self.backend.embed)(texts)
        deltas = []
        for e in embs:
            sj = float(_cos(e[None], jb).max()) if jb.shape[0] else 0.0
            sb = float(_cos(e[None], ben).max()) if ben.shape[0] else 0.0
            deltas.append(sj - sb)
        delta = max(deltas) if deltas else 0.0
        return SignalMatch(SignalKey("jailbreak", name), delta >= thr,
                           max(0.0, min(1.0, 0.5 + delta)),
                           detail={"delta": delta, "method": method,
                                   "turns_scored": len(deltas)})

    def eval_pii(self, name, cfg, req: Request, embed=None,
                 classify=None, token_classify=None) -> SignalMatch:
        thr = cfg.get("threshold", 0.5)
        allow = set(cfg.get("pii_types_allowed", []))
        spans = (token_classify or
                 self.classifier.token_classify)([req.full_text])[0]
        viol = [(s, e, l, c) for (s, e, l, c) in spans
                if c >= thr and l not in allow]
        conf = max((c for *_, c in viol), default=0.0)
        return SignalMatch(SignalKey("pii", name), bool(viol), conf,
                           detail={"entities": [l for *_, l, _ in
                                   [(s, e, l, c) for s, e, l, c in viol]]})

    def eval_preference(self, name, cfg, req: Request, embed=None,
                        classify=None, token_classify=None) -> SignalMatch:
        """Personalized routing: query vs per-profile exemplar sets."""
        profiles = cfg.get("profiles", {})
        want = cfg.get("profile", None)
        thr = cfg.get("threshold", 0.3)
        q = (embed or self.backend.embed)([req.latest_user_text])[0]
        best, best_p = 0.0, None
        for prof in profiles:
            refs = self._refs(f"pref:{name}:{prof}", profiles[prof])
            if refs.shape[0] == 0:
                continue
            s = float(_cos(q[None], refs).max())
            if s > best:
                best, best_p = s, prof
        matched = best >= thr and (want is None or best_p == want)
        return SignalMatch(SignalKey("preference", name), matched,
                           best if matched else 0.0,
                           detail={"profile": best_p})

    def evaluator(self, type_: str):
        return {
            "embedding": self.eval_embedding,
            "domain": self.eval_domain,
            "fact_check": self.eval_fact_check,
            "user_feedback": self.eval_user_feedback,
            "modality": self.eval_modality,
            "complexity": self.eval_complexity,
            "jailbreak": self.eval_jailbreak,
            "pii": self.eval_pii,
            "preference": self.eval_preference,
        }[type_]
