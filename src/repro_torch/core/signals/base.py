"""Signal extraction orchestrator (§3.4): demand-driven, parallel, fused.
A copy of ``repro.core.signals.base``.

Only signal types referenced by at least one active decision are computed
(T_used); heuristic evaluators run inline (sub-ms), learned evaluators run
on a thread pool mirroring the paper's goroutine fan-out, with wall-clock =
max(evaluators) rather than the sum.  Per-signal latency is recorded into
the SignalMatch for the observability layer.

``extract_many`` is the batch-first entry: learned-signal jobs for N
requests are submitted as one thread-pool wave, and two per-batch plans
replace per-evaluator backend calls:

* ``embed_fn`` (the batch's shared EmbeddingPlan) serves query-text
  embeddings embedded once per batch to every embedding-based evaluator;
* ``plan`` (a :class:`SignalPlan` over the classifier backend) collects
  every (task, text) classification job up front and serves all of them
  from ONE fused ``classify_all`` call (and PII from one batched
  ``token_classify`` call), demuxed back per evaluator.

The classifier backend may differ from the embedding backend
(``SignalEngine(cfg, backend, classifier=encoder)``): hash embeddings
with encoder classifier heads is the production split.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

from repro_torch.classifiers.backend import ClassifierBackend, get_backend
from repro_torch.core.signals.heuristic import HEURISTIC_EVALUATORS
from repro_torch.core.signals.learned import LearnedSignals
from repro_torch.core.signals.plan import SignalPlan
from repro_torch.core.types import (HEURISTIC_TYPES, Request, SignalMatch,
                              SignalResult)

# Extensibility (§3.5): operators register domain-specific signal types here;
# the decision engine references them by (type, name) with no engine changes.
EXTRA_EVALUATORS: Dict[str, Any] = {}

# learned signal types whose evaluator consumes backend.classify, and the
# classifier task each maps to — the plan pre-registers these so the whole
# batch is served by one fused classify_all
_CLASSIFY_TASK = {"domain": "domain", "fact_check": "fact_check",
                  "user_feedback": "user_feedback", "modality": "modality"}


def register_signal_type(type_: str, evaluator):
    """evaluator: (name, cfg, request) -> SignalMatch"""
    EXTRA_EVALUATORS[type_] = evaluator


class SignalEngine:
    def __init__(self, signals_cfg: Dict[str, Dict[str, Dict[str, Any]]],
                 backend: Optional[ClassifierBackend] = None,
                 classifier: Optional[ClassifierBackend] = None,
                 max_workers: int = 8):
        self.cfg = signals_cfg
        self.backend = backend or get_backend("hash")
        self.classifier = classifier or self.backend
        self.learned = LearnedSignals(self.backend, self.classifier)
        self.learned.preload(signals_cfg)
        self.pool = ThreadPoolExecutor(max_workers=max_workers)
        self._closed = False

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        """Shut down the evaluator thread pool (idempotent)."""
        if not self._closed:
            self._closed = True
            self.pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    def _eval_one(self, type_: str, name: str, cfg: Dict[str, Any],
                  req: Request, embed_fn: Optional[Callable] = None,
                  plan: Optional[SignalPlan] = None) -> SignalMatch:
        t0 = time.perf_counter()
        if type_ in HEURISTIC_EVALUATORS:
            m = HEURISTIC_EVALUATORS[type_](name, cfg, req)
        elif type_ in EXTRA_EVALUATORS:
            m = EXTRA_EVALUATORS[type_](name, cfg, req)
        else:
            m = self.learned.evaluator(type_)(
                name, cfg, req, embed=embed_fn,
                classify=plan.classify if plan is not None else None,
                token_classify=(plan.token_classify
                                if plan is not None else None))
        m.latency_ms = (time.perf_counter() - t0) * 1e3
        return m

    @staticmethod
    def _register_job(plan: SignalPlan, type_: str, cfg: Dict[str, Any],
                      req: Request):
        """Record the classifier work evaluator (type_, cfg) will ask for,
        so the plan's one fused call covers it."""
        if type_ in _CLASSIFY_TASK:
            plan.register(_CLASSIFY_TASK[type_], [req.latest_user_text])
        elif type_ == "jailbreak" and \
                cfg.get("method", "classifier") == "classifier":
            texts = (req.user_texts if cfg.get("include_history", False)
                     else [req.latest_user_text])
            plan.register("jailbreak", texts)
        elif type_ == "pii":
            plan.register_token([req.full_text])

    def extract(self, req: Request,
                used_types: Optional[Set[str]] = None,
                embed_fn: Optional[Callable] = None) -> SignalResult:
        """Demand-driven parallel extraction for one request.  ``used_types``
        is T_used = union of signal types referenced by active decisions;
        None means evaluate everything configured."""
        return self.extract_many([req], used_types, embed_fn=embed_fn)[0]

    def extract_many(self, reqs: Sequence[Request],
                     used_types: Optional[Set[str]] = None,
                     embed_fn: Optional[Callable] = None,
                     plan: Optional[SignalPlan] = None,
                     signals_cfg: Optional[Dict[str, Dict[str, Dict[str,
                                                 Any]]]] = None
                     ) -> List[SignalResult]:
        """Batched extraction: one thread-pool wave covers the learned
        signals of every request; heuristics stay inline (sub-ms).  All
        classifier jobs are pre-registered on the batch's SignalPlan
        before any evaluator runs, so the first classifying evaluator
        triggers exactly ONE fused ``classify_all`` (and PII one batched
        ``token_classify``) for the entire batch.  ``signals_cfg``
        overrides the engine's construction-time config — this is how a
        multi-tenant deployment runs every policy's signal set through
        ONE engine (one thread pool, one classifier substrate)."""
        if plan is None:
            plan = SignalPlan(self.classifier)
        cfg_map = signals_cfg if signals_cfg is not None else self.cfg
        results = [SignalResult() for _ in reqs]
        jobs = []
        for i, req in enumerate(reqs):
            for type_, rules in cfg_map.items():
                if used_types is not None and type_ not in used_types:
                    continue
                for name, cfg in rules.items():
                    if type_ in HEURISTIC_TYPES:
                        results[i].add(self._eval_one(type_, name, cfg, req))
                    else:
                        if type_ not in EXTRA_EVALUATORS:
                            self._register_job(plan, type_, cfg, req)
                        jobs.append((i, type_, name, cfg, req))
        futures = [(i, self.pool.submit(self._eval_one, t, n, c, r,
                                        embed_fn, plan))
                   for i, t, n, c, r in jobs]
        for i, f in futures:
            results[i].add(f.result())
        return results
