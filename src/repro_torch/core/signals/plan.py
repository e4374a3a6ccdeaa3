"""SignalPlan: per-batch fused classification plan (the classifier-side
twin of the pipeline's EmbeddingPlan).
A copy of ``repro.core.signals.plan``.

``LearnedSignals`` used to issue one ``backend.classify(task, texts)``
call per evaluator per request — N requests with k learned evaluators
cost N*k encoder forwards.  The plan collects every (task, text)
classification job for a whole batch, dedupes texts, and serves them all
from ONE ``backend.classify_all(tasks, texts)`` call (the EncoderBackend
folds tasks into the batch dimension over the ``kernels/multi_lora``
BGMV path, ``csrc/multi_lora.cu`` on the card; HashBackend's
loop-fallback keeps reference semantics unchanged).  PII token tagging
batches the same way through one ``backend.token_classify`` call.

Demand-driven like the EmbeddingPlan: ``register``/``register_token``
only record jobs; no backend call happens until some evaluator actually
asks, and the first miss then issues the one fused call covering
everything pending.  Results demux back per (task, text), so request
boundaries never mix.  Thread-safe: evaluators call ``classify`` from
the signal engine's thread pool.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.classifiers.backend import ClassifierBackend


class SignalPlan:
    def __init__(self, backend: ClassifierBackend):
        self.backend = backend
        self.memo: Dict[Tuple[str, str], Tuple[str, np.ndarray]] = {}
        self.token_memo: Dict[str, list] = {}
        self.classify_calls = 0            # fused classify_all base calls
        self.token_calls = 0               # batched token_classify calls
        self._pending: Dict[str, List[str]] = {}
        self._token_pending: List[str] = []
        self._lock = threading.Lock()

    # -- job collection ------------------------------------------------------
    def _queue(self, task: str, texts: Sequence[str]):
        jobs = self._pending.setdefault(task, [])
        seen = set(jobs)
        for t in texts:
            if (task, t) not in self.memo and t not in seen:
                jobs.append(t)
                seen.add(t)

    def register(self, task: str, texts: Sequence[str]):
        """Record (task, text) jobs to ride the first miss-triggered fused
        call.  Deduplicated against the memo and already-pending jobs."""
        with self._lock:
            self._queue(task, texts)

    def register_token(self, texts: Sequence[str]):
        with self._lock:
            seen = set(self._token_pending)
            self._token_pending.extend(
                t for t in dict.fromkeys(texts)
                if t not in self.token_memo and t not in seen)

    # -- fused execution -----------------------------------------------------
    def _fill(self):
        """ONE ``classify_all`` call covering every pending (task, text)
        job: tasks = union of pending tasks, texts = dedup union of their
        texts.  The cross-product rows a task didn't ask for are memoized
        too — the fused forward already computed them.  (Deliberate
        tradeoff: a task registering extra texts — e.g. jailbreak with
        ``include_history`` — widens the text union for every task, but
        the batch stays ONE call; splitting by text-set would multiply
        dispatches, which dominates at the adapter ranks in play.)"""
        tasks = [t for t, txts in self._pending.items() if txts]
        if not tasks:
            return
        texts = list(dict.fromkeys(
            txt for t in tasks for txt in self._pending[t]))
        self._pending = {}
        out = self.backend.classify_all(tasks, texts)
        self.classify_calls += 1
        for task in tasks:
            labels, probs = out[task]
            for i, txt in enumerate(texts):
                self.memo[(task, txt)] = (labels[i], probs[i])

    # -- consumer protocol (drop-in for backend.classify/token_classify) -----
    def classify(self, task: str, texts: Sequence[str]
                 ) -> Tuple[List[str], np.ndarray]:
        with self._lock:
            missing = [t for t in texts if (task, t) not in self.memo]
            if missing:
                self._queue(task, missing)
                self._fill()
            rows = [self.memo[(task, t)] for t in texts]
        labels = [l for l, _ in rows]
        probs = (np.stack([p for _, p in rows])
                 if rows else np.zeros((0, 1), np.float32))
        return labels, probs

    def token_classify(self, texts: Sequence[str]) -> List[list]:
        with self._lock:
            missing = [t for t in dict.fromkeys(texts)
                       if t not in self.token_memo
                       and t not in self._token_pending]
            self._token_pending.extend(missing)
            if any(t not in self.token_memo for t in texts):
                batch = self._token_pending
                self._token_pending = []
                spans = self.backend.token_classify(batch)
                self.token_calls += 1
                for t, s in zip(batch, spans):
                    self.token_memo[t] = s
            return [self.token_memo[t] for t in texts]
