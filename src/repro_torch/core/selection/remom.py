"""ReMoM (§10.8): multi-round parallel reasoning with LLM-driven synthesis.
A copy of ``repro.core.selection.remom``.

A breadth schedule b = [b1, ..., bR] (+1 final round auto-appended) fans out
parallel calls per round; each later round synthesizes the previous round's
(optionally compacted) responses via a templated prompt.  Model distribution
per round: equal | weighted | first_only.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

DEFAULT_TEMPLATE = (
    "Original question:\n{query}\n\n"
    "Reference solutions from previous round:\n{references}\n\n"
    "Analyze these references and provide your own comprehensive solution.")


@dataclass
class ReMoMCall:
    model: str
    prompt: str
    seed: int
    round: int


@dataclass
class ReMoM:
    call_fn: Callable[[str, str, int], str]   # (model, prompt, seed) -> text
    breadth: Sequence[int] = (4, 2)
    distribution: str = "equal"               # equal | weighted | first_only
    compaction: str = "full"                  # full | last_n_tokens
    compact_tokens: int = 256
    temperature: float = 1.0
    max_concurrency: int = 8
    template: str = DEFAULT_TEMPLATE
    trace: List[Dict] = field(default_factory=list)

    def _distribute(self, n: int, models: Sequence[str],
                    weights: Optional[Sequence[float]]) -> List[str]:
        if self.distribution == "first_only":
            return [models[0]] * n
        if self.distribution == "weighted" and weights:
            total = sum(weights)
            counts = [int(n * w / total) for w in weights]
            while sum(counts) < n:               # round-robin remainder
                counts[sum(counts) % len(models)] += 1
            out = []
            for m, c in zip(models, counts):
                out += [m] * c
            return out[:n]
        return [models[i % len(models)] for i in range(n)]  # equal

    def _compact(self, text: str) -> str:
        if self.compaction == "last_n_tokens":
            approx_chars = self.compact_tokens * 4   # ~4 chars/token
            return text[-approx_chars:]
        return text

    def run(self, query: str, models: Sequence[str],
            weights: Optional[Sequence[float]] = None) -> str:
        schedule = list(self.breadth) + [1]
        prev: List[str] = []
        pool = ThreadPoolExecutor(max_workers=self.max_concurrency)
        for r, b in enumerate(schedule):
            if r == 0:
                prompt = query
            else:
                refs = "\n".join(
                    f"[{i + 1}] {self._compact(t)}"
                    for i, t in enumerate(prev))
                prompt = self.template.format(query=query, references=refs)
            assigned = self._distribute(b, list(models), weights)
            futs = [pool.submit(self.call_fn, m, prompt, 1000 * r + i)
                    for i, m in enumerate(assigned)]
            prev = [f.result() for f in futs]
            self.trace.append({"round": r, "breadth": b, "models": assigned})
        return prev[0]
