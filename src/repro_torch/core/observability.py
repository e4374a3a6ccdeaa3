"""Prometheus-style in-process metrics (copy of the ``Metrics`` part of
``repro.core.observability``).  The port's scheduler reports through
``METRICS``; the span model stays with the router, a later slice."""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = defaultdict(float)
        self.hists: Dict[str, List[float]] = defaultdict(list)
        self.gauges: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0, **labels):
        with self._lock:
            self.counters[self._key(name, labels)] += value

    def observe(self, name: str, value: float, **labels):
        with self._lock:
            self.hists[self._key(name, labels)].append(value)

    def gauge(self, name: str, value: float, **labels):
        """Set-to-latest metric (e.g. overload state, queue depth)."""
        with self._lock:
            self.gauges[self._key(name, labels)] = value

    @staticmethod
    def _key(name, labels):
        if not labels:
            return name
        lab = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return f"{name}{{{lab}}}"

    def percentile(self, name: str, p: float, **labels) -> float:
        vals = sorted(self.hists.get(self._key(name, labels), []))
        if not vals:
            return 0.0
        idx = min(len(vals) - 1, int(p / 100 * len(vals)))
        return vals[idx]

    def scrape(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        for k, v in sorted(self.counters.items()):
            lines.append(f"vsr_{k} {v}")
        for k, v in sorted(self.gauges.items()):
            lines.append(f"vsr_{k} {v}")
        for k, vals in sorted(self.hists.items()):
            base, _, lab = k.partition("{")
            lab = ("{" + lab) if lab else ""
            lines.append(f"vsr_{base}_count{lab} {len(vals)}")
            lines.append(f"vsr_{base}_sum{lab} {sum(vals):.6f}")
        return "\n".join(lines)


METRICS = Metrics()
