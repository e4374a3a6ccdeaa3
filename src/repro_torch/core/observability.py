"""Observability (§14): metrics taxonomy + hierarchical span tracing.
A copy of ``repro.core.observability``.

Prometheus-style counters/histograms (in-process; the export surface is a
text scrape endpoint format) and an OpenTelemetry-like span model with the
paper's hierarchy: root -> signal spans -> decision span -> plugin spans ->
upstream span.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


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


@dataclass
class Span:
    name: str
    start: float = field(default_factory=time.perf_counter)
    end: Optional[float] = None
    attributes: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    def child(self, name: str, **attrs) -> "Span":
        s = Span(name, attributes=attrs)
        self.children.append(s)
        return s

    def finish(self, **attrs):
        self.end = time.perf_counter()
        self.attributes.update(attrs)
        return self

    @property
    def duration_ms(self) -> float:
        return ((self.end or time.perf_counter()) - self.start) * 1e3

    def flatten(self, depth=0):
        yield depth, self
        for c in self.children:
            yield from c.flatten(depth + 1)

    def render(self) -> str:
        return "\n".join(f"{'  ' * d}{s.name} {s.duration_ms:.2f}ms "
                         f"{s.attributes}" for d, s in self.flatten())


METRICS = Metrics()


@contextmanager
def stage_scope(parent: Optional[Span], name: str, *,
                metric: str = "stage_latency_ms", **attrs):
    """Span + latency-histogram scope for one pipeline stage.

    Creates ``name`` as a child of ``parent`` (or a standalone root span
    when ``parent`` is None), finishes it on exit, and records the stage
    duration into ``metric`` labelled by the stage name."""
    span = parent.child(name, **attrs) if parent is not None \
        else Span(name, attributes=dict(attrs))
    try:
        yield span
    finally:
        span.finish()
        METRICS.observe(metric, span.duration_ms,
                        stage=name.removeprefix("stage:"))
