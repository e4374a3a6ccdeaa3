"""RouterProgram: the compiled, immutable control-plane artifact (§6).
The port of ``repro.core.program``: a copy, except that a program owns a
``device`` on which its decision gate runs (the card by default), and
``decide_batch`` brings the gate's outputs to the host in one transfer.

The paper's central configuration-first claim is that "fundamentally
different scenarios are expressed as different configurations over the
same architecture".  A :class:`RouterProgram` is what one such
configuration compiles TO: everything the hot path needs, precomputed
once so per-request work is table lookups and one jitted gate call.

    DSL / RouterConfig  --compile-->  RouterProgram
        * frozen signal-key vocabulary (the gate's column order)
        * ONE jitted batch decision gate (build_decision_gate: crisp +
          fuzzy, priority + confidence, exact tie-breaking)
        * per-decision plugin-chain templates with the implied
          cache_write/memory_write halves already resolved
        * pre-bound selection bindings (candidates, algorithm, config)
        * the sequential DecisionEngine as oracle/fallback

Programs are immutable after construction: the PolicyRegistry hot-reload
swaps the program POINTER, never mutates a live one, so in-flight
batches finish on the program they started with.

:class:`DecisionPlan` is the per-batch companion (the third plan in the
EmbeddingPlan -> SignalPlan -> DecisionPlan series): ``stage_signals``
fills its (B, N) match/conf tensors against the program vocabulary and
``stage_decide`` consumes them with exactly one gate call per batch.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.decision import (DecisionEngine, EngineResult,
                                       build_decision_gate)
from repro_torch.core.types import (Decision, Request, RouterConfig, SignalKey,
                                    SignalResult, SLOSpec)
from repro_torch.device import DeviceLike, resolve_device


def _implied_halves(plugins: Dict[str, Dict[str, Any]]
                    ) -> Dict[str, Dict[str, Any]]:
    """Request-side plugins imply their response-side halves."""
    out = dict(plugins)
    if "cache" in out:
        out.setdefault("cache_write", {"enabled": True})
    if "memory" in out:
        out.setdefault("memory_write", {"enabled": True})
    return out


class SelectionBinding:
    """Pre-bound selection for one decision: candidate pool, weights and
    the algorithm name/config resolved at compile time instead of per
    request."""

    __slots__ = ("cands", "weights", "algorithm", "config")

    def __init__(self, decision: Decision):
        self.cands: Tuple[str, ...] = tuple(m.name
                                            for m in decision.model_refs)
        self.weights: Tuple[float, ...] = tuple(m.weight
                                                for m in decision.model_refs)
        self.algorithm: str = decision.algorithm or "static"
        self.config: Dict[str, Any] = dict(decision.algorithm_config)


class RouterProgram:
    """Immutable compiled router policy.  ``name``/``version`` identify it
    in the PolicyRegistry; everything else is derived from ``config``.
    ``device`` holds the decision gate ("cuda" by default; raises without
    a GPU unless ``device="cpu"``)."""

    def __init__(self, config: RouterConfig, name: str = "default",
                 version: int = 1, device: DeviceLike = "cuda"):
        self.config = config
        self.name = name
        self.version = version
        self.device = resolve_device(device)
        self.engine = DecisionEngine(
            config.decisions, strategy=config.strategy, fuzzy=config.fuzzy,
            fuzzy_threshold=config.fuzzy_threshold)
        self.used_types = config.used_signal_types()
        self.decisions: Tuple[Decision, ...] = tuple(config.decisions)
        self._dec_index = {id(d): i for i, d in enumerate(self.decisions)}
        # frozen signal-key vocabulary + the jitted gate over it
        if self.decisions:
            self._gate, keys = build_decision_gate(
                self.decisions, strategy=config.strategy, fuzzy=config.fuzzy,
                fuzzy_threshold=config.fuzzy_threshold, device=self.device)
        else:
            self._gate, keys = None, []
        self.keys: Tuple[str, ...] = tuple(keys)
        self.key_objs: Tuple[SignalKey, ...] = tuple(
            SignalKey(*k.split(":", 1)) for k in self.keys)
        # per-decision plugin templates with implied halves pre-resolved
        self.plugin_templates: Tuple[Dict[str, Dict[str, Any]], ...] = tuple(
            _implied_halves(dict(d.plugins)) for d in self.decisions)
        self.default_plugins: Dict[str, Dict[str, Any]] = _implied_halves(
            dict(config.plugin_templates))
        self.selection: Tuple[SelectionBinding, ...] = tuple(
            SelectionBinding(d) for d in self.decisions)
        self.gate_calls = 0            # observability: jitted calls issued

        # QoS: SLO classes declared across decisions (first declaration of a
        # class name wins) + the GLOBAL overload policy.  has_slo == False
        # means the program predates SLO config and every consumer must keep
        # byte-identical FIFO behaviour.
        self.slo_classes: Dict[str, SLOSpec] = {}
        for d in self.decisions:
            if d.slo is not None:
                self.slo_classes.setdefault(d.slo.cls, d.slo)
        self.overload = config.overload
        self.has_slo = bool(self.slo_classes) or self.overload is not None
        # Level-4 verifier findings (filled by compile_router_program when
        # lint != "off"); informational on the program object — rejection
        # happens at compile time, never on a live program
        self.lint_findings: List[Any] = []

    # ------------------------------------------------------------------
    def request_slo(self, req: Request) -> SLOSpec:
        """Resolve the SLO class a request belongs to, before signal
        extraction (mirrors ``request_policy_name``): explicit
        ``metadata["slo"]``, then the ``X-VSR-SLO`` header, then the
        overload policy's ``default_class``, else an anonymous
        best-effort class at priority 0."""
        name = req.metadata.get("slo")
        if not name:
            for k, v in req.headers.items():
                if k.lower() == "x-vsr-slo":
                    name = v
                    break
        if not name and self.overload is not None:
            name = self.overload.default_class
        if name and name in self.slo_classes:
            return self.slo_classes[name]
        return SLOSpec(cls=str(name) if name else "best_effort")

    # ------------------------------------------------------------------
    def index_of(self, decision: Decision) -> int:
        return self._dec_index[id(decision)]

    def plugins_for(self, decision: Optional[Decision]
                    ) -> Dict[str, Dict[str, Any]]:
        if decision is None:
            return dict(self.default_plugins)
        return dict(self.plugin_templates[self.index_of(decision)])

    # ------------------------------------------------------------------
    def decide_batch(self, match: np.ndarray, conf: np.ndarray
                     ) -> List[EngineResult]:
        """ONE gate call for the whole (B, N) batch, demuxed back
        into per-request :class:`EngineResult`\\ s identical to what the
        sequential engine produces.  The gate's four outputs come to the
        host as one (B, 2 + 2D) float32 block: one transfer and one
        synchronisation per batch (decision indices are small integers,
        exact in float32)."""
        self.gate_calls += 1
        idx, c, gates, scores = self._gate(match, conf)
        D = len(self.decisions)
        host = torch.cat([idx[:, None].float(), c[:, None].float(),
                          gates.float(), scores.float()], 1).cpu().numpy()
        idx = host[:, 0].astype(np.int64)
        c = host[:, 1]
        gates = host[:, 2:2 + D]
        scores = host[:, 2 + D:]
        out: List[EngineResult] = []
        for b in range(len(idx)):
            i = int(idx[b])
            matched = [(self.decisions[j].name, float(scores[b, j]))
                       for j in range(len(self.decisions))
                       if gates[b, j] > 0]
            dec = self.decisions[i] if i >= 0 else None
            out.append(EngineResult(dec, float(c[b]) if dec else 0.0,
                                    matched))
        return out

    def signal_tensors(self, sigs: Sequence[SignalResult]
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Project a batch of SignalResults onto the frozen vocabulary:
        (B, N) match bits and confidences in gate column order."""
        B = len(sigs)
        match = np.zeros((B, len(self.keys)), np.float32)
        conf = np.zeros((B, len(self.keys)), np.float32)
        for b, s in enumerate(sigs):
            m, c = s.as_vector(list(self.key_objs))
            match[b] = m
            conf[b] = c
        return match, conf


class DecisionPlan:
    """Per-batch decision work: the (B, N) tensors ``stage_signals``
    emits against the program vocabulary, evaluated by ``stage_decide``
    with exactly one jitted gate call (memoized)."""

    def __init__(self, program: RouterProgram):
        self.program = program
        self.match: Optional[np.ndarray] = None
        self.conf: Optional[np.ndarray] = None
        self._results: Optional[List[EngineResult]] = None

    @property
    def ready(self) -> bool:
        return self.match is not None and self.program._gate is not None

    def set_signals(self, sigs: Sequence[SignalResult]):
        self.match, self.conf = self.program.signal_tensors(sigs)

    def evaluate(self) -> List[EngineResult]:
        if self._results is None:
            self._results = self.program.decide_batch(self.match, self.conf)
        return self._results


def compile_router_program(source: Union[str, RouterConfig],
                           name: str = "default", version: int = 1,
                           lint: str = "warn",
                           device: DeviceLike = "cuda") -> RouterProgram:
    """DSL text or an already-compiled RouterConfig -> RouterProgram.
    DSL input is validated lint-strict: Level-1 (syntax) AND Level-2
    (unresolved references) diagnostics raise, so a broken policy can
    never reach the registry swap — the old program keeps serving.

    ``lint`` controls the Level-4 semantic pass (BDD policy verifier):

    * ``"strict"`` — fatal L4 findings (unsatisfiable/shadowed decisions,
      dangling model references) ALSO raise, unless the source carries
      the ``# vsr-lint: demo`` pragma;
    * ``"warn"`` (default) — findings are computed and attached to the
      program as ``lint_findings`` but never reject it;
    * ``"off"`` — skip the verifier entirely.

    ``device`` is the program's (see :class:`RouterProgram`).
    """
    if isinstance(source, str):
        from repro_torch.core.dsl import compile_source
        cfg, diags = compile_source(source, strict=True)
        bad = [d for d in diags if d.level <= 2]
        if bad:
            raise ValueError("policy compile failed:\n" +
                             "\n".join(str(d) for d in bad))
    else:
        cfg = source
    findings = []
    if lint != "off":
        from repro_torch.analysis.policy_verify import (is_demo_source,
                                                        verify_config)
        findings = verify_config(cfg)
        fatal = [d for d in findings if d.fatal]
        if lint == "strict" and fatal and not (
                isinstance(source, str) and is_demo_source(source)):
            raise ValueError("policy verification failed (L4):\n" +
                             "\n".join(str(d) for d in fatal))
    program = RouterProgram(cfg, name=name, version=version, device=device)
    program.lint_findings = findings
    return program
