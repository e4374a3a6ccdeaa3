"""DSL -> RouterConfig compilation (§6.4 stage 3).  A copy of ``repro.core.dsl.compiler``."""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.decision import RuleNode, and_, leaf, not_, or_
from repro_torch.core.dsl.ast_nodes import (BoolAnd, BoolExpr, BoolNot, BoolOr,
                                            Program, SignalRefExpr)
from repro_torch.core.dsl.parser import parse
from repro_torch.core.dsl.validate import validate
from repro_torch.core.types import (Decision, Endpoint, ModelProfile, ModelRef,
                                    OverloadPolicy, RouterConfig, SLOSpec,
                                    SpecPolicy)


def _slo_spec(d: Dict[str, Any]) -> SLOSpec:
    return SLOSpec(
        cls=str(d.get("class", "standard")),
        priority=int(d.get("priority", 0)),
        ttft_ms=float(d.get("ttft_ms", 0.0)),
        degrade_to=str(d.get("degrade_to", "")))


def _expr_to_rule(e: BoolExpr) -> RuleNode:
    if isinstance(e, SignalRefExpr):
        return leaf(e.type, e.name)
    if isinstance(e, BoolAnd):
        return and_(*[_expr_to_rule(c) for c in e.children])
    if isinstance(e, BoolOr):
        return or_(*[_expr_to_rule(c) for c in e.children])
    if isinstance(e, BoolNot):
        return not_(_expr_to_rule(e.child))
    raise TypeError(e)


def compile_program(prog: Program) -> RouterConfig:
    cfg = RouterConfig()
    for s in prog.signals:
        cfg.signals.setdefault(s.type, {})[s.name] = dict(s.config)
    templates = {p.name: (p.type, dict(p.config)) for p in prog.plugins}
    cfg.plugin_templates = {}

    for r in prog.routes:
        plugins: Dict[str, Dict[str, Any]] = {}
        for ref in r.plugin_refs:
            if ref in templates:
                ptype, pcfg = templates[ref]
                plugins[ptype] = dict(pcfg)
        for ip in r.inline_plugins:   # route-local fields override templates
            base = dict(templates.get(ip.name, (ip.type, {}))[1])
            base.update(ip.config)
            plugins[ip.type] = base
        refs = [ModelRef(m.name,
                         reasoning=bool(m.params.get("reasoning", False)),
                         effort=str(m.params.get("effort", "medium")),
                         lora_adapter=m.params.get("lora"),
                         weight=float(m.params.get("weight", 1.0)))
                for m in r.models]
        cfg.decisions.append(Decision(
            name=r.name,
            rule=_expr_to_rule(r.when) if r.when else leaf("keyword",
                                                           "__never__"),
            model_refs=refs, priority=r.priority, plugins=plugins,
            algorithm=r.algorithm or "static",
            algorithm_config=dict(r.algorithm_config),
            description=r.description,
            slo=_slo_spec(r.slo) if r.slo is not None else None))

    for b in prog.backends:
        c = b.config
        if b.type in ("embedding", "cache", "memory"):
            # infra bindings, not endpoints
            cfg.plugin_templates.setdefault("_infra", {})[b.name] = \
                dict(c, kind=b.type)
            continue
        cfg.endpoints.append(Endpoint(
            name=b.name, provider=b.type,
            address=str(c.get("address", "127.0.0.1")),
            port=int(c.get("port", 8000)),
            weight=float(c.get("weight", 1.0)),
            models=list(c.get("models", [])),
            auth=str(c.get("auth", "passthrough")),
            auth_config={k: str(v) for k, v in c.get("auth_config",
                                                     {}).items()},
            modality=str(c.get("modality", ""))))

    if prog.global_:
        g = prog.global_.config
        cfg.default_model = str(g.get("default_model", ""))
        cfg.strategy = str(g.get("strategy", "priority"))
        cfg.fuzzy = bool(g.get("fuzzy", False))
        cfg.fuzzy_threshold = float(g.get("fuzzy_threshold", 0.5))
        cfg.embedding_backend = str(g.get("embedding_backend", "hash"))
        cfg.classifier_backend = str(g.get("classifier_backend", ""))
        cfg.prefix_affinity = float(g.get("prefix_affinity", 0.0))
        ov = g.get("overload")
        if isinstance(ov, dict):
            cfg.overload = OverloadPolicy(
                queue_depth=int(ov.get("queue_depth", 64)),
                slot_occupancy=float(ov.get("slot_occupancy", 0.95)),
                free_block_frac=float(ov.get("free_block_frac", 0.05)),
                ttft_ms=float(ov.get("ttft_ms", 0.0)),
                shed_below=int(ov.get("shed_below", 100)),
                retry_after_s=float(ov.get("retry_after_s", 1.0)),
                default_class=str(ov.get("default_class", "")))
        sp = g.get("speculative")
        if isinstance(sp, dict):
            cfg.speculative = SpecPolicy(
                draft_model=str(sp.get("draft_model", "")),
                k=int(sp.get("k", 4)),
                adaptive=bool(sp.get("adaptive", True)),
                probe_every=int(sp.get("probe_every", 16)))
        for mname, prof in g.get("model_profiles", {}).items():
            if isinstance(prof, dict):
                cfg.model_profiles[mname] = ModelProfile(
                    mname,
                    cost_per_mtok=float(prof.get("cost_per_mtok", 1.0)),
                    quality=float(prof.get("quality", 0.5)),
                    latency_ms=float(prof.get("latency_ms", 200.0)),
                    arch=prof.get("arch"))
    return cfg


def compile_source(src: str, strict: bool = True):
    """Returns (RouterConfig, diagnostics).  strict raises on Level-1."""
    prog = parse(src)
    diags = list(prog.diagnostics) + validate(prog)
    if strict and any(d.level == 1 for d in diags):
        raise ValueError("DSL compile failed:\n" +
                         "\n".join(str(d) for d in diags if d.level == 1))
    return compile_program(prog), diags
