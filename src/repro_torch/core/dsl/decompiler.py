"""RouterConfig -> DSL source reconstruction (§6.6): plugin template
extraction, rule-tree -> WHEN string with precedence-aware parens, signal
type inference.  Round-trip: compile(decompile(cfg)) == cfg (validated by
the property tests).
A copy of ``repro.core.dsl.decompiler``.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Any, Dict

from repro_torch.core.decision import RuleNode
from repro_torch.core.types import RouterConfig


def _fmt_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, list):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    if isinstance(v, dict):
        return "{ " + ", ".join(f"{k}: {_fmt_value(x)}"
                                for k, x in v.items()) + " }"
    return json.dumps(v)


def _fmt_block(cfg: Dict[str, Any]) -> str:
    if not cfg:
        return "{}"
    inner = ", ".join(f"{k}: {_fmt_value(v)}" for k, v in cfg.items())
    return "{ " + inner + " }"


def rule_to_when(node: RuleNode, parent: str = "top") -> str:
    if node.op == "leaf":
        return f'{node.key.type}("{node.key.name}")'
    if node.op == "not":
        return "NOT " + rule_to_when(node.children[0], "not")
    sep = " AND " if node.op == "and" else " OR "
    body = sep.join(rule_to_when(c, node.op) for c in node.children)
    # parenthesize every non-top composite so tree SHAPE survives the
    # round trip (AND(AND(a,b),c) must not flatten to a AND b AND c)
    return body if parent == "top" else f"({body})"


def decompile(cfg: RouterConfig) -> str:
    lines = []
    for type_, rules in cfg.signals.items():
        for name, rcfg in rules.items():
            lines.append(f"SIGNAL {type_} {name} {_fmt_block(rcfg)}")
    if cfg.signals:
        lines.append("")

    # plugin template extraction: configs used by >= 2 routes are factored
    usage = Counter()
    for d in cfg.decisions:
        for ptype, pcfg in d.plugins.items():
            usage[(ptype, json.dumps(pcfg, sort_keys=True))] += 1
    templates = {}
    for i, ((ptype, pjson), n) in enumerate(sorted(usage.items())):
        if n >= 2:
            tname = f"shared_{ptype}_{len(templates)}"
            templates[(ptype, pjson)] = tname
            lines.append(f"PLUGIN {tname} {ptype} "
                         f"{_fmt_block(json.loads(pjson))}")
    if templates:
        lines.append("")

    for d in cfg.decisions:
        desc = f' (description = {json.dumps(d.description)})' \
            if d.description else ""
        lines.append(f"ROUTE {d.name}{desc} {{")
        lines.append(f"  PRIORITY {d.priority}")
        lines.append(f"  WHEN {rule_to_when(d.rule)}")
        models = []
        for m in d.model_refs:
            params = []
            if m.reasoning:
                params.append("reasoning = true")
            if m.effort != "medium":
                params.append(f"effort = {json.dumps(m.effort)}")
            if m.lora_adapter:
                params.append(f"lora = {json.dumps(m.lora_adapter)}")
            if m.weight != 1.0:
                params.append(f"weight = {m.weight!r}")
            p = f" ({', '.join(params)})" if params else ""
            models.append(f'"{m.name}"{p}')
        lines.append(f"  MODEL {', '.join(models)}")
        if d.algorithm and d.algorithm != "static":
            acfg = f" {_fmt_block(d.algorithm_config)}" \
                if d.algorithm_config else ""
            lines.append(f"  ALGORITHM {d.algorithm}{acfg}")
        if d.slo is not None:
            s: Dict[str, Any] = {}
            if d.slo.cls != "standard":
                s["class"] = d.slo.cls
            if d.slo.priority:
                s["priority"] = d.slo.priority
            if d.slo.ttft_ms:
                s["ttft_ms"] = d.slo.ttft_ms
            if d.slo.degrade_to:
                s["degrade_to"] = d.slo.degrade_to
            lines.append(f"  SLO {_fmt_block(s)}")
        for ptype, pcfg in d.plugins.items():
            key = (ptype, json.dumps(pcfg, sort_keys=True))
            if key in templates:
                lines.append(f"  PLUGIN {templates[key]}")
            else:
                lines.append(f"  PLUGIN p_{d.name}_{ptype} {ptype} "
                             f"{_fmt_block(pcfg)}")
        lines.append("}")
        lines.append("")

    for e in cfg.endpoints:
        ecfg = {"address": e.address, "port": e.port, "weight": e.weight}
        if e.models:
            ecfg["models"] = e.models
        if e.modality:
            ecfg["modality"] = e.modality
        if e.auth != "passthrough":
            ecfg["auth"] = e.auth
            if e.auth_config:
                ecfg["auth_config"] = e.auth_config
        lines.append(f"BACKEND {e.name} {e.provider} {_fmt_block(ecfg)}")
    if cfg.endpoints:
        lines.append("")

    g: Dict[str, Any] = {}
    if cfg.default_model:
        g["default_model"] = cfg.default_model
    g["strategy"] = cfg.strategy
    if cfg.fuzzy:
        g["fuzzy"] = True
    if cfg.fuzzy_threshold != 0.5:
        g["fuzzy_threshold"] = cfg.fuzzy_threshold
    if cfg.embedding_backend != "hash":
        g["embedding_backend"] = cfg.embedding_backend
    if cfg.classifier_backend:
        g["classifier_backend"] = cfg.classifier_backend
    if cfg.prefix_affinity:
        g["prefix_affinity"] = cfg.prefix_affinity
    if cfg.overload is not None:
        ov: Dict[str, Any] = {}
        p = cfg.overload
        if p.queue_depth != 64:
            ov["queue_depth"] = p.queue_depth
        if p.slot_occupancy != 0.95:
            ov["slot_occupancy"] = p.slot_occupancy
        if p.free_block_frac != 0.05:
            ov["free_block_frac"] = p.free_block_frac
        if p.ttft_ms:
            ov["ttft_ms"] = p.ttft_ms
        if p.shed_below != 100:
            ov["shed_below"] = p.shed_below
        if p.retry_after_s != 1.0:
            ov["retry_after_s"] = p.retry_after_s
        if p.default_class:
            ov["default_class"] = p.default_class
        g["overload"] = ov
    if cfg.speculative is not None:
        sp: Dict[str, Any] = {}
        s = cfg.speculative
        if s.draft_model:
            sp["draft_model"] = s.draft_model
        if s.k != 4:
            sp["k"] = s.k
        if not s.adaptive:
            sp["adaptive"] = False
        if s.probe_every != 16:
            sp["probe_every"] = s.probe_every
        g["speculative"] = sp
    if cfg.model_profiles:
        g["model_profiles"] = {
            m: {"cost_per_mtok": p.cost_per_mtok, "quality": p.quality,
                **({"arch": p.arch} if p.arch else {})}
            for m, p in cfg.model_profiles.items()}
    lines.append(f"GLOBAL {_fmt_block(g)}")
    return "\n".join(lines) + "\n"
