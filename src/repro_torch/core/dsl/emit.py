"""Multi-target emission (§6.5): flat YAML, Kubernetes SemanticRouter CRD,
Helm values.  PyYAML-free: a small spec-subset emitter is included.
A copy of ``repro.core.dsl.emit``.
"""

from __future__ import annotations

from dataclasses import asdict
from typing import Any

from repro_torch.core.decision import RuleNode
from repro_torch.core.types import RouterConfig


def _yaml_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    if s == "" or any(c in s for c in ":#{}[],&*!|>'\"%@`") or \
            s.strip() != s or s.lower() in ("true", "false", "null", "yes",
                                            "no"):
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
    return s


def to_yaml(obj: Any, indent: int = 0) -> str:
    pad = "  " * indent
    if isinstance(obj, dict):
        if not obj:
            return pad + "{}"
        lines = []
        for k, v in obj.items():
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{_yaml_scalar(k)}:")
                lines.append(to_yaml(v, indent + 1))
            else:
                lines.append(f"{pad}{_yaml_scalar(k)}: "
                             f"{to_yaml_inline(v)}")
        return "\n".join(lines)
    if isinstance(obj, list):
        if not obj:
            return pad + "[]"
        lines = []
        for v in obj:
            if isinstance(v, (dict, list)) and v:
                body = to_yaml(v, indent + 1)
                first, _, rest = body.partition("\n")
                lines.append(f"{pad}- {first.strip()}")
                if rest:
                    lines.append(rest)
            else:
                lines.append(f"{pad}- {to_yaml_inline(v)}")
        return "\n".join(lines)
    return pad + to_yaml_inline(obj)


def to_yaml_inline(v: Any) -> str:
    if isinstance(v, dict):
        return "{}" if not v else \
            "{" + ", ".join(f"{_yaml_scalar(k)}: {to_yaml_inline(x)}"
                            for k, x in v.items()) + "}"
    if isinstance(v, list):
        return "[" + ", ".join(to_yaml_inline(x) for x in v) + "]"
    return _yaml_scalar(v)


# ---------------------------------------------------------------------------
# RouterConfig serialization
# ---------------------------------------------------------------------------

def rule_to_dict(node: RuleNode) -> dict:
    if node.op == "leaf":
        return {"signal": {"type": node.key.type, "name": node.key.name}}
    return {node.op: [rule_to_dict(c) for c in node.children]}


def config_to_dict(cfg: RouterConfig) -> dict:
    return {
        "signals": cfg.signals,
        "decisions": [{
            "name": d.name,
            "description": d.description,
            "priority": d.priority,
            "rule": rule_to_dict(d.rule),
            "models": [{k: v for k, v in asdict(m).items()
                        if v not in (None, "", 1.0, False, "medium")} or
                       {"name": m.name} for m in d.model_refs],
            "algorithm": d.algorithm,
            "algorithm_config": d.algorithm_config,
            "plugins": d.plugins,
            "slo": asdict(d.slo) if d.slo is not None else None,
        } for d in cfg.decisions],
        "plugin_templates": cfg.plugin_templates,
        "endpoints": [asdict(e) for e in cfg.endpoints],
        "model_profiles": {k: asdict(v)
                           for k, v in cfg.model_profiles.items()},
        "global": {"default_model": cfg.default_model,
                   "strategy": cfg.strategy,
                   "fuzzy": cfg.fuzzy,
                   "fuzzy_threshold": cfg.fuzzy_threshold,
                   "embedding_backend": cfg.embedding_backend,
                   "classifier_backend": cfg.classifier_backend,
                   "overload": asdict(cfg.overload)
                   if cfg.overload is not None else None},
    }


def emit_yaml(cfg: RouterConfig) -> str:
    """Flat RouterConfig YAML (local development target)."""
    return to_yaml(config_to_dict(cfg)) + "\n"


def emit_crd(cfg: RouterConfig, name: str = "semantic-router") -> str:
    """Kubernetes SemanticRouter custom resource (vllm.ai/v1alpha1)."""
    d = config_to_dict(cfg)
    endpoints = d.pop("endpoints")
    doc = {
        "apiVersion": "vllm.ai/v1alpha1",
        "kind": "SemanticRouter",
        "metadata": {"name": name},
        "spec": {
            "vllmEndpoints": [
                {"name": e["name"], "address": e["address"],
                 "port": e["port"], "weight": e["weight"],
                 "models": e["models"]} for e in endpoints],
            "config": d,
        },
    }
    return to_yaml(doc) + "\n"


def emit_helm(cfg: RouterConfig) -> str:
    """values.yaml nesting under config: for the Helm chart ConfigMap."""
    d = config_to_dict(cfg)
    # prune zero-value infra sections for clean output
    d = {k: v for k, v in d.items() if v}
    return to_yaml({"config": d}) + "\n"
