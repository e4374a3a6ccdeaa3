"""Three-level validation (§6.7): syntax diagnostics come from the parser;
this module adds Level-2 reference resolution (with fuzzy-matched QuickFix
suggestions) and Level-3 semantic constraints.
A copy of ``repro.core.dsl.validate``.
"""

from __future__ import annotations

import difflib
from typing import List

from repro_torch.core.dsl.ast_nodes import (BoolAnd, BoolNot, BoolOr, Diagnostic,
                                            Program, SignalRefExpr)
from repro_torch.core.types import SIGNAL_TYPES

KNOWN_ALGORITHMS = ("static", "elo", "routerdc", "hybrid", "automix", "knn",
                    "kmeans", "svm", "mlp", "thompson", "gmt", "latency",
                    "remom", "confidence")
KNOWN_PLUGIN_TYPES = ("cache", "fast_response", "system_prompt", "headers",
                      "modality", "memory", "rag", "halugate", "pii")
KNOWN_BACKENDS = ("vllm", "openai", "anthropic", "azure", "bedrock",
                  "gemini", "vertex", "ollama", "embedding", "cache",
                  "memory")
SLO_KEYS = ("class", "priority", "ttft_ms", "degrade_to")
OVERLOAD_KEYS = ("queue_depth", "slot_occupancy", "free_block_frac",
                 "ttft_ms", "shed_below", "retry_after_s", "default_class")
SPECULATIVE_KEYS = ("draft_model", "k", "adaptive", "probe_every")


def _refs(expr):
    if isinstance(expr, SignalRefExpr):
        yield expr
    elif isinstance(expr, (BoolAnd, BoolOr)):
        for c in expr.children:
            yield from _refs(c)
    elif isinstance(expr, BoolNot):
        yield from _refs(expr.child)


def validate(prog: Program) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    declared = {(s.type, s.name) for s in prog.signals}
    declared_names = {s.name for s in prog.signals}
    template_names = {p.name for p in prog.plugins}

    # ---- Level 2: reference resolution ------------------------------------
    for r in prog.routes:
        if r.when is not None:
            for ref in _refs(r.when):
                if (ref.type, ref.name) not in declared:
                    sugg = difflib.get_close_matches(
                        ref.name, list(declared_names), n=1, cutoff=0.6)
                    out.append(Diagnostic(
                        2, f"route {r.name!r}: WHEN references undefined "
                           f"signal {ref.type}(\"{ref.name}\")",
                        ref.pos.line, ref.pos.col,
                        quickfix=sugg[0] if sugg else None))
        for pref in r.plugin_refs:
            if pref not in template_names:
                sugg = difflib.get_close_matches(pref, list(template_names),
                                                 n=1, cutoff=0.6)
                out.append(Diagnostic(
                    2, f"route {r.name!r}: PLUGIN reference {pref!r} has no "
                       f"matching template", r.pos.line, r.pos.col,
                    quickfix=sugg[0] if sugg else None))

    # ---- Level 3: semantic constraints --------------------------------------
    for s in prog.signals:
        if s.type not in SIGNAL_TYPES:
            sugg = difflib.get_close_matches(s.type, SIGNAL_TYPES, n=1)
            out.append(Diagnostic(3, f"unknown signal type {s.type!r}",
                                  s.pos.line, s.pos.col,
                                  quickfix=sugg[0] if sugg else None))
        thr = s.config.get("threshold")
        if thr is not None and not (0.0 <= float(thr) <= 1.0):
            out.append(Diagnostic(
                3, f"signal {s.name!r}: threshold {thr} outside [0, 1]",
                s.pos.line, s.pos.col))
    for r in prog.routes:
        if r.priority < 0:
            out.append(Diagnostic(3, f"route {r.name!r}: negative priority",
                                  r.pos.line, r.pos.col))
        if r.algorithm and r.algorithm not in KNOWN_ALGORITHMS:
            sugg = difflib.get_close_matches(r.algorithm, KNOWN_ALGORITHMS,
                                             n=1)
            out.append(Diagnostic(
                3, f"route {r.name!r}: unknown algorithm {r.algorithm!r}",
                r.pos.line, r.pos.col,
                quickfix=sugg[0] if sugg else None))
        if not r.models:
            out.append(Diagnostic(3, f"route {r.name!r}: no MODEL declared",
                                  r.pos.line, r.pos.col))
        if r.slo is not None:
            for key in r.slo:
                if key not in SLO_KEYS:
                    sugg = difflib.get_close_matches(key, SLO_KEYS, n=1)
                    out.append(Diagnostic(
                        3, f"route {r.name!r}: unknown SLO key {key!r}",
                        r.pos.line, r.pos.col,
                        quickfix=sugg[0] if sugg else None))
            if int(r.slo.get("priority", 0)) < 0:
                out.append(Diagnostic(
                    3, f"route {r.name!r}: negative SLO priority",
                    r.pos.line, r.pos.col))
            if float(r.slo.get("ttft_ms", 0.0)) < 0:
                out.append(Diagnostic(
                    3, f"route {r.name!r}: negative SLO ttft_ms",
                    r.pos.line, r.pos.col))
    for p in prog.plugins:
        if p.type not in KNOWN_PLUGIN_TYPES:
            sugg = difflib.get_close_matches(p.type, KNOWN_PLUGIN_TYPES, n=1)
            out.append(Diagnostic(3, f"unknown plugin type {p.type!r}",
                                  p.pos.line, p.pos.col,
                                  quickfix=sugg[0] if sugg else None))
    for b in prog.backends:
        if b.type not in KNOWN_BACKENDS:
            sugg = difflib.get_close_matches(b.type, KNOWN_BACKENDS, n=1)
            out.append(Diagnostic(3, f"unknown backend type {b.type!r}",
                                  b.pos.line, b.pos.col,
                                  quickfix=sugg[0] if sugg else None))
        port = b.config.get("port")
        if port is not None and not (0 < int(port) < 65536):
            out.append(Diagnostic(3, f"backend {b.name!r}: port {port} "
                                     "out of range", b.pos.line, b.pos.col))
    if prog.global_:
        thr = prog.global_.config.get("fuzzy_threshold")
        if thr is not None and not (0.0 <= float(thr) <= 1.0):
            out.append(Diagnostic(
                3, f"GLOBAL fuzzy_threshold {thr} outside [0, 1]",
                prog.global_.pos.line, prog.global_.pos.col))
        ov = prog.global_.config.get("overload")
        if isinstance(ov, dict):
            for key in ov:
                if key not in OVERLOAD_KEYS:
                    sugg = difflib.get_close_matches(key, OVERLOAD_KEYS, n=1)
                    out.append(Diagnostic(
                        3, f"GLOBAL overload: unknown key {key!r}",
                        prog.global_.pos.line, prog.global_.pos.col,
                        quickfix=sugg[0] if sugg else None))
            for frac_key in ("slot_occupancy", "free_block_frac"):
                v = ov.get(frac_key)
                if v is not None and not (0.0 <= float(v) <= 1.0):
                    out.append(Diagnostic(
                        3, f"GLOBAL overload: {frac_key} {v} outside [0, 1]",
                        prog.global_.pos.line, prog.global_.pos.col))
        sp = prog.global_.config.get("speculative")
        if isinstance(sp, dict):
            for key in sp:
                if key not in SPECULATIVE_KEYS:
                    sugg = difflib.get_close_matches(key, SPECULATIVE_KEYS,
                                                     n=1)
                    out.append(Diagnostic(
                        3, f"GLOBAL speculative: unknown key {key!r}",
                        prog.global_.pos.line, prog.global_.pos.col,
                        quickfix=sugg[0] if sugg else None))
            if not str(sp.get("draft_model", "")):
                out.append(Diagnostic(
                    3, "GLOBAL speculative: draft_model is required",
                    prog.global_.pos.line, prog.global_.pos.col))
            for int_key in ("k", "probe_every"):
                v = sp.get(int_key)
                if v is not None and int(v) < 1:
                    out.append(Diagnostic(
                        3, f"GLOBAL speculative: {int_key} {v} must be >= 1",
                        prog.global_.pos.line, prog.global_.pos.col))
    return out


# ---------------------------------------------------------------------------
# policy lint entrypoint:  python -m repro_torch.core.dsl.validate <path>...
# ---------------------------------------------------------------------------

def lint_paths(paths) -> int:
    """Lint every ``*.vsr``/``*.dsl`` policy file under the given paths.
    Prints each diagnostic as ``file:line:col: [LEVEL] message``; returns
    the number of FAILING files: Level-1 syntax, Level-2 unresolved
    references, or fatal Level-4 verifier findings (unsatisfiable /
    shadowed decisions, dangling model references) — Level-3 constraints
    and non-fatal Level-4 findings print as warnings only.  Files whose
    header carries the ``# vsr-lint: demo`` pragma report findings but
    never fail."""
    import os

    from repro_torch.analysis.policy_verify import is_demo_source, verify_config
    from repro_torch.core.dsl import compile_source

    files = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, fns in sorted(os.walk(p)):
                files.extend(os.path.join(root, fn) for fn in sorted(fns)
                             if os.path.splitext(fn)[1] in (".vsr", ".dsl"))
        else:
            files.append(p)
    failed = 0
    for path in files:
        with open(path) as f:
            src = f.read()
        try:
            cfg, diags = compile_source(src, strict=True)
            diags = list(diags)
            if not any(d.level <= 2 for d in diags):
                diags.extend(verify_config(cfg))
        except Exception as e:          # lexer/parser hard failure
            print(f"{path}:0:0: [ERROR] {e}")
            failed += 1
            continue
        bad = [d for d in diags
               if d.level <= 2 or (d.level == 4 and d.fatal)]
        for d in diags:
            print(f"{path}:{d.line}:{d.col}: {d}")
        if bad and is_demo_source(src):
            print(f"{path}: DEMO (findings reported, gate exempt)")
            bad = []
        if bad:
            failed += 1
        else:
            print(f"{path}: OK"
                  + (f" ({len(diags)} finding(s))" if diags else ""))
    print(f"policy lint: {len(files)} file(s), {failed} failing")
    return failed


if __name__ == "__main__":
    import sys

    args = sys.argv[1:] or ["examples"]
    sys.exit(1 if lint_paths(args) else 0)
