"""``python -m repro_torch.analysis <path>... [--strict]`` — lint policy
files (``repro.analysis.__main__``' twin).

Runs the full validation stack over every ``*.vsr``/``*.dsl`` file:
Level 1-3 (syntax, reference resolution, semantic constraints, from
:mod:`repro_torch.core.dsl.validate`) plus the Level-4 BDD-backed policy
verifier (:mod:`repro_torch.analysis.policy_verify`).  Each finding prints as
``file:line:col: [LEVEL] message`` with the witness assignment inline.

Exit status: ``--strict`` exits nonzero when any non-demo file has a
Level-1/2 diagnostic or a fatal Level-4 finding; without ``--strict``
the exit status only reflects files that fail to parse at all.  Files
whose header carries ``# vsr-lint: demo`` are analyzed and reported but
never fail the gate (they exist to exercise the finding catalog).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Tuple

from repro_torch.analysis.policy_verify import is_demo_source, verify_config
from repro_torch.core.dsl import compile_source
from repro_torch.core.dsl.ast_nodes import Diagnostic


def collect_files(paths) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, fns in sorted(os.walk(p)):
                files.extend(os.path.join(root, fn) for fn in sorted(fns)
                             if os.path.splitext(fn)[1] in (".vsr", ".dsl"))
        else:
            files.append(p)
    return files


def lint_file(path: str) -> Tuple[List[Diagnostic], bool, bool]:
    """Lint one policy file.  Returns ``(diagnostics, parse_ok, demo)``."""
    with open(path) as f:
        src = f.read()
    demo = is_demo_source(src)
    try:
        cfg, diags = compile_source(src, strict=True)
    except Exception as e:              # lexer/parser hard failure
        return [Diagnostic(1, str(e))], False, demo
    diags = list(diags)
    if not any(d.level <= 2 for d in diags):
        # the config only means something once it resolves — run L4
        diags.extend(verify_config(cfg))
    return diags, True, demo


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="BDD-backed policy verifier (L1-L4 lint)")
    ap.add_argument("paths", nargs="*", default=["examples/policies"],
                    help="policy files or directories (default: "
                         "examples/policies)")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on L1/L2 diagnostics or fatal L4 "
                         "findings (demo-pragma files exempt)")
    ap.add_argument("--no-demo-exempt", action="store_true",
                    help="apply --strict to '# vsr-lint: demo' files too")
    args = ap.parse_args(argv)

    files = collect_files(args.paths or ["examples/policies"])
    if not files:
        print("no policy files found", file=sys.stderr)
        return 2

    failing = 0
    unparsable = 0
    total_findings = 0
    for path in files:
        diags, parse_ok, demo = lint_file(path)
        unparsable += 0 if parse_ok else 1
        total_findings += len(diags)
        for d in diags:
            print(f"{path}: {d}")       # Diagnostic.__str__ carries line:col
        bad = (not parse_ok
               or any(d.level <= 2 for d in diags)
               or any(d.level == 4 and d.fatal for d in diags))
        if bad and demo and not args.no_demo_exempt:
            print(f"{path}: DEMO (findings reported, gate exempt)")
            bad = False
        if bad:
            failing += 1
            print(f"{path}: FAIL")
        elif diags:
            print(f"{path}: OK ({len(diags)} finding(s))")
        else:
            print(f"{path}: OK")
    print(f"analysis: {len(files)} file(s), {total_findings} finding(s), "
          f"{failing} failing")
    if failing and args.strict:
        return 1
    return 1 if unparsable else 0


if __name__ == "__main__":
    sys.exit(main())
