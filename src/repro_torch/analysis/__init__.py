"""repro_torch.analysis — the static analysis plane (``repro.analysis``'
twin).

Two halves:

* **Policy verifier**: :mod:`repro_torch.analysis.bdd` (a hash-consed
  ROBDD engine) and :mod:`repro_torch.analysis.policy_verify` (the
  Level-4 semantic pass over compiled router policies, each finding a
  typed :class:`~repro_torch.core.dsl.ast_nodes.Diagnostic` with a
  witness assignment), copies of the reference's.
* **Engine lint**: :mod:`repro_torch.analysis.op_lint`, the counterpart
  of the reference's ``jaxpr_lint``: intermediate-size budgets, banned
  shapes and host-sync bans over the aten ops a function runs (kernel
  calls opaque), and a guard over the kernel build's counters.

CLI: ``python -m repro_torch.analysis examples/policies [--strict]``.
"""

from repro_torch.analysis.bdd import BDD, at_most_one, rule_to_bdd
from repro_torch.analysis.op_lint import (LintFinding, RecompileGuard,
                                          build_counters, jit_cache_size,
                                          lint_fn)
from repro_torch.analysis.policy_verify import (derive_mutex_groups,
                                                      is_demo_source, verify_config,
                                                      verify_program)

__all__ = [
    "BDD", "at_most_one", "rule_to_bdd",
    "LintFinding", "RecompileGuard", "build_counters", "jit_cache_size",
    "lint_fn",
    "derive_mutex_groups", "is_demo_source", "verify_config",
    "verify_program",
]
