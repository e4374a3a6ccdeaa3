"""repro_torch.analysis — the policy verifier half of the reference's
static analysis plane (``repro.analysis``).

:mod:`repro_torch.analysis.bdd` (a hash-consed ROBDD engine) and
:mod:`repro_torch.analysis.policy_verify` (the Level-4 semantic pass over
compiled router policies, each finding a typed
:class:`~repro_torch.core.dsl.ast_nodes.Diagnostic` with a witness
assignment) are copies of the reference's.  The reference's engine lint
(``jaxpr_lint``) lints jitted JAX functions and has no counterpart here.
"""

from repro_torch.analysis.bdd import BDD, at_most_one, rule_to_bdd
from repro_torch.analysis.policy_verify import (derive_mutex_groups,
                                                      is_demo_source, verify_config,
                                                      verify_program)

__all__ = [
    "BDD", "at_most_one", "rule_to_bdd",
    "derive_mutex_groups", "is_demo_source", "verify_config",
    "verify_program",
]
