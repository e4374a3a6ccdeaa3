"""Level-4 policy verification: BDD-backed semantic analysis of a
compiled :class:`~repro_torch.core.types.RouterConfig` / ``RouterProgram``.
A copy of ``repro.analysis.policy_verify``.

The DSL's three validation levels (§6.7: syntax, reference resolution,
semantic constraints) check the TEXT of a policy; this pass checks its
MEANING under the exact ``build_decision_gate`` execution semantics.
Every decision's rule compiles to an ROBDD over the frozen signal
vocabulary and the verifier reports, each as a typed
:class:`~repro_torch.core.dsl.ast_nodes.Diagnostic` at the new Level 4:

* **unsat** (fatal) — a decision whose rule can never be true (under the
  one-hot mutex structure of classifier signals);
* **shadowed** (fatal) — a satisfiable decision that can never be
  SELECTED: every assignment where it fires is claimed by a decision
  ranked strictly earlier in the gate's (-priority, declaration-order)
  rank permutation;
* **overlap** (warning) — two same-priority decisions with DIFFERENT
  model pools both reachable on some assignment (deterministic today via
  declaration order, but a reorder silently changes routing) — with a
  concrete witness assignment from the BDD;
* **coverage hole** (warning) — some mutex-consistent assignment matches
  no decision and no ``default_model`` backstops it (dead-zoned traffic);
* **reference integrity** (fatal/warning) — decision models,
  ``default_model`` and SLO ``degrade_to`` targets checked against the
  declared fleet topology (profiles + endpoints), including backend-lane
  compatibility: the static twin of the runtime lane fallback;
* **SLO graph** (warning) — ``degrade_to`` cycles between classes,
  ``shed_below`` excluding every declared class;
* **plugin chain** (warning) — a write half without its read half.

Witness assignments ride the Diagnostic ``witness`` payload so an
operator (or quickfix tooling) can reproduce the finding by issuing a
request with exactly those signals.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.bdd import BDD, at_most_one, rule_to_bdd
from repro_torch.core.decision import RuleNode, leaf_keys
from repro_torch.core.dsl.ast_nodes import Diagnostic
from repro_torch.core.types import Decision, RouterConfig

# the compiler's placeholder rule for WHEN-less routes: intentionally
# never fires at runtime (the signal engine never emits this key), so the
# verifier must not flag it as an unsat bug
NEVER_KEY = "keyword:__never__"

# single-label classifier heads: the head predicts ONE label, so signals
# of the type whose accepted-label sets are pairwise disjoint are
# mutually exclusive by construction (at most one can match per request)
MUTEX_LABEL_FIELDS = {
    "modality": "modalities",
    "domain": "mmlu_categories",
    "user_feedback": "categories",
}

# demo-policy pragma: a policy file whose header carries this marker is
# analyzed and reported but never fails a strict gate (it exists to
# exercise the finding catalog, e.g. examples/policies/lint_demo.vsr)
DEMO_PRAGMA = "vsr-lint: demo"


def is_demo_source(src: str) -> bool:
    head = "\n".join(src.splitlines()[:5])
    return DEMO_PRAGMA in head


def derive_mutex_groups(cfg: RouterConfig) -> List[List[str]]:
    """Mutually-exclusive signal-key groups implied by the config's
    one-hot classifier heads: signals of a single-label type whose
    accepted-label sets are pairwise disjoint.  Greedy grouping — a
    signal joins the group only if disjoint with every member."""
    groups: List[List[str]] = []
    for type_, field in MUTEX_LABEL_FIELDS.items():
        labeled = []
        for name, scfg in sorted(cfg.signals.get(type_, {}).items()):
            labels = {str(v).lower() for v in scfg.get(field, [])}
            labeled.append((f"{type_}:{name}", labels))
        group: List[Tuple[str, Set[str]]] = []
        for key, labels in labeled:
            if all(not (labels & other) for _, other in group):
                group.append((key, labels))
        if len(group) > 1:
            groups.append([k for k, _ in group])
    return groups


def _is_never_rule(rule: RuleNode) -> bool:
    return rule.op == "leaf" and str(rule.key) == NEVER_KEY


def _lane_of_decision(cfg: RouterConfig, d: Decision, bdd: BDD, f: int,
                      key_idx: Dict[str, int]) -> str:
    """The backend lane a decision's traffic lands on: when its rule
    IMPLIES a positive modality-signal match, the lane of that signal's
    first accepted label; else the text lane."""
    from repro_torch.core.pipeline import LANE_OF_LABEL
    for name, scfg in cfg.signals.get("modality", {}).items():
        key = f"modality:{name}"
        i = key_idx.get(key)
        if i is None:
            continue
        if bdd.implies(f, bdd.var(i)):
            labels = [str(v) for v in scfg.get("modalities", [])]
            if labels:
                return LANE_OF_LABEL.get(labels[0], "text")
    return "text"


def _model_servable(cfg: RouterConfig, model: str, lane: str = "text"
                    ) -> Tuple[bool, bool]:
    """(known, lane_ok): is ``model`` declared anywhere in the topology,
    and does some endpoint of a compatible modality serve it?  With no
    endpoints declared the lane check degrades to known-ness (there is
    no topology to contradict)."""
    known = model in cfg.model_profiles
    eps = [e for e in cfg.endpoints
           if not e.models or model in e.models]
    if eps:
        known = True
    if not cfg.endpoints:
        return known, True
    lane_ok = any(not e.modality or e.modality == lane for e in eps)
    return known, lane_ok


def _witness(bdd: BDD, u: int, keys: Sequence[str]
             ) -> Optional[Dict[str, bool]]:
    assign = bdd.any_sat(u)
    if assign is None:
        return None
    return {keys[i]: v for i, v in sorted(assign.items())}


def verify_config(cfg: RouterConfig,
                  mutex_groups: Optional[List[List[str]]] = None
                  ) -> List[Diagnostic]:
    """Run the full Level-4 pass over a compiled RouterConfig.  Returns
    typed diagnostics; ``fatal`` ones reject the policy under lint-strict
    compile / hot-reload / CI."""
    out: List[Diagnostic] = []
    decisions = list(cfg.decisions)
    declared = {f"{t}:{n}" for t, sigs in cfg.signals.items() for n in sigs}
    keys = sorted({str(k) for d in decisions for k in leaf_keys(d.rule)
                   if str(k) != NEVER_KEY
                   and (str(k) in declared or not cfg.signals)})
    key_idx = {k: i for i, k in enumerate(keys)}
    bdd = BDD(len(keys))

    # undeclared signal references fold to constant FALSE (their runtime
    # semantics); report them — unless it is the WHEN-less placeholder
    if cfg.signals:
        for d in decisions:
            for k in leaf_keys(d.rule):
                ks = str(k)
                if ks not in declared and ks != NEVER_KEY:
                    out.append(Diagnostic(
                        4, f"decision {d.name!r}: references undeclared "
                           f"signal {ks!r} (always false at runtime)"))

    if mutex_groups is None:
        mutex_groups = derive_mutex_groups(cfg)
    space = bdd.TRUE
    for group in mutex_groups:
        vs = [key_idx[k] for k in group if k in key_idx]
        if len(vs) > 1:
            space = bdd.and_(space, at_most_one(bdd, vs))

    fs = [rule_to_bdd(bdd, d.rule, key_idx) for d in decisions]
    never = [_is_never_rule(d.rule) for d in decisions]
    sat = [bdd.and_(space, f) for f in fs]

    # ---- unsat: the decision can never fire --------------------------
    for i, d in enumerate(decisions):
        if never[i]:
            continue
        if fs[i] == bdd.FALSE:
            out.append(Diagnostic(
                4, f"decision {d.name!r}: rule is unsatisfiable — "
                   "it can never fire", fatal=True))
        elif sat[i] == bdd.FALSE:
            out.append(Diagnostic(
                4, f"decision {d.name!r}: rule requires mutually-"
                   "exclusive one-hot signals — it can never fire",
                fatal=True))

    # ---- shadowing under the exact gate rank permutation -------------
    # (priority strategy: first match in (-priority, declaration-order)
    # rank wins; a decision whose entire match set is claimed earlier in
    # the rank can never be selected)
    if cfg.strategy == "priority":
        rank = sorted(range(len(decisions)),
                      key=lambda i: (-decisions[i].priority, i))
        pre = bdd.FALSE
        for i in rank:
            d = decisions[i]
            if not never[i] and sat[i] != bdd.FALSE and \
                    bdd.and_(sat[i], bdd.not_(pre)) == bdd.FALSE:
                shadows = [decisions[j].name for j in rank
                           if rank.index(j) < rank.index(i)
                           and bdd.and_(sat[i], fs[j]) != bdd.FALSE]
                out.append(Diagnostic(
                    4, f"decision {d.name!r} (priority {d.priority}) is "
                       f"fully shadowed by {shadows} — it matches but "
                       "can never be selected", fatal=True,
                    witness=_witness(bdd, sat[i], keys)))
            pre = bdd.or_(pre, fs[i])

        # ---- same-priority overlap with differing pools --------------
        by_prio: Dict[int, List[int]] = {}
        for i, d in enumerate(decisions):
            if not never[i]:
                by_prio.setdefault(d.priority, []).append(i)
        for p, idxs in sorted(by_prio.items(), reverse=True):
            higher = bdd.disj([fs[j] for j, d in enumerate(decisions)
                               if d.priority > p and not never[j]])
            for a_pos, i in enumerate(idxs):
                for j in idxs[a_pos + 1:]:
                    pool_i = tuple(sorted(m.name
                                          for m in decisions[i].model_refs))
                    pool_j = tuple(sorted(m.name
                                          for m in decisions[j].model_refs))
                    if pool_i == pool_j:
                        continue
                    o = bdd.and_(bdd.and_(sat[i], fs[j]),
                                 bdd.not_(higher))
                    if o != bdd.FALSE:
                        out.append(Diagnostic(
                            4, f"decisions {decisions[i].name!r} and "
                               f"{decisions[j].name!r} (priority {p}) "
                               "overlap with different model pools "
                               f"({list(pool_i)} vs {list(pool_j)}); "
                               "declaration order decides — reordering "
                               "silently changes routing",
                            witness=_witness(bdd, o, keys)))

    # ---- coverage hole ----------------------------------------------
    fire_any = bdd.disj([f for f, nv in zip(fs, never) if not nv])
    dead = bdd.and_(space, bdd.not_(fire_any))
    if dead != bdd.FALSE and keys and not cfg.default_model:
        out.append(Diagnostic(
            4, f"coverage hole: {bdd.sat_count(dead)} of "
               f"{bdd.sat_count(space)} signal assignments match no "
               "decision and no default_model backstops them",
            witness=_witness(bdd, dead, keys)))

    # ---- reference integrity vs the declared fleet topology ----------
    # model_profiles are selection metadata, not an exhaustive registry:
    # the fleet can serve an unprofiled arch by name.  Only declared
    # endpoints are real topology, so unknown-model findings are fatal
    # only when endpoints exist to contradict the reference.
    has_topology = bool(cfg.model_profiles) or bool(cfg.endpoints)
    ref_fatal = bool(cfg.endpoints)
    if has_topology:
        for i, d in enumerate(decisions):
            if "fast_response" in d.plugins:
                continue            # short-circuits before dispatch
            lane = _lane_of_decision(cfg, d, bdd, fs[i], key_idx)
            for m in d.model_refs:
                known, lane_ok = _model_servable(cfg, m.name, lane)
                if not known:
                    out.append(Diagnostic(
                        4, f"decision {d.name!r}: model {m.name!r} is "
                           "neither profiled nor served by any declared "
                           "endpoint", fatal=ref_fatal))
                elif not lane_ok:
                    out.append(Diagnostic(
                        4, f"decision {d.name!r}: model {m.name!r} has "
                           f"no endpoint compatible with its {lane!r} "
                           "lane — runtime will fall back"))
        if cfg.default_model:
            known, _ = _model_servable(cfg, cfg.default_model)
            if not known:
                out.append(Diagnostic(
                    4, f"default_model {cfg.default_model!r} is neither "
                       "profiled nor served by any declared endpoint",
                    fatal=ref_fatal))

    # ---- SLO graph ---------------------------------------------------
    classes = {}
    model_to_classes: Dict[str, Set[str]] = {}
    for d in decisions:
        if d.slo is not None:
            classes.setdefault(d.slo.cls, d.slo)
            for m in d.model_refs:
                model_to_classes.setdefault(m.name, set()).add(d.slo.cls)
    for cls, slo in sorted(classes.items()):
        if not slo.degrade_to:
            continue
        if has_topology:
            known, lane_ok = _model_servable(cfg, slo.degrade_to)
            if not known:
                out.append(Diagnostic(
                    4, f"SLO class {cls!r}: degrade_to target "
                       f"{slo.degrade_to!r} is neither profiled nor "
                       "served by any declared endpoint (dangling "
                       "degrade edge)", fatal=ref_fatal))
            elif not lane_ok:
                out.append(Diagnostic(
                    4, f"SLO class {cls!r}: degrade_to target "
                       f"{slo.degrade_to!r} has no text-lane endpoint"))
    # degrade cycles: class -> (classes owning the degrade target model)
    edges = {cls: model_to_classes.get(slo.degrade_to, set()) - {cls}
             for cls, slo in classes.items() if slo.degrade_to}
    for start in sorted(edges):
        path, node = [start], start
        seen = {start}
        while True:
            nxts = sorted(edges.get(node, ()))
            if not nxts:
                break
            node = nxts[0]
            path.append(node)
            if node == start:
                out.append(Diagnostic(
                    4, "SLO degrade_to chain cycles: "
                       + " -> ".join(path)))
                break
            if node in seen:
                break
            seen.add(node)
    if cfg.overload is not None and classes:
        prios = {cls: slo.priority for cls, slo in classes.items()}
        if max(prios.values()) < cfg.overload.shed_below:
            out.append(Diagnostic(
                4, f"overload.shed_below={cfg.overload.shed_below} "
                   "exceeds every declared SLO class priority "
                   f"({prios}) — ALL traffic is best-effort under "
                   "overload"))
        dc = cfg.overload.default_class
        if dc and dc not in classes:
            out.append(Diagnostic(
                4, f"overload.default_class {dc!r} names no declared "
                   "SLO class"))

    # ---- plugin-chain sanity ----------------------------------------
    for d in decisions:
        for write, read in (("cache_write", "cache"),
                            ("memory_write", "memory")):
            if write in d.plugins and read not in d.plugins:
                out.append(Diagnostic(
                    4, f"decision {d.name!r}: plugin {write!r} has no "
                       f"{read!r} read half — writes can never be "
                       "served back"))
    return out


def verify_program(program) -> List[Diagnostic]:
    """Verify a compiled RouterProgram (delegates to its config)."""
    return verify_config(program.config)
