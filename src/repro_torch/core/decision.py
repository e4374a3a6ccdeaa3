"""Decision engine (paper §4): recursive Boolean rule nodes over signal
conditions, crisp + fuzzy evaluation, priority/confidence selection, the
Prop.-1 minterm constructor, and the batch decision gate (the "symbolic MoE
gate") as torch tensor functions on the device.

The port of ``repro.core.decision``.  The rule algebra and the sequential
engine are copies (pure Python).  ``build_decision_gate`` keeps the
reference's static rank permutation, leaf-occurrence counts and first-max
tie-break; the reference jits it with XLA (no Pallas kernel), the port runs
it as a few eager tensor ops.  The BDD-backed ``coverage_analysis`` and
``subsumes`` are copies over :mod:`repro_torch.analysis.bdd`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.types import Decision, SignalKey, SignalResult
from repro_torch.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# rule nodes (Definition 5)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RuleNode:
    op: str                                   # "leaf" | "and" | "or" | "not"
    key: Optional[SignalKey] = None           # for leaf
    children: Tuple["RuleNode", ...] = ()

    def __post_init__(self):
        assert self.op in ("leaf", "and", "or", "not"), self.op
        if self.op == "leaf":
            assert self.key is not None
        if self.op == "not":
            assert len(self.children) == 1, "not is strictly unary"


def leaf(type_: str, name: str) -> RuleNode:
    return RuleNode("leaf", key=SignalKey(type_, name))


def and_(*children: RuleNode) -> RuleNode:
    return RuleNode("and", children=tuple(children))


def or_(*children: RuleNode) -> RuleNode:
    return RuleNode("or", children=tuple(children))


def not_(child: RuleNode) -> RuleNode:
    return RuleNode("not", children=(child,))


def nor_(*children: RuleNode) -> RuleNode:
    return not_(or_(*children))


def nand_(*children: RuleNode) -> RuleNode:
    return not_(and_(*children))


def xor_(a: RuleNode, b: RuleNode) -> RuleNode:
    return or_(and_(a, not_(b)), and_(not_(a), b))


def leaf_keys(node: RuleNode) -> List[SignalKey]:
    if node.op == "leaf":
        return [node.key]
    out: List[SignalKey] = []
    for c in node.children:
        out.extend(leaf_keys(c))
    return out


# ---------------------------------------------------------------------------
# crisp evaluation (Equation 6)
# ---------------------------------------------------------------------------

def eval_crisp(node: RuleNode, s: SignalResult) -> bool:
    if node.op == "leaf":
        return s.matched(node.key.type, node.key.name)
    if node.op == "and":
        return all(eval_crisp(c, s) for c in node.children)
    if node.op == "or":
        return any(eval_crisp(c, s) for c in node.children)
    return not eval_crisp(node.children[0], s)


# ---------------------------------------------------------------------------
# fuzzy evaluation (Definition 6): (min, max, 1-x) over confidences
# ---------------------------------------------------------------------------

def eval_fuzzy(node: RuleNode, s: SignalResult) -> float:
    if node.op == "leaf":
        return s.confidence(node.key.type, node.key.name)
    if node.op == "and":
        return min(eval_fuzzy(c, s) for c in node.children)
    if node.op == "or":
        return max(eval_fuzzy(c, s) for c in node.children)
    return 1.0 - eval_fuzzy(node.children[0], s)


# ---------------------------------------------------------------------------
# confidence (Equation 7): mean confidence over satisfied leaf conditions
# ---------------------------------------------------------------------------

def confidence(node: RuleNode, s: SignalResult) -> float:
    sat = [s.confidence(k.type, k.name) for k in leaf_keys(node)
           if s.matched(k.type, k.name)]
    return sum(sat) / len(sat) if sat else 0.0


# ---------------------------------------------------------------------------
# engine (Algorithm 1)
# ---------------------------------------------------------------------------

@dataclass
class EngineResult:
    decision: Optional[Decision]
    confidence: float
    matched: List[Tuple[str, float]] = field(default_factory=list)


class DecisionEngine:
    def __init__(self, decisions: Sequence[Decision],
                 strategy: str = "priority", fuzzy: bool = False,
                 fuzzy_threshold: float = 0.5):
        assert strategy in ("priority", "confidence")
        self.decisions = list(decisions)
        self.strategy = strategy
        self.fuzzy = fuzzy
        self.fuzzy_threshold = fuzzy_threshold

    def evaluate(self, s: SignalResult) -> EngineResult:
        matched: List[Tuple[Decision, float]] = []
        for d in self.decisions:
            if self.fuzzy:
                score = eval_fuzzy(d.rule, s)
                if score >= self.fuzzy_threshold:
                    matched.append((d, score))
            else:
                if eval_crisp(d.rule, s):
                    matched.append((d, confidence(d.rule, s)))
        if not matched:
            return EngineResult(None, 0.0)
        if self.strategy == "priority":
            best = max(enumerate(matched),
                       key=lambda t: (t[1][0].priority, -t[0]))[1]
        else:
            best = max(matched, key=lambda t: t[1])
        return EngineResult(best[0], best[1],
                            [(d.name, c) for d, c in matched])


# ---------------------------------------------------------------------------
# Proposition 1: minterm construction — any f: {0,1}^N -> {0,1}
# ---------------------------------------------------------------------------

def from_truth_table(keys: Sequence[SignalKey], table: Sequence[int]
                     ) -> RuleNode:
    """Build a rule node realizing an arbitrary Boolean function given as a
    truth table over ``keys`` (row i = assignment binary(i), MSB first)."""
    n = len(keys)
    assert len(table) == 2 ** n
    minterms = []
    for row, val in enumerate(table):
        if not val:
            continue
        lits = []
        for i, k in enumerate(keys):
            bit = (row >> (n - 1 - i)) & 1
            lit = leaf(k.type, k.name)
            lits.append(lit if bit else not_(lit))
        minterms.append(and_(*lits) if len(lits) > 1 else lits[0])
    if not minterms:
        # constant false: AND(x, NOT(x)) over the first key
        x = leaf(keys[0].type, keys[0].name)
        return and_(x, not_(x))
    return or_(*minterms) if len(minterms) > 1 else minterms[0]


# ---------------------------------------------------------------------------
# logic-synthesis analyses (§4.5): coverage / conflicts / subsumption
# ---------------------------------------------------------------------------

def _eval_assignment(node: RuleNode, assign: Dict[str, bool]) -> bool:
    if node.op == "leaf":
        return assign.get(str(node.key), False)
    if node.op == "and":
        return all(_eval_assignment(c, assign) for c in node.children)
    if node.op == "or":
        return any(_eval_assignment(c, assign) for c in node.children)
    return not _eval_assignment(node.children[0], assign)


def _complete(assign: Dict[str, bool], keys: Sequence[str]
              ) -> Dict[str, bool]:
    """Fill a partial BDD witness out to a full assignment (unmentioned
    variables are don't-care along the witness path; False matches the
    runtime default for an unevaluated signal)."""
    return {k: assign.get(k, False) for k in keys}


def coverage_analysis(decisions: Sequence[Decision], max_vars: int = 16,
                      mutex_groups: Optional[Sequence[Sequence[str]]] = None):
    """Checks the signal space {0,1}^N for dead zones (no decision
    matches) and conflicts (multiple equal-priority decisions with
    different model pools match).  Symbolic over ROBDDs — no 2^N
    enumeration, no variable cap (``max_vars`` is kept for signature
    compatibility and ignored).  ``mutex_groups`` restricts the space to
    assignments where at most one signal per group is true (one-hot
    classifier heads), so dead-zone counts exclude impossible inputs."""
    from repro_torch.analysis.bdd import BDD, at_most_one, rule_to_bdd
    keys = sorted({str(k) for d in decisions for k in leaf_keys(d.rule)})
    key_idx = {k: i for i, k in enumerate(keys)}
    bdd = BDD(len(keys))
    space = bdd.TRUE
    for group in (mutex_groups or ()):
        vs = [key_idx[str(k)] for k in group if str(k) in key_idx]
        if len(vs) > 1:
            space = bdd.and_(space, at_most_one(bdd, vs))
    fs = [rule_to_bdd(bdd, d.rule, key_idx) for d in decisions]

    fire_any = bdd.disj(fs)
    dead = bdd.and_(space, bdd.not_(fire_any))
    dead_examples = [_complete({keys[i]: v for i, v in a.items()}, keys)
                     for a in bdd.sat_iter(dead, limit=4)]

    conflicts = []
    seen = set()
    prios = sorted({d.priority for d in decisions}, reverse=True)
    for p in prios:
        idxs = [i for i, d in enumerate(decisions) if d.priority == p]
        higher = bdd.disj([fs[i] for i, d in enumerate(decisions)
                           if d.priority > p])
        for a_pos, i in enumerate(idxs):
            for j in idxs[a_pos + 1:]:
                pool_i = tuple(sorted(m.name
                                      for m in decisions[i].model_refs))
                pool_j = tuple(sorted(m.name
                                      for m in decisions[j].model_refs))
                if pool_i == pool_j:
                    continue
                region = bdd.and_(bdd.and_(bdd.and_(space, fs[i]), fs[j]),
                                  bdd.not_(higher))
                for a in bdd.sat_iter(region, limit=4):
                    assign = _complete({keys[k]: v for k, v in a.items()},
                                       keys)
                    sig = tuple(sorted(assign.items()))
                    if sig in seen:
                        continue
                    seen.add(sig)
                    tied = [d.name for k, d in enumerate(decisions)
                            if d.priority == p
                            and _eval_assignment(d.rule, assign)]
                    conflicts.append((assign, tied))
    return {"n_vars": len(keys), "dead_zones": bdd.sat_count(dead),
            "conflicts": conflicts, "dead_examples": dead_examples}


def subsumes(a: RuleNode, b: RuleNode, max_vars: int = 14) -> bool:
    """True if a => b for every assignment (b is redundant given a's match
    set when pools are equal).  Symbolic containment over ROBDDs — exact
    at ANY width (``max_vars`` is kept for signature compatibility and
    ignored; the old truth-table version silently returned False above
    the cap, as if it had PROVEN non-containment)."""
    from repro_torch.analysis.bdd import BDD, rule_to_bdd
    keys = sorted({str(k) for k in leaf_keys(a) + leaf_keys(b)})
    key_idx = {k: i for i, k in enumerate(keys)}
    bdd = BDD(len(keys))
    return bdd.implies(rule_to_bdd(bdd, a, key_idx),
                       rule_to_bdd(bdd, b, key_idx))


# ---------------------------------------------------------------------------
# batch evaluator: decision set -> tensor gate over (B, N) signal batches
# ---------------------------------------------------------------------------

def build_decision_gate(decisions: Sequence[Decision],
                        strategy: str = "priority", fuzzy: bool = False,
                        fuzzy_threshold: float = 0.5,
                        device: DeviceLike = "cuda"):
    """Compile a decision set to ONE batch gate on ``device`` with full
    :class:`DecisionEngine` parity:

        (match (B,N) f32, conf (B,N) f32)
            -> (idx (B,) i32, conf (B,) f32, gates (B,D) f32, scores (B,D) f32)

    ``match``/``conf`` may be tensors, numpy arrays or nested lists
    (``SignalResult.as_vector`` rows in the order of the returned keys);
    they are moved to ``device``.

    * crisp mode gates on the match bits; a decision's score is the mean
      confidence over its satisfied leaf occurrences (Equation 7,
      duplicate leaves counted exactly as ``confidence()`` counts them);
    * fuzzy mode (Definition 6) evaluates the (min, max, 1-x) tree over
      confidences; a decision matches when its score clears
      ``fuzzy_threshold`` and the score is the reported confidence;
    * ``priority`` selection applies a STATIC rank permutation sorted by
      (-priority, declaration order) and takes the first matching
      decision (``torch.argmax`` returns the first maximum);
    * ``confidence`` selection takes the matched decision with the
      highest score, the first declared on a tie.

    ``gates``/``scores`` are returned so the caller can rebuild the full
    ``EngineResult.matched`` list without a second device round trip.
    """
    assert strategy in ("priority", "confidence")
    dev = resolve_device(device)
    keys = sorted({str(k) for d in decisions for k in leaf_keys(d.rule)})
    key_idx = {k: i for i, k in enumerate(keys)}
    D, N = len(decisions), len(keys)

    def node_fn(node, v):
        # min/max/1-x works for both modes: over {0,1} match bits min is
        # conjunction, max is disjunction, 1-x is negation (Equation 6);
        # over confidences it is the fuzzy algebra (Definition 6).
        if node.op == "leaf":
            return v[:, key_idx[str(node.key)]]
        if node.op == "and":
            out = node_fn(node.children[0], v)
            for c in node.children[1:]:
                out = torch.minimum(out, node_fn(c, v))
            return out
        if node.op == "or":
            out = node_fn(node.children[0], v)
            for c in node.children[1:]:
                out = torch.maximum(out, node_fn(c, v))
            return out
        return 1.0 - node_fn(node.children[0], v)

    # leaf occurrence COUNTS (not a 0/1 mask): confidence() iterates
    # leaf_keys() with duplicates, so a key referenced twice weighs twice
    leaf_counts = torch.zeros((D, N), dtype=torch.float32)
    for di, d in enumerate(decisions):
        for k in leaf_keys(d.rule):
            leaf_counts[di, key_idx[str(k)]] += 1.0
    leaf_counts = leaf_counts.to(dev)
    # static selection rank: highest priority first, declaration order
    # breaking ties — argmax over the permuted gates returns the FIRST
    # matching decision in this exact order
    rank = sorted(range(D), key=lambda i: (-decisions[i].priority, i))
    rank_arr = torch.tensor(rank or [0], dtype=torch.long, device=dev)

    def evaluate(match, conf):
        match = torch.as_tensor(match, dtype=torch.float32, device=dev)
        conf = torch.as_tensor(conf, dtype=torch.float32, device=dev)
        B = match.shape[0]
        if D == 0:
            return (torch.full((B,), -1, dtype=torch.int32, device=dev),
                    torch.zeros((B,), device=dev),
                    torch.zeros((B, 0), device=dev),
                    torch.zeros((B, 0), device=dev))
        if fuzzy:
            scores = torch.stack([node_fn(d.rule, conf) for d in decisions],
                                 dim=1)                      # (B,D)
            gates = (scores >= fuzzy_threshold).float()
        else:
            gates = torch.stack([node_fn(d.rule, match) for d in decisions],
                                dim=1)                       # (B,D)
            sat = match[:, None, :] * leaf_counts[None]      # (B,D,N)
            csum = (conf[:, None, :] * sat).sum(-1)
            cnum = torch.clamp(sat.sum(-1), min=1.0)
            scores = csum / cnum                             # (B,D)
        any_match = gates.max(dim=1).values > 0
        if strategy == "priority":
            pos = torch.argmax(gates[:, rank_arr], dim=1)
            idx = rank_arr[pos]
        else:
            idx = torch.argmax(torch.where(gates > 0, scores,
                                           float("-inf")), dim=1)
        idx = torch.where(any_match, idx, -1)
        c = torch.where(any_match,
                        torch.gather(scores, 1,
                                     torch.clamp(idx, min=0)[:, None])[:, 0],
                        0.0)
        return idx.to(torch.int32), c, gates, scores

    return evaluate, keys


def build_batch_evaluator(decisions: Sequence[Decision],
                          device: DeviceLike = "cuda"):
    """The decision set as a function
    (match (B,N) f32, conf (B,N) f32) -> (decision_idx (B,), conf (B,))
    implementing Algorithm 1 with priority strategy — the symbolic-MoE gate
    as a batched op on the device.  Thin wrapper over
    :func:`build_decision_gate` (kept for its two-output signature)."""
    gate, keys = build_decision_gate(decisions, strategy="priority",
                                     device=device)

    def evaluate(match, conf):
        idx, c, _, _ = gate(match, conf)
        return idx, c

    return evaluate, keys
