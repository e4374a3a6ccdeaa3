"""Reduced Ordered Binary Decision Diagrams (ROBDDs), hash-consed.
A copy of ``repro.analysis.bdd``.

The paper's Boolean-algebraic regime (§5) treats routing policies as
composable Boolean programs; this module gives them a canonical form.
Every rule tree over N signal variables compiles to a node in one shared
``BDD`` manager, where equivalent functions are the SAME node — so
satisfiability, implication (subsumption), overlap and model counting
are table lookups and memoized ``ite`` recursions instead of the old
``2^N`` truth-table enumerations in ``core/decision.py`` (which were
capped at 14-16 variables and raised beyond that).

Representation: nodes are integers.  ``0``/``1`` are the terminals; an
internal node ``u`` is ``(var, lo, hi)`` with ``var`` strictly
increasing toward the leaves (the fixed variable order is whatever the
caller's ``key -> index`` map says; callers here sort signal keys, the
same order ``build_decision_gate`` freezes).  The unique table
hash-conses ``mk`` and the ``ite`` memo makes every operator
polynomial in the DAG sizes.

No repro imports: ``rule_to_bdd`` duck-types on the ``RuleNode``
shape (``op``/``key``/``children``) so ``core.decision`` can call into
this module lazily without an import cycle.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["BDD", "rule_to_bdd", "at_most_one"]


class BDD:
    """One shared ROBDD manager over ``n_vars`` Boolean variables."""

    FALSE = 0
    TRUE = 1

    def __init__(self, n_vars: int):
        self.n = n_vars
        # id -> (var, lo, hi); terminals sit at the virtual level n so the
        # var field of any node is also its depth in the fixed order
        self._nodes: List[Tuple[int, int, int]] = [(n_vars, 0, 0),
                                                   (n_vars, 1, 1)]
        self._unique: Dict[Tuple[int, int, int], int] = {}
        self._ite_memo: Dict[Tuple[int, int, int], int] = {}
        # specialized binary-apply memos (commutative ops canonicalize the
        # key to f<g, doubling the hit rate vs a generic ite triple)
        self._and_memo: Dict[Tuple[int, int], int] = {}
        self._or_memo: Dict[Tuple[int, int], int] = {}
        self._not_memo: Dict[int, int] = {}
        self._count_memo: Dict[int, int] = {}

    # -- structure -----------------------------------------------------
    def var_of(self, u: int) -> int:
        return self._nodes[u][0]

    def lo(self, u: int) -> int:
        return self._nodes[u][1]

    def hi(self, u: int) -> int:
        return self._nodes[u][2]

    def mk(self, var: int, lo: int, hi: int) -> int:
        if lo == hi:
            return lo
        key = (var, lo, hi)
        u = self._unique.get(key)
        if u is None:
            u = len(self._nodes)
            self._nodes.append(key)
            self._unique[key] = u
        return u

    def var(self, i: int) -> int:
        assert 0 <= i < self.n, (i, self.n)
        return self.mk(i, self.FALSE, self.TRUE)

    def __len__(self) -> int:
        return len(self._nodes)

    # -- operators (all via memoized if-then-else) ---------------------
    def _cofactors(self, u: int, v: int) -> Tuple[int, int]:
        if self.var_of(u) == v:
            return self.lo(u), self.hi(u)
        return u, u

    def ite(self, f: int, g: int, h: int) -> int:
        if f == self.TRUE:
            return g
        if f == self.FALSE:
            return h
        if g == h:
            return g
        if g == self.TRUE and h == self.FALSE:
            return f
        key = (f, g, h)
        r = self._ite_memo.get(key)
        if r is not None:
            return r
        v = min(self.var_of(f), self.var_of(g), self.var_of(h))
        f0, f1 = self._cofactors(f, v)
        g0, g1 = self._cofactors(g, v)
        h0, h1 = self._cofactors(h, v)
        r = self.mk(v, self.ite(f0, g0, h0), self.ite(f1, g1, h1))
        self._ite_memo[key] = r
        return r

    # Specialized hot-path operators.  Semantically identical to the ite
    # forms (not = ite(f,0,1), and = ite(f,g,0), or = ite(f,1,g)) but
    # with inline node unpacking and per-op memo tables — the verifier
    # spends its whole budget here on wide policies, and the generic ite
    # triple costs ~3x in Python-call overhead.
    def not_(self, f: int) -> int:
        if f <= 1:
            return 1 - f
        memo = self._not_memo
        r = memo.get(f)
        if r is None:
            v, lo, hi = self._nodes[f]
            r = self.mk(v, self.not_(lo), self.not_(hi))
            memo[f] = r
            memo[r] = f
        return r

    def and_(self, f: int, g: int) -> int:
        if f == g or g == 1:
            return f
        if f == 1:
            return g
        if f == 0 or g == 0:
            return 0
        if f > g:
            f, g = g, f
        memo = self._and_memo
        key = (f, g)
        r = memo.get(key)
        if r is None:
            vf, lof, hif = self._nodes[f]
            vg, log, hig = self._nodes[g]
            if vf == vg:
                r = self.mk(vf, self.and_(lof, log), self.and_(hif, hig))
            elif vf < vg:
                r = self.mk(vf, self.and_(lof, g), self.and_(hif, g))
            else:
                r = self.mk(vg, self.and_(f, log), self.and_(f, hig))
            memo[key] = r
        return r

    def or_(self, f: int, g: int) -> int:
        if f == g or g == 0:
            return f
        if f == 0:
            return g
        if f == 1 or g == 1:
            return 1
        if f > g:
            f, g = g, f
        memo = self._or_memo
        key = (f, g)
        r = memo.get(key)
        if r is None:
            vf, lof, hif = self._nodes[f]
            vg, log, hig = self._nodes[g]
            if vf == vg:
                r = self.mk(vf, self.or_(lof, log), self.or_(hif, hig))
            elif vf < vg:
                r = self.mk(vf, self.or_(lof, g), self.or_(hif, g))
            else:
                r = self.mk(vg, self.or_(f, log), self.or_(f, hig))
            memo[key] = r
        return r

    def xor_(self, f: int, g: int) -> int:
        return self.ite(f, self.not_(g), g)

    def conj(self, fs: Sequence[int]) -> int:
        out = self.TRUE
        for f in fs:
            out = self.and_(out, f)
        return out

    def disj(self, fs: Sequence[int]) -> int:
        out = self.FALSE
        for f in fs:
            out = self.or_(out, f)
        return out

    # -- queries -------------------------------------------------------
    def implies(self, f: int, g: int) -> bool:
        """f => g for every assignment (containment / subsumption)."""
        return self.and_(f, self.not_(g)) == self.FALSE

    def equiv(self, f: int, g: int) -> bool:
        return f == g                       # canonical form: same node

    def sat_count(self, u: int) -> int:
        """Number of satisfying assignments over the FULL n-var space."""
        def walk(u: int) -> int:
            # assignments over variables var_of(u)..n-1
            if u == self.FALSE:
                return 0
            if u == self.TRUE:
                return 1
            r = self._count_memo.get(u)
            if r is None:
                v = self.var_of(u)
                lo, hi = self.lo(u), self.hi(u)
                r = (walk(lo) << (self.var_of(lo) - v - 1)) + \
                    (walk(hi) << (self.var_of(hi) - v - 1))
                self._count_memo[u] = r
            return r
        return walk(u) << self.var_of(u) if u > 1 else \
            (1 << self.n if u == self.TRUE else 0)

    def any_sat(self, u: int) -> Optional[Dict[int, bool]]:
        """One satisfying PARTIAL assignment (vars not mentioned are free;
        setting them False keeps the assignment satisfying along the
        chosen path).  None when ``u`` is unsatisfiable."""
        if u == self.FALSE:
            return None
        out: Dict[int, bool] = {}
        while u != self.TRUE:
            v = self.var_of(u)
            if self.lo(u) != self.FALSE:
                out[v] = False
                u = self.lo(u)
            else:
                out[v] = True
                u = self.hi(u)
        return out

    def sat_iter(self, u: int, limit: int = 16
                 ) -> Iterator[Dict[int, bool]]:
        """Up to ``limit`` distinct satisfying partial assignments (one
        per TRUE-path; don't-care variables omitted)."""
        if u == self.FALSE:
            return
        stack: List[Tuple[int, Dict[int, bool]]] = [(u, {})]
        emitted = 0
        while stack and emitted < limit:
            node, assign = stack.pop()
            if node == self.TRUE:
                yield assign
                emitted += 1
                continue
            if node == self.FALSE:
                continue
            v = self.var_of(node)
            stack.append((self.hi(node), {**assign, v: True}))
            stack.append((self.lo(node), {**assign, v: False}))


def rule_to_bdd(bdd: BDD, rule, key_idx: Dict[str, int]) -> int:
    """Compile a ``RuleNode`` tree (duck-typed: ``op``/``key``/
    ``children``) to a BDD node.  Leaves whose key is absent from
    ``key_idx`` fold to constant FALSE — that is their exact runtime
    semantics (``SignalResult.matched`` of an unevaluated signal is
    False; ``NOT`` of one is True via ``not_``)."""
    if rule.op == "leaf":
        i = key_idx.get(str(rule.key))
        return bdd.FALSE if i is None else bdd.var(i)
    if rule.op == "and":
        return bdd.conj([rule_to_bdd(bdd, c, key_idx)
                         for c in rule.children])
    if rule.op == "or":
        return bdd.disj([rule_to_bdd(bdd, c, key_idx)
                         for c in rule.children])
    return bdd.not_(rule_to_bdd(bdd, rule.children[0], key_idx))


def at_most_one(bdd: BDD, vars_: Sequence[int]) -> int:
    """Constraint: at most one of ``vars_`` is true — the domain shape of
    one-hot classifier heads (a single predicted label can satisfy at
    most one of a set of label-disjoint signals).  Linear construction:
    walk the variables in order, branching on "seen one already"."""
    vs = sorted(set(vars_))
    # build bottom-up: suffix constraint with 0 or 1 trues already seen
    none_seen, one_seen = bdd.TRUE, bdd.TRUE
    for v in reversed(vs):
        # one seen: any further true violates
        new_one = bdd.mk(v, one_seen, bdd.FALSE)
        # none seen: a true here moves to the one-seen suffix
        new_none = bdd.mk(v, none_seen, one_seen)
        none_seen, one_seen = new_none, new_one
    return none_seen
