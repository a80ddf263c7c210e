"""E-matching quantifier instantiation (reference: logic/Matching.scala:12-146
and the trigger discipline of quantifiers/IncrementalGenerator.scala:15-60).

The eager strategy (quantifiers.instantiate) substitutes every type-correct
combination of known ground terms — complete for the bounded fragments CL
targets, but exponential in the number of bound variables.  E-matching
instead mines each ∀-clause for *triggers* (minimal uninterpreted
applications mentioning bound variables) and only instantiates with
substitutions under which some trigger instance is congruent to a term the
solver has already seen — the ψ-local-extension discipline: new instances
are grounded in the existing term universe.

Soundness: every instance produced is a substitution instance of a ∀-clause,
so UNSAT results remain sound regardless of trigger choice.  Completeness is
traded exactly as the reference trades it (Matching.scala generates
candidate terms from patterns; clauses whose variables escape every trigger
fall back to type-based candidates).

Usage mirrors quantifiers.instantiate; ClConfig(strategy="ematch") routes
CL reduction through this module.

Port of round_tpu/verify/matching.py, copied with only the package name changed.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from round_tpu_torch.verify.congruence import CongruenceClosure
from round_tpu_torch.verify.formula import (
    Application, Binding, Formula, Literal, UnInterpretedFct, Variable,
)
from round_tpu_torch.verify.futils import free_vars, subst_vars
from round_tpu_torch.verify.quantifiers import ground_terms_by_type


# ---------------------------------------------------------------------------
# Triggers
# ---------------------------------------------------------------------------

def collect_triggers(clause: Binding) -> List[Application]:
    """Candidate trigger patterns of a ∀-clause: the minimal uninterpreted
    applications in its body that mention at least one bound variable.

    "Minimal" = no subterm AT ANY DEPTH is itself a candidate (f(g(i))
    yields g(i), not the enclosing term; g(x(i)+1) yields x(i)) — smaller
    patterns match more ground terms, and the enclosing structure is
    recovered by congruence after instantiation.  Matching.scala's term
    generators walk the same pattern skeletons."""
    bound = set(clause.vars)
    out: List[Application] = []
    seen: Set[Formula] = set()

    def has_bound(t: Formula) -> bool:
        return bool(free_vars(t) & bound)

    def walk(t: Formula) -> bool:
        """Mine t; returns True if t or any subterm IS a candidate (seen or
        new — dedup must not leak the enclosing term past minimality)."""
        if isinstance(t, Binding):
            # nested binders: their own vars are not ours; still mine the
            # body for patterns over OUR bound vars
            return walk(t.body)
        if not isinstance(t, Application):
            return False
        sub_has = False
        for a in t.args:
            sub_has |= walk(a)
        if (
            isinstance(t.fct, UnInterpretedFct)
            and has_bound(t)
            and not sub_has  # deep minimality
        ):
            if t not in seen:
                seen.add(t)
                out.append(t)
            return True
        return sub_has

    walk(clause.body)
    return out


def matchable_vars(pattern: Formula, bound: Set[Variable]) -> Set[Variable]:
    """Bound variables in MATCHABLE positions of a trigger: positions the
    matcher can actually bind — a bound-var argument, or a position inside
    a nested uninterpreted application.  Variables appearing only under
    interpreted functions (e.g. the i of f(i+1)) are not bindable by this
    pattern and must come from another trigger or the type fallback."""
    if isinstance(pattern, Variable):
        return {pattern} if pattern in bound else set()
    if isinstance(pattern, Application) \
            and isinstance(pattern.fct, UnInterpretedFct):
        out: Set[Variable] = set()
        for a in pattern.args:
            out |= matchable_vars(a, bound)
        return out
    return set()


def select_trigger_set(clause: Binding) -> Tuple[List[Application], List[Variable]]:
    """Greedy multi-pattern selection: pick triggers until every bound
    variable is covered (or no trigger adds coverage).  Coverage counts
    only matchable positions (matchable_vars).  Returns the chosen patterns
    and the UNcovered variables (instantiated by type fallback)."""
    cands = collect_triggers(clause)
    bound = set(clause.vars)
    covered: Set[Variable] = set()
    chosen: List[Application] = []
    # prefer patterns covering more variables, then smaller terms
    for p in sorted(
        cands,
        key=lambda p: (-len(matchable_vars(p, bound)), repr(p)),
    ):
        gain = matchable_vars(p, bound) - covered
        if gain:
            chosen.append(p)
            covered |= gain
        if covered >= bound:
            break
    return chosen, [v for v in clause.vars if v not in covered]


def trigger_alternatives(
    clause: Binding,
) -> List[Tuple[List[Application], List[Variable]]]:
    """The clause's usable trigger SETS, each an independent alternative
    (multi-pattern semantics: a clause fires when ANY of its pattern sets
    matches).  Every single trigger covering all bound variables is its own
    alternative — ∀i. sndts(i) = ts(i) must fire from a ground ts(kw) even
    when no ground sndts exists — with the greedy covering set as the
    fallback when no single trigger covers everything."""
    bound = set(clause.vars)
    singles = [
        p for p in collect_triggers(clause)
        if matchable_vars(p, bound) >= bound
    ]
    if singles:
        return [([p], []) for p in singles]
    return [select_trigger_set(clause)]


# ---------------------------------------------------------------------------
# Matching modulo congruence
# ---------------------------------------------------------------------------

class _Index:
    """Ground applications of the current term universe, by head symbol."""

    def __init__(self, cc: CongruenceClosure):
        self.cc = cc
        self.by_head: Dict[object, List[Application]] = {}
        self._seen: Set[Formula] = set()

    def add_from(self, fs: Iterable[Formula]) -> None:
        def walk(t: Formula, under_binder: frozenset):
            if isinstance(t, Binding):
                walk(t.body, under_binder | set(t.vars))
                return
            if not isinstance(t, Application):
                return
            for a in t.args:
                walk(a, under_binder)
            if free_vars(t) & under_binder:
                return  # not ground (mentions a quantified var)
            if t in self._seen:
                return
            self._seen.add(t)
            if isinstance(t.fct, UnInterpretedFct):
                self.by_head.setdefault(t.fct, []).append(t)
                self.cc.add_term(t)

        for f in fs:
            walk(f, frozenset())


def _match(
    pattern: Formula,
    term: Formula,
    bound: Set[Variable],
    sub: Dict[Variable, Formula],
    index: _Index,
) -> List[Dict[Variable, Formula]]:
    """All extensions of `sub` under which pattern σ ≡ term (modulo the
    congruence closure).  The E in e-matching: an application subpattern may
    match any indexed application congruent to the corresponding subterm."""
    cc = index.cc
    if isinstance(pattern, Variable) and pattern in bound:
        prev = sub.get(pattern)
        if prev is not None:
            return [sub] if cc.congruent(prev, term) else []
        out = dict(sub)
        out[pattern] = term
        return [out]
    if not (free_vars(pattern) & bound):
        return [sub] if cc.congruent(pattern, term) else []
    if isinstance(pattern, Application):
        if not isinstance(pattern.fct, UnInterpretedFct):
            # interpreted subpattern over bound vars (e.g. Plus(i, 1)):
            # unmatchable structurally — but when every bound var in it is
            # already bound, substitute and fall back to a congruence check
            pvars = free_vars(pattern) & bound
            if pvars <= set(sub):
                inst = subst_vars(pattern, {v: sub[v] for v in pvars})
                return [sub] if cc.congruent(inst, term) else []
            return []
        results: List[Dict[Variable, Formula]] = []
        for cand in index.by_head.get(pattern.fct, []):
            if len(cand.args) != len(pattern.args):
                continue
            if not cc.congruent(cand, term):
                continue
            subs = [sub]
            # bindable positions first, so an interpreted arg like i+1 can
            # use bindings produced by a sibling var/application arg
            pairs = sorted(
                zip(pattern.args, cand.args),
                key=lambda pt: 0 if matchable_vars(pt[0], bound) else 1,
            )
            for p_arg, t_arg in pairs:
                subs = [
                    s2 for s in subs
                    for s2 in _match(p_arg, t_arg, bound, s, index)
                ]
                if not subs:
                    break
            results.extend(subs)
        return results
    return []


def _match_toplevel(
    pattern: Application,
    bound: Set[Variable],
    sub: Dict[Variable, Formula],
    index: _Index,
) -> List[Dict[Variable, Formula]]:
    """Match a trigger against every indexed term with the same head."""
    out: List[Dict[Variable, Formula]] = []
    for cand in index.by_head.get(pattern.fct, []):
        out.extend(_match(pattern, cand, bound, sub, index))
    return out


# ---------------------------------------------------------------------------
# Instantiation driver
# ---------------------------------------------------------------------------

def instantiate_matching(
    universals: Sequence[Binding],
    ground: Sequence[Formula],
    depth: int = 1,
    max_insts: int = 50_000,
    logger=None,
    logger_base_round: int = 0,
) -> List[Formula]:
    """E-matching counterpart of quantifiers.instantiate: same signature,
    same dedup-modulo-congruence, but substitutions come from trigger
    matches instead of the full type-correct product.  Variables no trigger
    covers fall back to type-based candidates (keeping the strategy no less
    complete than Eager on trigger-free clauses)."""
    cc = CongruenceClosure()
    for g in ground:
        cc.add_constraints(g)
    index = _Index(cc)
    index.add_from(ground)
    # universal bodies contribute their bound-var-free subterms to the
    # universe, exactly like the eager strategy's candidate mining
    index.add_from(universals)

    produced: List[Formula] = []
    seen_inst: Set = set()
    roots: dict = {}
    if logger is not None:
        for u in universals:
            roots[id(u)] = logger.add_node(
                u, round=logger_base_round, is_root=True
            )

    plans = [
        (u, patterns, uncovered)
        for u in universals
        for patterns, uncovered in trigger_alternatives(u)
    ]
    pool: List[Formula] = list(ground) + list(universals)

    for _round in range(depth):
        new: List[Formula] = []
        fallback_terms = None  # computed lazily, only if some var needs it
        for u, patterns, uncovered in plans:
            bound = set(u.vars)
            subs: List[Dict[Variable, Formula]] = [{}]
            for p in patterns:
                subs = [
                    s2 for s in subs
                    for s2 in _match_toplevel(p, bound, s, index)
                ]
                if not subs:
                    break
            if not subs:
                continue
            if uncovered:
                if fallback_terms is None:
                    fallback_terms = ground_terms_by_type(pool, cc)
                cands = []
                for v in uncovered:
                    ts = [t for tt, lst in fallback_terms.items()
                          if tt == v.tpe for t in lst]
                    cands.append(ts)
                if any(not c for c in cands):
                    continue
                subs = [
                    {**s, **dict(zip(uncovered, combo))}
                    for s in subs
                    for combo in itertools.product(*cands)
                ]
            for s in subs:
                if len(s) != len(u.vars):
                    continue
                key = (
                    id(u),
                    tuple(cc.repr_of(s[v]) for v in u.vars),
                )
                if key in seen_inst:
                    continue
                seen_inst.add(key)
                inst = subst_vars(u.body, s)
                new.append(inst)
                if logger is not None:
                    combo = tuple(s[v] for v in u.vars)
                    dst = logger.add_node(
                        inst, new_ground_terms=combo,
                        round=logger_base_round + _round + 1,
                    )
                    logger.add_edge(roots[id(u)], dst, combo)
                if len(seen_inst) > max_insts:
                    break
            if len(seen_inst) > max_insts:
                break
        produced.extend(new)
        if not new or len(seen_inst) > max_insts:
            break
        for f in new:
            cc.add_constraints(f)
        index.add_from(new)
        pool = pool + new
    return produced
