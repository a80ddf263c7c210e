"""Venn-region cardinality reduction: sets + |·| → linear integer arithmetic.

Reference parity: psync.logic.VennRegions (logic/VennRegions.scala:10-372).
This is the step that makes threshold arguments ("two quorums of size > n/2
intersect") decidable: for each element type, the ground set terms are
covered by groups of ≤ `bound` sets; every group G gets one fresh integer
variable per Venn region (full sign profile over G) with

    * every region ≥ 0,
    * Σ regions = |universe|   (n for ProcessID, CL.scala:84-96),
    * |S| = Σ of S-positive regions, shared across groups via one card var,
    * a fresh *witness* constant per region w with  region ≥ 1 ⇒ profile(w),
    * for every ground element t:  profile(t) ⇒ region ≥ 1.

The witness constants are returned so the reducer can re-instantiate the
remaining universal clauses over them (that closes the loop between
cardinality facts and membership facts — e.g. |A∩B| ≥ 1 ⇒ the instantiated
∀x.¬(x∈A∧x∈B) bites on the witness).

Port of round_tpu/verify/venn.py, copied with only the package name changed.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from round_tpu_torch.verify.formula import (
    And, Application, Binding, Bool, BoolT, CARD, EMPTYSET, FSet, Formula,
    Geq, Implies, IN, Int, INTERSECTION, IntLit, Not, Plus, SETMINUS, Type,
    UNION, Variable, procType,
)
from round_tpu_torch.verify.futils import fmap, free_vars

_counter = itertools.count()

# Universe sizes per element type (CL.sizeOfUniverse, logic/CL.scala:84-96):
# |ProcessID| = n (the symbolic group size), |Bool| = 2, others unbounded.
N_VAR = Variable("n", Int)

_MAX_GROUPS = 400  # explosion guard; beyond this, coverage is partial (sound)


def universe_size(t: Type) -> Optional[Formula]:
    if t == procType:
        return N_VAR
    if isinstance(t, BoolT):
        return IntLit(2)
    return None


def _is_atomic_set(t: Formula) -> bool:
    if not isinstance(t.tpe, FSet):
        return False
    if isinstance(t, Variable):
        return True
    if isinstance(t, Application):
        return t.fct not in (UNION, INTERSECTION, SETMINUS, EMPTYSET)
    return False


def _atomic_support(t: Formula) -> Optional[List[Formula]]:
    """Atomic sets a compound set expression is built from (None if the term
    is not a set-algebra expression over atomics)."""
    if _is_atomic_set(t):
        return [t]
    if isinstance(t, Application) and t.fct in (UNION, INTERSECTION, SETMINUS):
        out: List[Formula] = []
        for a in t.args:
            s = _atomic_support(a)
            if s is None:
                return None
            for x in s:
                if x not in out:
                    out.append(x)
        return out
    if isinstance(t, Application) and t.fct == EMPTYSET:
        return []
    return None


def _profile_satisfies(t: Formula, profile: Dict[Formula, bool]) -> Optional[bool]:
    """Does an element with this membership profile belong to set expr t?"""
    if t in profile:
        return profile[t]
    if isinstance(t, Application):
        if t.fct == UNION:
            vals = [_profile_satisfies(a, profile) for a in t.args]
            return None if any(v is None for v in vals) else any(vals)
        if t.fct == INTERSECTION:
            vals = [_profile_satisfies(a, profile) for a in t.args]
            return None if any(v is None for v in vals) else all(vals)
        if t.fct == SETMINUS:
            a = _profile_satisfies(t.args[0], profile)
            b = _profile_satisfies(t.args[1], profile)
            return None if a is None or b is None else (a and not b)
        if t.fct == EMPTYSET:
            return False
    return None


class VennRegions:
    """Builds the ILP constraints for one element type."""

    def __init__(
        self,
        elem_type: Type,
        sets: Sequence[Formula],
        bound: int,
        elements: Sequence[Formula],
    ):
        self.elem_type = elem_type
        self.sets = list(sets)
        self.bound = max(1, bound)
        self.elements = list(elements)
        self.constraints: List[Formula] = []
        self.witnesses: List[Formula] = []
        self._card_var: Dict[Formula, Variable] = {}
        self._group_regions: Dict[
            Tuple[Formula, ...], Dict[Tuple[bool, ...], Variable]
        ] = {}

    def card_var(self, s: Formula) -> Variable:
        if s not in self._card_var:
            v = Variable(f"card!{next(_counter)}", Int)
            self._card_var[s] = v
            self.constraints.append(Geq(v, 0))
        return self._card_var[s]

    def build(self) -> None:
        """Emit constraints for all ≤bound-sized groups."""
        m = len(self.sets)
        k = min(self.bound, m)
        for size in range(1, k + 1):
            for group in itertools.combinations(range(m), size):
                if len(self._group_regions) >= _MAX_GROUPS:
                    return
                self._ensure_group(tuple(self.sets[i] for i in group))

    def _ensure_group(
        self, group: Tuple[Formula, ...]
    ) -> Dict[Tuple[bool, ...], Variable]:
        # canonicalize: (A,B) and (B,A) must share one region family
        group = tuple(sorted(group, key=repr))
        if group in self._group_regions:
            return self._group_regions[group]
        gid = next(_counter)
        region_vars: Dict[Tuple[bool, ...], Variable] = {}
        for profile in itertools.product((True, False), repeat=len(group)):
            tag = "".join("p" if b else "m" for b in profile)
            v = Variable(f"venn!{gid}!{tag}", Int)
            region_vars[profile] = v
            self.constraints.append(Geq(v, 0))
        self._group_regions[group] = region_vars
        total = universe_size(self.elem_type)
        if total is not None:
            self.constraints.append(Plus(*region_vars.values()).eq(total))
        # |S| consistency: one card var per set, shared across groups
        for idx, s in enumerate(group):
            pos = [v for p, v in region_vars.items() if p[idx]]
            self.constraints.append(Plus(*pos).eq(self.card_var(s)))

        profile_lits = functools.partial(self._profile_lits, group)

        # witnesses: region ≥ 1 ⇒ an element with that profile exists
        for profile, v in region_vars.items():
            tag = "".join("p" if b else "m" for b in profile)
            w = Variable(f"w!{gid}!{tag}", self.elem_type)
            self.constraints.append(
                Implies(Geq(v, 1), And(*profile_lits(w, profile)))
            )
            self.witnesses.append(w)
        # ground elements: profile(t) ⇒ region ≥ 1
        for t in self.elements:
            for profile, v in region_vars.items():
                self.constraints.append(
                    Implies(And(*profile_lits(t, profile)), Geq(v, 1))
                )
        return region_vars

    def _profile_lits(
        self, group: Tuple[Formula, ...], x: Formula, profile: Tuple[bool, ...]
    ) -> List[Formula]:
        lits = []
        for idx, s in enumerate(group):
            member = Application(IN, [x, s])
            member.tpe = Bool
            lits.append(member if profile[idx] else Not(member))
        return lits

    def add_elements(self, new_elements: Sequence[Formula]) -> None:
        """Register ground elements discovered after build() (e.g. region
        witnesses, round-2 skolems): emit profile(t) ⇒ region ≥ 1 for every
        existing group.  This closes the membership→cardinality direction for
        witnesses — without it, a witness shown (via set definitions) to be a
        member of some other carded set never forces that set's |·| ≥ 1.
        Capped for soundness-preserving economy (omitting constraints only
        weakens the hypothesis side)."""
        fresh = [
            e for e in new_elements
            if e.tpe == self.elem_type and e not in self.elements
        ]
        if not fresh:
            return
        self.elements.extend(fresh)
        budget = 20_000
        for group, region_vars in self._group_regions.items():
            for t in fresh:
                for profile, v in region_vars.items():
                    if budget <= 0:
                        return
                    budget -= 1
                    self.constraints.append(
                        Implies(
                            And(*self._profile_lits(group, t, profile)),
                            Geq(v, 1),
                        )
                    )

    def card_of(self, expr: Formula) -> Optional[Formula]:
        """An Int term equal to |expr| (atomic or compound set expr)."""
        if _is_atomic_set(expr):
            return self.card_var(expr)
        support = _atomic_support(expr)
        if support is None:
            return None
        if not support:  # |∅|
            return IntLit(0)
        # explosion guard (build() enforces self.bound/_MAX_GROUPS; this lazy
        # path must too): leaving the Card uninterpreted is sound — the
        # reducer merely loses the cardinality fact and fails to prove.
        if len(support) > 12 or len(self._group_regions) >= _MAX_GROUPS:
            return None
        # profiles are positional over the *canonical* (repr-sorted) group
        # _ensure_group builds, so zip that same ordering — zipping the raw
        # encounter-ordered support attaches membership bits to wrong sets
        group = tuple(sorted(support, key=repr))
        region_vars = self._ensure_group(group)
        terms = []
        for profile, v in region_vars.items():
            pmap = dict(zip(group, profile))
            if _profile_satisfies(expr, pmap):
                terms.append(v)
        if not terms:
            return IntLit(0)
        return Plus(*terms)


def carded_supports(conjuncts: Sequence[Formula]) -> List[Formula]:
    """Atomic set terms appearing (possibly inside set algebra) under a Card
    — the sets whose region variables can actually influence arithmetic.
    Building regions only over these keeps the free-atom count of the ground
    query proportional to the cardinality reasoning the VC needs, instead of
    quadratic in every set term mentioned anywhere (which made VC-sized
    queries enumerate thousands of irrelevant Venn models)."""
    out: List[Formula] = []

    def walk(g: Formula):
        if isinstance(g, Application):
            if g.fct == CARD:
                sup = _atomic_support(g.args[0])
                for s in sup or []:
                    if s not in out:
                        out.append(s)
            for a in g.args:
                walk(a)

    for c in conjuncts:
        walk(c)
    return out


def build_regions(
    conjuncts: Sequence[Formula],
    elements_by_type: Dict[Type, List[Formula]],
    bound: int = 2,
    only: Optional[Sequence[Formula]] = None,
) -> Dict[Type, VennRegions]:
    """Collect the atomic set terms per element type from `conjuncts` and
    build one VennRegions per type.  The instances are persistent: later
    `rewrite_cards` calls share their card/region variables, which is what
    keeps |S| consistent across reduction rounds.  With `only`, region
    groups are restricted to those atomic sets (see carded_supports)."""
    sets_by_type: Dict[Type, List[Formula]] = {}

    def note_set(t: Formula):
        # free variables are constants at this stage; set terms inside
        # quantified bodies (bound-var-dependent) are never reached because
        # walk does not descend into Binding nodes
        if _is_atomic_set(t):
            if only is not None and t not in only:
                return
            lst = sets_by_type.setdefault(t.tpe.elem, [])
            if t not in lst:
                lst.append(t)

    def walk(g: Formula):
        if isinstance(g, Application):
            note_set(g)
            for a in g.args:
                walk(a)
        elif isinstance(g, Variable):
            note_set(g)

    for c in conjuncts:
        walk(c)

    regions: Dict[Type, VennRegions] = {}
    for t, sets in sets_by_type.items():
        vr = VennRegions(t, sets, bound, elements_by_type.get(t, []))
        vr.build()
        regions[t] = vr
    return regions


def rewrite_cards(
    regions: Dict[Type, VennRegions], conjuncts: Sequence[Formula]
) -> List[Formula]:
    """Replace Card(...) terms with their ILP variables / region sums."""

    def rewrite_card(g: Formula) -> Formula:
        if isinstance(g, Application) and g.fct == CARD:
            expr = g.args[0]
            et = expr.tpe.elem if isinstance(expr.tpe, FSet) else None
            vr = regions.get(et)
            if vr is not None:
                r = vr.card_of(expr)
                if r is not None:
                    return r
        return g

    return [fmap(rewrite_card, c) for c in conjuncts]


def collect(
    regions: Dict[Type, VennRegions],
) -> Tuple[List[Formula], List[Formula]]:
    """(constraints, witnesses) accumulated so far — call after the last
    rewrite_cards pass (card_of may add groups lazily)."""
    constraints: List[Formula] = []
    witnesses: List[Formula] = []
    for vr in regions.values():
        constraints.extend(vr.constraints)
        witnesses.extend(vr.witnesses)
    return constraints, witnesses


def reduce_cardinalities(
    conjuncts: Sequence[Formula],
    elements_by_type: Dict[Type, List[Formula]],
    bound: int = 2,
) -> Tuple[List[Formula], List[Formula], List[Formula]]:
    """One-shot convenience wrapper: build → rewrite → collect."""
    regions = build_regions(conjuncts, elements_by_type, bound)
    out = rewrite_cards(regions, conjuncts)
    constraints, witnesses = collect(regions)
    return out, constraints, witnesses
