"""Skolemization, comprehension symbolization, quantifier instantiation.

Reference parity: psync.logic.quantifiers (logic/quantifiers/*.scala):
  * getExistentialPrefix / skolemize (package.scala:132,150)
  * symbolizeComprehension (package.scala:195) + SetDef (SetDef.scala:11-123)
  * IncrementalGenerator.saturate — here `instantiate`, an eager bounded
    generator in the style of QStrategy(Eager(depth)) (Tactic.scala:96):
    each round instantiates every ∀-clause over all known ground terms of the
    bound variable's type (dedup modulo congruence), and terms created by one
    round feed the next.
  * TypeStratification (TypeStratification.scala:8-55) — decides for which
    types it is *safe for completeness* to drop the remaining universals
    after bounded instantiation (ψ-local theory extensions).  Dropping is
    always sound for UNSAT verdicts; stratification is advisory metadata.

Port of round_tpu/verify/quantifiers.py, copied with only the package name changed.
"""

from __future__ import annotations

import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from round_tpu_torch.verify.congruence import CongruenceClosure
from round_tpu_torch.verify.formula import (
    Application, Binding, Bool, BoolT, CARD, COMPREHENSION, DIVIDES, EXISTS,
    FORALL, Formula, FunT, IN, Literal, MINUS, PLUS, TIMES, Type, UMINUS,
    UnInterpretedFct, Variable, And, ForAll, Implies,
)

_NON_MODEL_FCTS = (CARD, PLUS, MINUS, UMINUS, TIMES, DIVIDES)
from round_tpu_torch.verify.futils import (
    alpha_all, alpha_normalize, free_vars, get_conjuncts, subst_vars,
)

_fresh_counter = itertools.count()


def _fresh_name(prefix: str) -> str:
    return f"{prefix}!{next(_fresh_counter)}"


# ---------------------------------------------------------------------------
# Existential prefix + skolemization (NNF input)
# ---------------------------------------------------------------------------

def get_existential_prefix(f: Formula) -> Tuple[Formula, List[Variable]]:
    """Strip a leading ∃ prefix, replacing the bound vars by fresh constants
    (quantifiers/package.scala:132)."""
    out_vars: List[Variable] = []
    while isinstance(f, Binding) and f.binder == EXISTS:
        sub = {}
        for v in f.vars:
            c = Variable(_fresh_name(v.name), v.tpe)
            sub[v] = c
            out_vars.append(c)
        f = subst_vars(f.body, sub)
    return f, out_vars


def skolemize(f: Formula) -> Formula:
    """Replace ∃ under ∀ with skolem functions of the enclosing ∀ vars.
    Input must be in NNF (quantifiers/package.scala:150)."""

    def go(g: Formula, universals: Tuple[Variable, ...]) -> Formula:
        if isinstance(g, Binding):
            if g.binder == FORALL:
                body = go(g.body, universals + g.vars)
                h = Binding(FORALL, g.vars, body)
                h.tpe = g.tpe
                return h
            if g.binder == EXISTS:
                sub: Dict[Variable, Formula] = {}
                for v in g.vars:
                    if universals:
                        fn = UnInterpretedFct(
                            _fresh_name(f"sk_{v.name}"),
                            FunT([u.tpe for u in universals], v.tpe),
                        )
                        t = Application(fn, list(universals))
                        t.tpe = v.tpe
                    else:
                        t = Variable(_fresh_name(v.name), v.tpe)
                    sub[v] = t
                return go(subst_vars(g.body, sub), universals)
            return g  # comprehension: handled by symbolization
        if isinstance(g, Application):
            h = Application(g.fct, [go(a, universals) for a in g.args])
            h.tpe = g.tpe
            return h
        return g

    return go(alpha_all(f), ())


# ---------------------------------------------------------------------------
# Comprehension symbolization (SetDef)
# ---------------------------------------------------------------------------

class SetDef:
    """A symbolized comprehension: fresh set symbol + membership definition
    (SetDef.scala:11-123).  scope = enclosing bound vars captured by the
    body (making the set a function of them)."""

    def __init__(self, sym: Formula, comp: Binding, definition: Formula):
        self.sym = sym
        self.comp = comp
        self.definition = definition

    def __repr__(self):
        return f"SetDef({self.sym!r} := {self.comp!r})"


def _comprehension_template(comp: Binding) -> Tuple[Formula, List[Formula]]:
    """Abstract the maximal element-free subterms of a comprehension body
    into parameter variables, in first-occurrence order.

    {k | k ∈ HO(j) ∧ x(k) = w}  and  {k | k ∈ HO(j0) ∧ x(k) = v}  both
    yield the template {k | k ∈ tp!0 ∧ x(k) = tp!1} with parameter lists
    [HO(j), w] and [HO(j0), v] — the α-normalized template is the KEY under
    which both occurrences share one set-valued function symbol, so their
    card terms become congruent applications instead of unrelated
    constants.  This is the set-extensionality transport the LV/OTR
    inductiveness VCs need: without it, a ground comprehension and the ∀-
    quantified comprehension it instantiates get distinct symbols and the
    solver cannot connect their cardinalities."""
    params: List[Formula] = []
    pvars: List[Variable] = []

    def abstract(t: Formula, blocked: frozenset) -> Formula:
        # a subterm is a parameter only if it mentions NO blocked variable
        # — the element vars AND any variable bound by a binder we have
        # recursed into (otherwise an inner-bound variable would leak free
        # into the shared symbol's arguments and definition axiom)
        if not (free_vars(t) & blocked):
            for idx, seen in enumerate(params):
                if seen == t:
                    return pvars[idx]
            pv = Variable(f"tp!{len(params)}", t.tpe)
            params.append(t)
            pvars.append(pv)
            return pv
        if isinstance(t, Application):
            h = Application(t.fct, [abstract(a, blocked) for a in t.args])
            h.tpe = t.tpe
            return h
        if isinstance(t, Binding):
            h = Binding(t.binder, t.vars,
                        abstract(t.body, blocked | frozenset(t.vars)))
            h.tpe = t.tpe
            return h
        return t  # an element or inner-bound variable

    body_t = abstract(comp.body, frozenset(comp.vars))
    tcomp = Binding(COMPREHENSION, comp.vars, body_t)
    tcomp.tpe = comp.tpe
    return alpha_normalize(tcomp), params


def symbolize_comprehensions(f: Formula) -> Tuple[Formula, List[SetDef]]:
    """Replace every comprehension {x | body} with a set symbol S plus the
    definition axiom ∀x. x ∈ S ⇔ body (quantifiers/package.scala:195).

    Symbols are keyed by the comprehension's α-normalized TEMPLATE (body
    with its element-free subterms abstracted, _comprehension_template):
    occurrences that are instances of the same template share one
    set-valued function symbol applied to their actual parameter terms, so
    instantiating a ∀-quantified comprehension produces the SAME card term
    as a ground occurrence of that instance (comprehension-card congruence
    across witnesses).  Parameter-free comprehensions stay constants."""
    defs: List[SetDef] = []
    cache: Dict[Formula, Formula] = {}
    templates: Dict[Formula, object] = {}

    def go(g: Formula, bound: Tuple[Variable, ...]) -> Formula:
        if isinstance(g, Binding):
            if g.binder == COMPREHENSION:
                body = go(g.body, bound + g.vars)
                comp = Binding(COMPREHENSION, g.vars, body)
                comp.tpe = g.tpe
                norm = alpha_normalize(comp)
                if norm in cache:
                    return cache[norm]
                key, params = _comprehension_template(comp)
                captured = sorted(
                    (v for v in free_vars(comp) if v in set(bound)),
                    key=lambda v: v.name,
                )
                elem_vars = list(comp.vars)
                if params:
                    fn = templates.get(key)
                    if fn is None:
                        fn = UnInterpretedFct(
                            _fresh_name("S"),
                            FunT([p.tpe for p in params], comp.tpe),
                        )
                        templates[key] = fn
                    sym: Formula = Application(fn, params)
                    sym.tpe = comp.tpe
                else:
                    sym0 = templates.get(key)
                    if sym0 is None:
                        sym0 = Variable(_fresh_name("S"), comp.tpe)
                        templates[key] = sym0
                    sym = sym0
                x = elem_vars[0] if len(elem_vars) == 1 else None
                if x is not None:
                    member = Application(IN, [x, sym])
                    member.tpe = Bool
                    definition = ForAll(
                        list(captured) + [x],
                        And(
                            Implies(member, comp.body),
                            Implies(comp.body, member),
                        ),
                    )
                else:
                    definition = None  # tuple comprehension: no membership axiom
                defs.append(SetDef(sym, comp, definition))
                cache[norm] = sym
                return sym
            body = go(g.body, bound + g.vars)
            h = Binding(g.binder, g.vars, body)
            h.tpe = g.tpe
            return h
        if isinstance(g, Application):
            h = Application(g.fct, [go(a, bound) for a in g.args])
            h.tpe = g.tpe
            return h
        return g

    return go(f, ()), defs


# ---------------------------------------------------------------------------
# Eager bounded instantiation
# ---------------------------------------------------------------------------

def _clause_split(f: Formula) -> Tuple[List[Formula], List[Binding]]:
    """Split a conjunction into (ground conjuncts, ∀-clauses).  Nested
    ∀∀ chains are collapsed and ∀ over ∧ is distributed into separate
    clauses (smaller clauses instantiate more selectively)."""
    ground: List[Formula] = []
    univ: List[Binding] = []

    def push(c: Formula):
        if isinstance(c, Binding) and c.binder == FORALL:
            vars_, body = list(c.vars), c.body
            while isinstance(body, Binding) and body.binder == FORALL:
                vars_ += list(body.vars)
                body = body.body
            for part in get_conjuncts(body):
                used = free_vars(part)
                kept = [v for v in vars_ if v in used]
                if kept:
                    b = Binding(FORALL, kept, part)
                    b.tpe = c.tpe
                    if isinstance(part, Binding) and part.binder == FORALL:
                        push(b)
                    else:
                        univ.append(b)
                else:
                    push(part)
        else:
            # free variables are constants here (top-level scope), so every
            # non-∀ conjunct is "ground" in the relevant sense
            ground.append(c)

    for c in get_conjuncts(f):
        push(c)
    return ground, univ


def ground_terms_by_type(
    fs: Iterable[Formula], cc: Optional[CongruenceClosure] = None
) -> Dict[Type, List[Formula]]:
    """Collect ground terms from conjuncts, grouped by type, deduplicated
    modulo congruence when a closure is supplied.

    "Ground" means: free of *bound* variables.  Free variables of the input
    are constants (skolemized scope) and do qualify.  Quantified bodies ARE
    mined for ground subterms (terms mentioning no bound variable) — the
    reference's IncrementalGenerator does the same when gathering
    instantiation candidates from axioms."""
    out: Dict[Type, List[Formula]] = {}
    seen: Set = set()

    def _contains_binding(t: Formula) -> bool:
        if isinstance(t, Binding):
            return True
        if isinstance(t, Application):
            return any(_contains_binding(a) for a in t.args)
        return False

    def add(t: Formula):
        if _contains_binding(t):
            # e.g. an Ite/app over a still-quantified subformula from a
            # nested-forall comprehension: not a usable candidate term
            return
        key = cc.repr_of(t) if cc is not None else t
        tag = (t.tpe, key)
        if tag in seen:
            return
        seen.add(tag)
        out.setdefault(t.tpe, []).append(t)

    def is_clean(t: Formula, bound: frozenset) -> bool:
        return not (free_vars(t) & bound)

    def walk(g: Formula, bound: frozenset):
        if isinstance(g, Binding):
            walk(g.body, bound | set(g.vars))
            return
        if isinstance(g, Literal):
            # integer literals are almost always arithmetic coefficients
            # (3·|S| > 2n), not protocol values — using them as candidates
            # multiplies the comprehension-symbol universe for nothing
            return
        if isinstance(g, Variable):
            if g not in bound:
                add(g)
            return
        if isinstance(g, Application):
            # only *model* terms are instantiation candidates: skip measure
            # terms (Cardinality) and arithmetic combinations — using them
            # as candidates feeds back through comprehension symbols into
            # ever-larger terms (S(Card(S(n))), ...) and never helps a proof
            skip = g.fct in _NON_MODEL_FCTS
            if not skip and not isinstance(g.tpe, BoolT) \
                    and is_clean(g, bound):
                add(g)  # add() rejects Binding-containing terms itself
            for a in g.args:
                walk(a, bound)

    for f in fs:
        walk(f, frozenset())
    return out


def instantiate(
    universals: Sequence[Binding],
    ground: Sequence[Formula],
    depth: int = 1,
    max_insts: int = 50_000,
    logger=None,
    logger_base_round: int = 0,
) -> List[Formula]:
    """Eager(depth) instantiation: `depth` rounds of instantiating every
    ∀-clause over every combination of known ground terms of the right type.
    Returns the generated ground formulas (IncrementalGenerator.saturate).

    `logger` (verify.qilog.QILogger) records the instantiation graph —
    a node per clause/instance, an edge per instantiating combo (the
    reference's --logQI machinery, QILogger.scala:20-203)."""
    cc = CongruenceClosure()
    for g in ground:
        cc.add_constraints(g)
    produced: List[Formula] = []
    seen_inst: Set = set()
    roots: dict = {}
    if logger is not None:
        for u in universals:
            roots[id(u)] = logger.add_node(
                u, round=logger_base_round, is_root=True
            )
    # the pool seeds candidate mining; universal clauses contribute the
    # ground subterms of their bodies (bound-var-free ones)
    pool = list(ground) + list(universals)
    for _round in range(depth):
        terms = ground_terms_by_type(pool, cc)
        new: List[Formula] = []
        for u in universals:
            cands = []
            for v in u.vars:
                ts = [t for tt, lst in terms.items() if tt == v.tpe for t in lst]
                cands.append(ts)
            if any(not c for c in cands):
                continue
            for combo in itertools.product(*cands):
                key = (id(u), tuple(cc.repr_of(t) for t in combo))
                if key in seen_inst:
                    continue
                seen_inst.add(key)
                inst = subst_vars(u.body, dict(zip(u.vars, combo)))
                new.append(inst)
                if logger is not None:
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
        pool = pool + new
        if not new or len(seen_inst) > max_insts:
            break
    return produced


# ---------------------------------------------------------------------------
# Type stratification (advisory)
# ---------------------------------------------------------------------------

class TypeStratification:
    """Partial order on types derived from function signatures: T1 ≺ T2 when
    some function maps T1 (an argument) to T2 (result).  An acyclic (DAG)
    order means bounded instantiation behaves like a local theory extension
    (TypeStratification.scala:8-55); cyclic dependencies mean the dropped
    universals may lose completeness (never soundness of UNSAT)."""

    def __init__(self, fs: Iterable[Formula]):
        self.edges: Set[Tuple[Type, Type]] = set()

        def walk(g: Formula):
            if isinstance(g, Application):
                if isinstance(g.fct, UnInterpretedFct) and g.args:
                    for a in g.args:
                        if a.tpe != g.tpe:
                            self.edges.add((a.tpe, g.tpe))
                for a in g.args:
                    walk(a)
            elif isinstance(g, Binding):
                walk(g.body)

        for f in fs:
            walk(f)

    def is_stratified(self) -> bool:
        # cycle check over the type graph
        adj: Dict[Type, List[Type]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        WHITE, GRAY, BLACK = 0, 1, 2
        color: Dict[Type, int] = {}

        def dfs(u) -> bool:
            color[u] = GRAY
            for v in adj.get(u, []):
                c = color.get(v, WHITE)
                if c == GRAY:
                    return False
                if c == WHITE and not dfs(v):
                    return False
            color[u] = BLACK
            return True

        return all(
            dfs(u) for u in list(adj) if color.get(u, WHITE) == WHITE
        )
