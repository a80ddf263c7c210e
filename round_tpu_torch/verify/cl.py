"""CL: the reduction from set-comprehension + cardinality formulas over a
finite-but-unbounded process universe to ground EUF+LIA, and the entailment
check built on it.

Reference parity: psync.logic.CL / ClReducer (logic/CL.scala:197-264) with
the same pipeline shape:

    simplify → theory rewrites (sets / options / maps / Time / orders)
      → NNF → strip ∃ prefix → skolemize → symbolize comprehensions
      → congruence closure + eager quantifier instantiation
      → Venn-region cardinality ILP (+ witness re-instantiation)
      → drop remaining universals → ground solver (solver.py).

`entailment(h, c)` checks h ⊨ c by reducing h ∧ ¬c and testing UNSAT
(CL.scala:106-108).  Dropping universals only ever weakens the hypothesis,
so an 'unsat' answer is authoritative while 'sat' may be a false alarm —
the same asymmetry the reference's assertUnsat tests rely on.

ClConfig mirrors logic/ClConfig.scala:9-31: `venn_bound` is the maximum
number of sets intersected in one region group, `inst_depth` is the eager
instantiation depth (QStrategy(Eager(depth))).

Port of round_tpu/verify/cl.py, copied with only the package name changed.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Dict, List, Optional, Sequence, Tuple

from round_tpu_torch.verify import quantifiers, venn
from round_tpu_torch.verify.formula import (
    AND, And, Application, Binding, Bool, BoolT, CARD, COMPREHENSION, EMPTYSET,
    EQ, Eq, EXISTS, FORALL, FNONE_SYM, FOption, FSOME, FSet, FMap, Formula,
    FunT, GET, Geq, GEQ, GT, Gt, IMPLIES, IN, INTERSECTION, IS_DEFINED,
    IS_DEFINED_AT, Int, IntLit, IntT, ITE, Implies, KEYSET, LEQ, LOOKUP, LT,
    Leq, Literal, Lt, MSIZE, NEQ, Neq, NOT, Not, OR, Or, Plus, SETMINUS,
    SUBSET_EQ, Times, Type, UNION, UPDATED, UnInterpreted, UnInterpretedFct,
    Variable, procType, timeType,
)
from round_tpu_torch.verify.futils import (
    fmap, free_vars, get_conjuncts, subst_vars,
)
from round_tpu_torch.verify.simplify import nnf, pnf, simplify
from round_tpu_torch.verify.solver import SAT, UNKNOWN, UNSAT, solve_ground
from round_tpu_torch.verify.typer import typecheck

_fresh = itertools.count()


@dataclasses.dataclass(frozen=True)
class ClConfig:
    """Tunables (ClConfig.scala:9-31)."""

    venn_bound: int = 2
    inst_depth: int = 1
    max_insts: int = 50_000
    # entailment()'s bounded hypothesis-DNF expansion budget (branch cap):
    # raise it for VCs whose proof IS a large propositional case analysis
    # over opaque subformulas (the staged-chain final ∨-elims), where each
    # branch is trivial but the combined refutation explodes the reducer
    dnf_budget: int = 16
    # quantifier-instantiation strategy (QStrategy, ClConfig.scala:20-24):
    # "eager" = full type-correct product (Eager(depth)); "ematch" =
    # trigger-guided e-matching (logic/Matching.scala) — far fewer
    # instances on clause-heavy problems, same soundness
    strategy: str = "eager"
    # optional verify.tactics.Tactic guiding round-1 instantiation with a
    # depth-bounded term priority queue (Tactic.scala); overrides
    # `strategy` when set.  Stateful but re-initialized per reduce().
    tactic: object = None
    # optional verify.qilog.QILogger recording the instantiation graph
    # (the reference's --logQI, VerificationOptions.scala:23)
    qi_logger: object = None

    def __post_init__(self):
        if self.strategy not in ("eager", "ematch"):
            raise ValueError(
                f"unknown QI strategy {self.strategy!r}: "
                "expected 'eager' or 'ematch'"
            )


ClDefault = ClConfig(venn_bound=2, inst_depth=1)
ClFull = ClConfig(venn_bound=3, inst_depth=2)
ClProc = ClConfig(venn_bound=2, inst_depth=1)


# ---------------------------------------------------------------------------
# Theory rewrites
# ---------------------------------------------------------------------------

def rewrite_set_algebra(f: Formula) -> Formula:
    """Push membership through set algebra and expand subset/set-equality to
    bounded quantification (the reference does this inside CL normalization +
    SetOperationsAxioms, AxiomatizedTheories.scala:8-209)."""

    def elem_type(s: Formula) -> Type:
        return s.tpe.elem if isinstance(s.tpe, FSet) else procType

    def step(g: Formula) -> Formula:
        if not isinstance(g, Application):
            return g
        if g.fct == IN:
            x, s = g.args
            if isinstance(s, Application):
                if s.fct == UNION:
                    return Or(*[step(Application(IN, [x, a]).with_type(Bool))
                                for a in s.args])
                if s.fct == INTERSECTION:
                    return And(*[step(Application(IN, [x, a]).with_type(Bool))
                                 for a in s.args])
                if s.fct == SETMINUS:
                    return And(
                        step(Application(IN, [x, s.args[0]]).with_type(Bool)),
                        Not(step(Application(IN, [x, s.args[1]]).with_type(Bool))),
                    )
                if s.fct == EMPTYSET:
                    return Literal(False)
            if isinstance(s, Binding) and s.binder == COMPREHENSION:
                # β-reduce: t ∈ {y | body} → body[y := t]
                assert len(s.vars) == 1
                return subst_vars(s.body, {s.vars[0]: x})
        if g.fct == SUBSET_EQ:
            a, b = g.args
            v = Variable(f"sub!{next(_fresh)}", elem_type(a))
            mem_a = Application(IN, [v, a]).with_type(Bool)
            mem_b = Application(IN, [v, b]).with_type(Bool)
            return Binding(FORALL, [v], Implies(step(mem_a), step(mem_b))
                           ).with_type(Bool)
        if g.fct == NEQ and isinstance(g.args[0].tpe, FSet):
            eq = Application(EQ, list(g.args)).with_type(Bool)
            return Not(step(eq))
        if g.fct == EQ and isinstance(g.args[0].tpe, FSet):
            a, b = g.args
            v = Variable(f"ext!{next(_fresh)}", elem_type(a))
            mem_a = step(Application(IN, [v, a]).with_type(Bool))
            mem_b = step(Application(IN, [v, b]).with_type(Bool))
            ext = Binding(
                FORALL, [v],
                And(Implies(mem_a, mem_b), Implies(mem_b, mem_a)),
            ).with_type(Bool)
            # extensionality + matching cardinalities
            card_a = Application(CARD, [a]).with_type(Int)
            card_b = Application(CARD, [b]).with_type(Int)
            return And(ext, Application(EQ, [card_a, card_b]).with_type(Bool))
        if g.fct == CARD and isinstance(g.args[0], Application) \
                and g.args[0].fct == EMPTYSET:
            return IntLit(0)
        return g

    return fmap(step, f)


def rewrite_options(f: Formula) -> Formula:
    """Inline the option laws the reference axiomatizes (OptionAxioms,
    AxiomatizedTheories.scala): IsDefined(Some x), ¬IsDefined(None),
    Get(Some x) = x.  Remaining Get/IsDefined on opaque option terms stay
    uninterpreted (sound)."""

    def step(g: Formula) -> Formula:
        if not isinstance(g, Application):
            return g
        if g.fct == IS_DEFINED and isinstance(g.args[0], Application):
            inner = g.args[0]
            if inner.fct == FSOME:
                return Literal(True)
            if inner.fct == FNONE_SYM:
                return Literal(False)
        if g.fct == GET and isinstance(g.args[0], Application) \
                and g.args[0].fct == FSOME:
            return g.args[0].args[0]
        if g.fct in (EQ, NEQ) and isinstance(g.args[0].tpe, FOption):
            a, b = g.args
            # Some(x) = Some(y) → x = y ; Some(x) = None → false
            if isinstance(a, Application) and isinstance(b, Application):
                if a.fct == FSOME and b.fct == FSOME:
                    inner = Application(EQ, [a.args[0], b.args[0]]).with_type(Bool)
                    return inner if g.fct == EQ else Not(inner)
                kinds = {a.fct, b.fct}
                if kinds == {FSOME, FNONE_SYM}:
                    return Literal(g.fct == NEQ)
                if a.fct == FNONE_SYM and b.fct == FNONE_SYM:
                    return Literal(g.fct == EQ)
        return g

    return fmap(step, f)


def rewrite_maps(f: Formula) -> Formula:
    """Maps → sets + uninterpreted lookups (ReduceMaps.scala:8-31 +
    MapUpdateAxioms): IsDefinedAt(m,k) → k ∈ KeySet(m); Size(m) →
    |KeySet(m)|; LookUp(Updated(m,k,v), j) → ite(j=k, v, LookUp(m,j));
    KeySet(Updated(m,k,v)) → KeySet(m) ∪ {k}."""

    def step(g: Formula) -> Formula:
        if not isinstance(g, Application):
            return g
        if g.fct == IS_DEFINED_AT:
            m, k = g.args
            ks = Application(KEYSET, [m])
            if isinstance(m.tpe, FMap):
                ks.tpe = FSet(m.tpe.key)
            return Application(IN, [k, ks]).with_type(Bool)
        if g.fct == MSIZE:
            m = g.args[0]
            ks = Application(KEYSET, [m])
            if isinstance(m.tpe, FMap):
                ks.tpe = FSet(m.tpe.key)
            return Application(CARD, [ks]).with_type(Int)
        if g.fct == LOOKUP and isinstance(g.args[0], Application) \
                and g.args[0].fct == UPDATED:
            upd, j = g.args
            m, k, v = upd.args
            eq = Application(EQ, [j, k]).with_type(Bool)
            rec = step(Application(LOOKUP, [m, j]).with_type(g.tpe))
            return Application(ITE, [eq, v, rec]).with_type(g.tpe)
        if g.fct == KEYSET and isinstance(g.args[0], Application) \
                and g.args[0].fct == UPDATED:
            m, k, _v = g.args[0].args
            inner = step(Application(KEYSET, [m]).with_type(g.tpe))
            x = Variable(f"ks!{next(_fresh)}", k.tpe)
            singleton = Binding(
                COMPREHENSION, [x],
                Application(EQ, [x, k]).with_type(Bool),
            )
            singleton.tpe = g.tpe
            return Application(UNION, [inner, singleton]).with_type(g.tpe)
        return g

    return fmap(step, f)


def reduce_time(f: Formula) -> Formula:
    """Erase the Time type to Int (ReduceTime.scala:8-46).  Time values in
    this framework are already integer rounds (core/time.py), so only the
    type annotation needs rewriting."""

    def retype(t: Optional[Type]) -> Optional[Type]:
        if t == timeType:
            return Int
        if isinstance(t, FSet):
            return FSet(retype(t.elem))
        if isinstance(t, FOption):
            return FOption(retype(t.elem))
        if isinstance(t, FMap):
            return FMap(retype(t.key), retype(t.value))
        if isinstance(t, FunT):
            return FunT([retype(a) for a in t.args], retype(t.ret))
        return t

    def step(g: Formula) -> Formula:
        if g.tpe is not None:
            g.tpe = retype(g.tpe)
        if isinstance(g, Variable):
            return g
        return g

    out = fmap(step, f)

    def fix_syms(g: Formula) -> Formula:
        if isinstance(g, Application) and isinstance(g.fct, UnInterpretedFct) \
                and g.fct.tpe is not None:
            g.fct.tpe = retype(g.fct.tpe)
        return g

    return fmap(fix_syms, out)


def reduce_ordered(f: Formula) -> Formula:
    """Comparisons over non-Int uninterpreted types become an uninterpreted
    total order lt_T with its axioms (ReduceOrdered.scala:31-82)."""
    axioms: List[Formula] = []
    orders: Dict[Type, UnInterpretedFct] = {}

    def order_for(t: Type) -> UnInterpretedFct:
        if t not in orders:
            lt = UnInterpretedFct(f"lt!{t!r}", FunT([t, t], Bool))
            orders[t] = lt
            x = Variable(f"ox!{next(_fresh)}", t)
            y = Variable(f"oy!{next(_fresh)}", t)
            z = Variable(f"oz!{next(_fresh)}", t)

            def app(a, b):
                return Application(lt, [a, b]).with_type(Bool)

            axioms.append(Binding(FORALL, [x], Not(app(x, x))).with_type(Bool))
            axioms.append(Binding(
                FORALL, [x, y, z],
                Implies(And(app(x, y), app(y, z)), app(x, z)),
            ).with_type(Bool))
            axioms.append(Binding(
                FORALL, [x, y],
                Or(app(x, y), app(y, x),
                   Application(EQ, [x, y]).with_type(Bool)),
            ).with_type(Bool))
        return orders[t]

    def step(g: Formula) -> Formula:
        if isinstance(g, Application) and g.fct in (LT, LEQ, GT, GEQ):
            t = g.args[0].tpe
            if t is not None and isinstance(t, UnInterpreted) and t != procType:
                lt = order_for(t)
                a, b = g.args

                def app(u, v):
                    return Application(lt, [u, v]).with_type(Bool)

                if g.fct == LT:
                    return app(a, b)
                if g.fct == GT:
                    return app(b, a)
                eq = Application(EQ, [a, b]).with_type(Bool)
                if g.fct == LEQ:
                    return Or(app(a, b), eq)
                return Or(app(b, a), eq)
        return g

    out = fmap(step, f)
    if axioms:
        out = And(out, *axioms)
    return out


def theory_ground_axioms(conjuncts: Sequence[Formula]) -> List[Formula]:
    """Ground instances of the option/tuple/map-update laws for every
    constructor application present (OptionAxioms/TupleAxioms/
    MapUpdateAxioms, AxiomatizedTheories.scala:8-209, e-matching-lite):

      Some(x)          ⊢ IsDefined ∧ Get = x;  None ⊢ ¬IsDefined
      Tuple(a, b)      ⊢ Fst = a ∧ Snd = b  (pairs; wider tuples thin)
      U = Updated(m, k, v) ⊢ LookUp(U, k) = v ∧ k ∈ KeySet(U), and for
        every OTHER ground key-typed term j in the universe:
        j ≠ k → LookUp(U, j) = LookUp(m, j)
        j ≠ k → (j ∈ KeySet(U) ↔ j ∈ KeySet(m))

    Congruence closure then transports these to opaque terms merely EQUAL
    to a constructor (x = Some(p) ⊢ Get(x) = p; log1 = Updated(log0, …) ⊢
    the VsExample "check" lemmas), which the syntactic rewrites
    (rewrite_maps) cannot reach."""
    from round_tpu_torch.verify.formula import FST, SND, TUPLE
    from round_tpu_torch.verify.futils import collect_ground_terms

    out: List[Formula] = []
    updates: List[Application] = []
    key_terms: Dict[Type, List[Formula]] = {}
    all_ground: set = set()
    for c in conjuncts:
        for g in collect_ground_terms(c):
            if g in all_ground:
                continue
            all_ground.add(g)
            key_terms.setdefault(g.tpe, []).append(g)
            if not isinstance(g, Application):
                continue
            if g.fct == FSOME:
                out.append(Application(IS_DEFINED, [g]).with_type(Bool))
                out.append(Eq(Application(GET, [g]).with_type(g.args[0].tpe),
                              g.args[0]))
            elif g.fct == FNONE_SYM:
                out.append(Not(Application(IS_DEFINED, [g]).with_type(Bool)))
            elif g.fct == TUPLE and len(g.args) == 2:  # pairs (3-tuples: thin)
                for k, proj in enumerate((FST, SND)):
                    out.append(Eq(
                        Application(proj, [g]).with_type(g.args[k].tpe),
                        g.args[k],
                    ))
            elif g.fct == UPDATED:
                updates.append(g)

    # Literal keys too (LookUp(m, 3)): collect_ground_terms never yields
    # Literals, but the Updated frame axioms below must range over them —
    # they are used only here, so the usual literal-bloat concern
    # (quantifiers.ground_terms_by_type) does not apply
    def _mine_literals(g: Formula):
        if isinstance(g, Literal):
            if g not in all_ground:
                all_ground.add(g)
                key_terms.setdefault(g.tpe, []).append(g)
        elif isinstance(g, Application):
            for a in g.args:
                _mine_literals(a)
        elif isinstance(g, Binding):
            _mine_literals(g.body)

    if updates:
        for c in conjuncts:
            _mine_literals(c)

    def keyset_of(m):
        ks = Application(KEYSET, [m])
        if isinstance(m.tpe, FMap):
            ks.tpe = FSet(m.tpe.key)
        return ks

    for u in updates:
        m, k, v = u.args
        val_t = m.tpe.value if isinstance(m.tpe, FMap) else v.tpe
        key_t = m.tpe.key if isinstance(m.tpe, FMap) else k.tpe
        out.append(Eq(Application(LOOKUP, [u, k]).with_type(val_t), v))
        out.append(Application(IN, [k, keyset_of(u)]).with_type(Bool))
        for j in key_terms.get(key_t, []):
            if j == k:
                continue
            ne = Neq(j, k)
            out.append(Or(Not(ne), Eq(
                Application(LOOKUP, [u, j]).with_type(val_t),
                Application(LOOKUP, [m, j]).with_type(val_t),
            )))
            in_u = Application(IN, [j, keyset_of(u)]).with_type(Bool)
            in_m = Application(IN, [j, keyset_of(m)]).with_type(Bool)
            out.append(Or(Not(ne), And(Or(Not(in_u), in_m),
                                       Or(Not(in_m), in_u))))
    return out


def _eliminate_int_div(f: Formula) -> Tuple[Formula, List[Formula]]:
    """Linearize integer division by a positive constant:  num // k  becomes
    a fresh q with  k·q ≤ num ≤ k·q + (k-1).  Only terms whose variables are
    all free in `f` are rewritten (a Divides under a binder over its own
    variables stays put, and later fails as a foreign term — sound).

    The jaxpr extractor produces these from ``(2 * n) // 3``-style quorum
    arithmetic in executable round code (extract.py)."""
    from round_tpu_torch.verify.formula import DIVIDES

    axioms: List[Formula] = []
    cache: Dict[str, Variable] = {}

    def walk(g: Formula, bound: frozenset) -> Formula:
        if isinstance(g, Binding):
            inner_bound = bound | {v.name for v in g.vars}
            out = Binding(g.binder, g.vars, walk(g.body, inner_bound))
            out.tpe = g.tpe
            return out
        if isinstance(g, Application):
            args = [walk(a, bound) for a in g.args]
            out = Application(g.fct, args)
            out.tpe = g.tpe
            if (
                g.fct == DIVIDES
                and isinstance(args[1], Literal)
                and isinstance(args[1].value, int)
                and args[1].value > 0
                and not ({v.name for v in free_vars(args[0])} & bound)
            ):
                k = args[1].value
                key = repr(out)
                if key not in cache:
                    q = Variable(f"divq!{next(_fresh)}", Int)
                    cache[key] = q
                    num = args[0]
                    axioms.append(Leq(Times(k, q), num))
                    axioms.append(Leq(num, Plus(Times(k, q), IntLit(k - 1))))
                return cache[key]
            return out
        return g

    return walk(f, frozenset()), axioms


_FRESH_NAME = re.compile(r"^(.*!)(\d+)$")


def _canonicalize_fresh_names(f: Formula) -> Formula:
    """Rename every counter-suffixed symbol (``prefix!<digits>`` — the
    shape ALL fresh-name generators here produce) to a canonical
    first-occurrence index: ``prefix!cn<k>``.

    Solver behavior is otherwise sensitive to the global fresh counters'
    values at spec-BUILD time: two semantically identical problems whose
    symbols differ only in counter digits sort differently in the venn
    group enumeration and the SAT branching order, and a measured 6 s
    proof became a 450 s timeout purely from building another spec first.
    After canonicalization the reduction is a function of the formula's
    structure alone."""
    mapping: Dict[str, str] = {}
    seq = itertools.count()

    def canon(name: str) -> str:
        m = _FRESH_NAME.match(name)
        if not m:
            return name
        if name not in mapping:
            mapping[name] = f"{m.group(1)}cn{next(seq)}"
        return mapping[name]

    fct_cache: Dict[int, object] = {}
    node_cache: Dict[int, Formula] = {}  # id-keyed: formulas share sub-DAGs

    def go(g: Formula) -> Formula:
        key = id(g)
        hit = node_cache.get(key)
        if hit is not None:
            return hit
        if isinstance(g, Variable):
            new = canon(g.name)
            out = g if new is g.name else Variable(new, g.tpe)
        elif isinstance(g, Application):
            fct = g.fct
            if isinstance(fct, UnInterpretedFct):
                new = canon(fct.name)
                if new != fct.name:
                    fkey = id(fct)
                    if fkey not in fct_cache:
                        fct_cache[fkey] = UnInterpretedFct(new, fct.tpe)
                    fct = fct_cache[fkey]
            args = [go(a) for a in g.args]
            if fct is g.fct and all(a is b for a, b in zip(args, g.args)):
                out = g  # untouched subtree: keep the shared node
            else:
                out = Application(fct, args)
                out.tpe = g.tpe
        elif isinstance(g, Binding):
            vars_ = [go(v) for v in g.vars]
            body = go(g.body)
            if body is g.body and all(a is b for a, b in zip(vars_, g.vars)):
                out = g
            else:
                out = Binding(g.binder, vars_, body)
                out.tpe = g.tpe
        else:
            out = g
        node_cache[key] = out
        return out

    return go(f)


def _contains_binder(t: Formula) -> bool:
    if isinstance(t, Binding):
        return True
    if isinstance(t, Application):
        return any(_contains_binder(a) for a in t.args)
    return False


def lift_quantified_ites(f: Formula) -> Formula:
    """atom[Ite(c, t, e)] with a QUANTIFIER inside ANY of c/t/e →
    (c ∧ atom[t]) ∨ (¬c ∧ atom[e]).

    Term-level Ites with ground conditions are left for the solver's late
    lifting (solver.lift_ite); a quantified operand must surface into
    boolean structure BEFORE nnf/skolemization/instantiation or QI never
    sees it.  Quantified CONDITIONS come from event-round extracted folds
    (an AND-fold extracts as ∀ inside the decision Ite); quantified
    BRANCHES from guarded boolean updates (KSetEarlyStopping's
    canDecide' = Ite(deciding, can, ∃heard-can ∨ trigger) — without the
    lift the ∃ stays buried in an opaque Bool-Eq atom and the
    can-propagation lemma is unprovable)."""
    from round_tpu_torch.verify.futils import replace as _replace

    def find_qite(t):
        if isinstance(t, Application):
            if t.fct == ITE and any(_contains_binder(a) for a in t.args):
                return t
            for a in t.args:
                r = find_qite(a)
                if r is not None:
                    return r
        return None

    def go(g: Formula) -> Formula:
        if isinstance(g, Binding):
            h = Binding(g.binder, g.vars, go(g.body))
            h.tpe = g.tpe
            return h
        if isinstance(g, Application) and g.fct in (AND, OR, NOT, IMPLIES):
            h = Application(g.fct, [go(a) for a in g.args])
            h.tpe = g.tpe
            return h
        if isinstance(g, Application):
            ite = find_qite(g)
            if ite is not None:
                c, t, e = ite.args
                return go(Or(
                    And(c, _replace(g, ite, t)),
                    And(Not(c), _replace(g, ite, e)),
                ))
        return g

    return go(f)


# ---------------------------------------------------------------------------
# The reducer
# ---------------------------------------------------------------------------

class ClReducer:
    def __init__(self, config: ClConfig = ClDefault):
        self.config = config

    def reduce(self, f: Formula) -> Formula:
        """Full reduction to a ground formula (CL.reduce, CL.scala:197-264)."""
        cfg = self.config
        if cfg.qi_logger is not None:
            cfg.qi_logger.new_phase(
                f"vb{cfg.venn_bound}/d{cfg.inst_depth}#{next(_fresh)}"
            )
        f = _canonicalize_fresh_names(f)
        f = simplify(f)
        f = typecheck(f)
        f = reduce_time(f)
        f = rewrite_maps(f)
        f = rewrite_options(f)
        f = rewrite_set_algebra(f)
        f = reduce_ordered(f)
        f, div_axioms = _eliminate_int_div(f)
        if div_axioms:
            f = And(f, *div_axioms)
        f = typecheck(f)
        f = lift_quantified_ites(f)
        f = nnf(f)
        f, _consts = quantifiers.get_existential_prefix(f)
        f = quantifiers.skolemize(f)
        # prenex each conjunct: a nested ∀ inside a disjunction (axiom shape
        # ∀j. c → (a ∧ ∀i. d)) must join the clause prefix, or instantiation
        # never reaches it and it survives as an opaque embedded quantifier
        f = And(*[pnf(c) for c in get_conjuncts(f)])
        f, setdefs = quantifiers.symbolize_comprehensions(f)
        f = typecheck(f)

        ground, universals = quantifiers._clause_split(f)
        # the process universe is nonempty (|ProcessID| = n ≥ 1,
        # CL.sizeOfUniverse semantics): majority sets must have witnesses
        ground.append(Geq(venn.N_VAR, 1))
        for sd in setdefs:
            if sd.definition is not None:
                d = typecheck(sd.definition)
                # a comprehension body with its own quantifier (e.g. the
                # kernel {i | ∀j. i ∈ HO(j)}) leaves the def's ↔ with a
                # nested ∀ / (after nnf) ∃: skolemize the ∃ and prenex so
                # instantiation can reach the inner variable
                d = quantifiers.skolemize(nnf(d))
                d = And(*[pnf(c) for c in get_conjuncts(d)])
                # split like the main formula: ∀∀ chains collapse and ∀
                # distributes over ∧, so EVERY bound variable (including
                # ones prenexed out of the comprehension body) is
                # instantiated — an appended ∀x.∀j clause would only ever
                # get its outer variable substituted
                dg, du = quantifiers._clause_split(d)
                ground.extend(dg)
                universals.extend(du)

        # round 1: quantifier instantiation over the ground terms
        if cfg.tactic is not None:
            from round_tpu_torch.verify.tactics import instantiate_tactic
            insts = instantiate_tactic(
                universals, ground, cfg.tactic,
                max_insts=cfg.max_insts, logger=cfg.qi_logger,
            )
        elif cfg.strategy == "ematch":
            from round_tpu_torch.verify.matching import instantiate_matching
            insts = instantiate_matching(
                universals, ground, depth=cfg.inst_depth,
                max_insts=cfg.max_insts, logger=cfg.qi_logger,
            )
        else:
            insts = quantifiers.instantiate(
                universals, ground, depth=cfg.inst_depth,
                max_insts=cfg.max_insts, logger=cfg.qi_logger,
            )
        # membership may have been β-reduced inside instances
        insts = [rewrite_set_algebra(i) for i in insts]
        base = ground + insts
        base = base + theory_ground_axioms(base)

        # venn regions over everything ground so far (persistent instances:
        # the witness-round rewrite below must share card/region variables).
        # Groups are restricted to card-relevant sets; membership facts about
        # other sets flow through instantiation alone.  venn_bound=0 turns
        # the ILP off entirely (EUF/LIA-only effort rung — sound, weaker).
        elements = quantifiers.ground_terms_by_type(base)
        if cfg.venn_bound >= 1:
            carded = venn.carded_supports(base)
            regions = venn.build_regions(
                base, elements, bound=cfg.venn_bound, only=carded
            )
        else:
            regions = {}
        all_witnesses: List[Formula] = []
        for vr in regions.values():
            all_witnesses.extend(vr.witnesses)

        # round 2: make the universals bite on the region witnesses.
        # DELIBERATELY eager even under strategy="ematch": witnesses are
        # fresh variables with no function applications over them, so no
        # trigger can fire on them — e-matching here would drop exactly the
        # witness instances the venn chain needs (the cost is bounded: the
        # witness universe is the region count, not the full term universe)
        # Round 2 runs eagerly over `base` (ground + round-1 instances +
        # theory axioms) — for the eager strategy this IS the second depth
        # level (instances over terms first created in round 1), so it must
        # run even without witnesses.  For tactic/ematch configs an eager
        # re-run would bypass the configured strategy entirely (the
        # depth-0 control test pins this), so without witnesses it is
        # skipped there.
        guided = cfg.tactic is not None or cfg.strategy == "ematch"
        if all_witnesses or not guided:
            wit_ground = base + [
                Application(EQ, [w, w]).with_type(Bool)
                for w in all_witnesses
            ]
            insts2 = quantifiers.instantiate(
                universals, wit_ground, depth=cfg.inst_depth,
                max_insts=cfg.max_insts, logger=cfg.qi_logger,
                logger_base_round=100,  # witness-round instances group apart
            )
            insts2 = [rewrite_set_algebra(i) for i in insts2]
            # round 2 regenerates the round-1 instances (fresh dedup
            # state); keep only the genuinely new ones
            base_set = set(base)
            insts2 = [i for i in insts2 if i not in base_set]
        else:
            insts2 = []

        # close the membership→cardinality direction for the witnesses: a
        # witness proved (through set definitions) to be in a carded set must
        # force that set's region sum ≥ 1, or majority-intersection facts
        # never reach Card hypotheses of instantiated axioms
        for vr in regions.values():
            vr.add_elements(vr.witnesses)

        rewritten = venn.rewrite_cards(regions, base + insts2)
        constraints, _wits = venn.collect(regions)

        out = And(*(rewritten + constraints))
        return typecheck(out)

    def check_sat(self, f: Formula, timeout_s: float = 120.0) -> str:
        # the default wall budget is the termination backstop now that
        # solve_ground's round cap is effectively unbounded
        return solve_ground(self.reduce(f), timeout_s=timeout_s)

    def entailment(self, hypothesis: Formula, conclusion: Formula) -> bool:
        """h ⊨ c  iff  h ∧ ¬c is UNSAT after reduction (CL.scala:106-108).
        Only an UNSAT verdict proves entailment."""
        return self.check_sat(And(hypothesis, Not(conclusion))) == UNSAT


def reduce(f: Formula, config: ClConfig = ClDefault) -> Formula:
    return ClReducer(config).reduce(f)


def _ladder(config: ClConfig) -> List[ClConfig]:
    """Effort ladder: EUF/LIA-only (no Venn ILP) first, then the requested
    config.  Each rung is sound (UNSAT is final); rungs only add reasoning
    power, so proofs that need no cardinality ILP stay cheap."""
    rungs = []
    if config.venn_bound >= 1:
        rungs.append(
            dataclasses.replace(config, venn_bound=0, inst_depth=1)
        )
        if config.inst_depth > 1:
            rungs.append(dataclasses.replace(config, venn_bound=0))
    if config.inst_depth > 1:
        # depth-1 instantiation with the full ILP: an order of magnitude
        # fewer ground conjuncts — most deep configs never need depth 2
        rungs.append(dataclasses.replace(config, inst_depth=1))
    if config.venn_bound > 2:
        rungs.append(dataclasses.replace(config, venn_bound=2))
    rungs.append(config)
    return [r for i, r in enumerate(rungs) if r not in rungs[:i]]


def _hyp_disjuncts(f: Formula, budget: int = 16) -> List[Formula]:
    """Bounded DNF expansion of a hypothesis: (A∨B) ∧ K → [A∧K, B∧K].
    Mirrors the reference's decompose + optional DNF (VC.scala:76-96,
    logic/TestCommon.scala:42-49) — each branch is a much easier query than
    the combined disjunction, whose refutation the instantiation must find
    for all branches at once.  Implication conjuncts split as their Or
    form (A→B ⇔ ¬A∨B): the staged-chain final VCs carry their case
    analysis as closed conditionals, and leaving them packed forces the
    reducer to distribute CNF over both bodies at once."""
    conj = get_conjuncts(f)
    branches: List[List[Formula]] = [[]]
    for c in conj:
        opts = None
        if isinstance(c, Application):
            if c.fct == OR:
                opts = list(c.args)
            elif c.fct == IMPLIES and len(c.args) == 2:
                opts = [Not(c.args[0]), c.args[1]]
        if opts is not None:
            if len(branches) * len(opts) > budget:
                for b in branches:
                    b.append(c)
                continue
            branches = [b + [o] for b in branches for o in opts]
        else:
            for b in branches:
                b.append(c)
    return [And(*b) if len(b) != 1 else b[0] for b in branches]


def _concl_conjuncts(f: Formula, budget: int = 32) -> List[Formula]:
    """Split a conclusion into independently-provable conjuncts, pushing the
    split under universal quantifiers: ∀x (A∧B) → [∀x A, ∀x B]."""
    out: List[Formula] = []

    def go(g: Formula, binders: List):
        if len(out) > budget:
            return
        if isinstance(g, Application) and g.fct == AND:
            for a in g.args:
                go(a, binders)
        elif isinstance(g, Binding) and g.binder == FORALL:
            go(g.body, binders + [g.vars])
        else:
            for vs in reversed(binders):
                g = Binding(FORALL, vs, g).with_type(Bool)
            out.append(g)

    go(f, [])
    return out if len(out) <= budget else [f]


def entailment(
    h: Formula,
    c: Formula,
    config: ClConfig = ClDefault,
    timeout_s: Optional[float] = 120.0,
    decompose: bool = True,
    total_timeout_s: Optional[float] = None,
) -> bool:
    """h ⊨ c via decomposition + the effort ladder.  `timeout_s` bounds each
    rung's ground solve (default 120 s — the solver's round cap is not a
    practical backstop); `total_timeout_s` additionally bounds the WHOLE
    call (decomposition multiplies solves: rungs × hypothesis disjuncts ×
    conclusion conjuncts — a failing query must not burn the per-solve
    budget once per piece).  Only UNSAT verdicts (for every sub-VC) prove
    the entailment."""
    import time as _time

    t0 = _time.monotonic()

    def budget() -> Optional[float]:
        if total_timeout_s is None:
            return timeout_s
        left = total_timeout_s - (_time.monotonic() - t0)
        if left <= 0:
            return 0.0
        return min(timeout_s, left) if timeout_s is not None else left

    if not decompose:
        return _entailment_core(h, c, config, budget)
    dnf_budget = (config or ClDefault).dnf_budget
    for hd in _hyp_disjuncts(h, budget=dnf_budget):
        for cc in _concl_conjuncts(c):
            if not _entailment_core(hd, cc, config, budget):
                return False
    return True


def _entailment_core(
    h: Formula, c: Formula, config: ClConfig, budget
) -> bool:
    if not callable(budget):
        fixed = budget
        budget = lambda: fixed  # noqa: E731 - plain-timeout compatibility
    f = And(h, Not(c))
    for cfg in _ladder(config):
        left = budget()
        if left is not None and left <= 0:
            return False
        red = ClReducer(cfg)
        ground = red.reduce(f)
        # the reduction itself (canonicalize, venn enumeration, eager
        # instantiation) can eat the whole budget on a pathological
        # sub-VC — re-check before handing what remains to the solver
        left = budget()
        if left is not None and left <= 0:
            return False
        if solve_ground(ground, timeout_s=left) == UNSAT:
            return True
    return False
