"""Normal forms and simplification.

Reference parity: psync.formula.Simplify (formula/Simplify.scala): nnf (:22),
pnf (:174), cnf (:48) / dnf (:67), bound-variable uniqueness (:360), and the
boolean / integer / quantifier simplifiers (:437-585) with a master
``simplify`` (:587).

Port of round_tpu/verify/simplify.py, copied with only the package name changed.
"""

from __future__ import annotations

from typing import List

from round_tpu_torch.verify.formula import (
    AND, Application, Binding, BoolT, COMPREHENSION, EQ, EXISTS, FALSE, FORALL,
    Formula, GEQ, GT, IMPLIES, ITE, LEQ, LT, Literal, NEQ, NOT, OR, TRUE,
    And, Eq, Exists, ForAll, Geq, Gt, Implies, Leq, Literal as Lit, Lt, Neq,
    Not, Or, Variable,
)
from round_tpu_torch.verify.futils import alpha_all, fmap, free_vars, subst_vars

_NEG_DUAL = {LEQ: GT, LT: GEQ, GEQ: LT, GT: LEQ, EQ: NEQ, NEQ: EQ}


def nnf(f: Formula, neg: bool = False) -> Formula:
    """Negation normal form; also eliminates Implies (Simplify.nnf)."""
    if isinstance(f, Literal) and isinstance(f.value, bool):
        return Lit(not f.value) if neg else f
    if isinstance(f, Application):
        if f.fct == NOT:
            return nnf(f.args[0], not neg)
        if f.fct == AND:
            args = [nnf(a, neg) for a in f.args]
            return Or(*args) if neg else And(*args)
        if f.fct == OR:
            args = [nnf(a, neg) for a in f.args]
            return And(*args) if neg else Or(*args)
        if f.fct == IMPLIES:
            a, b = f.args
            if neg:
                return And(nnf(a, False), nnf(b, True))
            return Or(nnf(a, True), nnf(b, False))
        if f.fct in (EQ, NEQ) and f.args[0].tpe is not None \
                and isinstance(f.args[0].tpe, BoolT):
            # boolean equality is a biconditional, not an EUF atom — expand
            # so the case split is visible to the SAT core (x = (|A| > t)
            # shapes from predicate-definition axioms)
            a, b = f.args
            flip = neg == (f.fct == EQ)  # Eq negated or Neq positive -> xor
            if flip:
                return Or(
                    And(nnf(a, False), nnf(b, True)),
                    And(nnf(a, True), nnf(b, False)),
                )
            return And(
                Or(nnf(a, True), nnf(b, False)),
                Or(nnf(a, False), nnf(b, True)),
            )
        if neg and f.fct in _NEG_DUAL:
            g = Application(_NEG_DUAL[f.fct], list(f.args))
            g.tpe = f.tpe
            return g
        return Not(f) if neg else f
    if isinstance(f, Binding):
        if f.binder == COMPREHENSION:
            return Not(f) if neg else f
        binder = f.binder
        if neg:
            binder = EXISTS if binder == FORALL else FORALL
        g = Binding(binder, f.vars, nnf(f.body, neg))
        g.tpe = f.tpe
        return g
    return Not(f) if neg else f


def pnf(f: Formula) -> Formula:
    """Prenex normal form.  Assumes nnf; makes bound vars unique first
    (Simplify.pnf)."""
    f = alpha_all(nnf(f))

    def pull(g: Formula):
        """returns (prefix:list[(binder, vars)], matrix)"""
        if isinstance(g, Application) and g.fct in (AND, OR):
            prefixes, matrices = [], []
            for a in g.args:
                p, m = pull(a)
                prefixes.extend(p)
                matrices.append(m)
            h = Application(g.fct, matrices)
            h.tpe = g.tpe
            return prefixes, h
        if isinstance(g, Binding) and g.binder in (FORALL, EXISTS):
            p, m = pull(g.body)
            return [(g.binder, g.vars)] + p, m
        return [], g

    prefix, matrix = pull(f)
    out = matrix
    for binder, vars in reversed(prefix):
        out = Binding(binder, vars, out)
    return out


def _distribute_or_over_and(args: List[Formula]) -> Formula:
    """or(args) where each arg is a conjunction of clauses -> cnf."""
    from itertools import product

    conj_lists = []
    for a in args:
        if isinstance(a, Application) and a.fct == AND:
            conj_lists.append(list(a.args))
        else:
            conj_lists.append([a])
    clauses = [Or(*combo) for combo in product(*conj_lists)]
    return And(*clauses)


def cnf(f: Formula) -> Formula:
    """Conjunctive normal form of a quantifier-free nnf formula
    (Simplify.cnf).  Quantifiers are treated as atoms."""
    if isinstance(f, Application):
        if f.fct == AND:
            return And(*[cnf(a) for a in f.args])
        if f.fct == OR:
            return _distribute_or_over_and([cnf(a) for a in f.args])
    return f


def dnf(f: Formula) -> Formula:
    """Disjunctive normal form (Simplify.dnf), dual of cnf."""
    if isinstance(f, Application):
        if f.fct == OR:
            return Or(*[dnf(a) for a in f.args])
        if f.fct == AND:
            from itertools import product

            disj_lists = []
            for a in f.args:
                d = dnf(a)
                if isinstance(d, Application) and d.fct == OR:
                    disj_lists.append(list(d.args))
                else:
                    disj_lists.append([d])
            cubes = [And(*combo) for combo in product(*disj_lists)]
            return Or(*cubes)
    return f


def _int_lit(f: Formula):
    if isinstance(f, Literal) and isinstance(f.value, int) \
            and not isinstance(f.value, bool):
        return f.value
    return None


def simplify_int(f: Formula) -> Formula:
    """Fold constant arithmetic and decide constant comparisons
    (Simplify.simplifyInt).  ``fmap`` is bottom-up, so children are already
    folded: an op folds iff all its args are integer literals — O(arity)
    per node."""
    from round_tpu_torch.verify.formula import DIVIDES, MINUS, PLUS, TIMES, UMINUS

    _CMP = {LT: lambda a, b: a < b, LEQ: lambda a, b: a <= b,
            GT: lambda a, b: a > b, GEQ: lambda a, b: a >= b}

    def fn(g):
        if not isinstance(g, Application):
            return g
        vals = [_int_lit(a) for a in g.args]
        if any(v is None for v in vals):
            return g
        if g.fct == PLUS:
            return Lit(sum(vals))
        if g.fct == MINUS:
            return Lit(vals[0] - vals[1])
        if g.fct == UMINUS:
            return Lit(-vals[0])
        if g.fct == TIMES:
            out = 1
            for v in vals:
                out *= v
            return Lit(out)
        if g.fct == DIVIDES and vals[1] != 0:
            # euclidean-style: matches SMT-LIB div and Scala's / for positives
            return Lit(vals[0] // vals[1])
        if g.fct in _CMP:
            return Lit(_CMP[g.fct](vals[0], vals[1]))
        if g.fct in (EQ, NEQ):
            return Lit((vals[0] == vals[1]) == (g.fct == EQ))
        return g

    return fmap(fn, f)


def simplify_bool(f: Formula) -> Formula:
    """Re-apply the smart constructors bottom-up (absorbs True/False,
    flattens, dedups) (Simplify.simplifyBool)."""

    def fn(g):
        if isinstance(g, Application):
            if g.fct == AND:
                seen, args = set(), []
                for a in g.args:
                    if a not in seen:
                        seen.add(a)
                        args.append(a)
                for a in args:
                    if Not(a) in seen:
                        return FALSE
                return And(*args)
            if g.fct == OR:
                seen, args = set(), []
                for a in g.args:
                    if a not in seen:
                        seen.add(a)
                        args.append(a)
                for a in args:
                    if Not(a) in seen:
                        return TRUE
                return Or(*args)
            if g.fct == NOT:
                return Not(g.args[0])
            if g.fct == IMPLIES:
                return Implies(g.args[0], g.args[1])
            if g.fct == EQ:
                return Eq(g.args[0], g.args[1])
            if g.fct == ITE:
                c, t, e = g.args
                if c == TRUE:
                    return t
                if c == FALSE:
                    return e
                if t == e:
                    return t
        return g

    return fmap(fn, f)


def simplify_quantifiers(f: Formula) -> Formula:
    """Drop unused bound variables; collapse nested same-binder bindings
    (Simplify.simplifyQuantifiers)."""

    def fn(g):
        if isinstance(g, Binding) and g.binder in (FORALL, EXISTS):
            fv = free_vars(g.body)
            vars = tuple(v for v in g.vars if v in fv)
            if not vars:
                return g.body
            body = g.body
            if isinstance(body, Binding) and body.binder == g.binder:
                vars = vars + body.vars
                body = body.body
            h = Binding(g.binder, vars, body)
            h.tpe = g.tpe
            return h
        return g

    return fmap(fn, f)


def simplify(f: Formula) -> Formula:
    """Master simplifier (Simplify.simplify): int folding, boolean
    reconstruction, quantifier cleanup, to fixpoint (bounded)."""
    prev = None
    for _ in range(8):
        if f == prev:
            break
        prev = f
        f = simplify_quantifiers(simplify_bool(simplify_int(f)))
    return f
