"""Formula traversals, substitution, and collection utilities.

Reference parity: psync.formula.FormulaUtils (formula/FormulaUtils.scala:80-369)
and the Traverser/Transformer machinery (formula/Transforms.scala:29-214).
In Python, higher-order functions replace the visitor-class hierarchy.

Port of round_tpu/verify/futils.py, copied with only the package name changed.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from round_tpu_torch.verify.formula import (
    AND, Application, Binding, COMPREHENSION, EXISTS, FORALL, Formula,
    Literal, NOT, OR, Symbol, Variable,
)


def fmap(fn: Callable[[Formula], Formula], f: Formula) -> Formula:
    """Bottom-up map: rebuild ``f`` applying ``fn`` at every node
    (FormulaUtils.map).  ``fn`` sees already-mapped children."""
    if isinstance(f, (Literal, Variable)):
        return fn(f)
    if isinstance(f, Application):
        args = [fmap(fn, a) for a in f.args]
        g = Application(f.fct, args)
        g.tpe = f.tpe
        return fn(g)
    if isinstance(f, Binding):
        body = fmap(fn, f.body)
        vars = [fn(v) for v in f.vars]
        g = Binding(f.binder, vars, body)
        g.tpe = f.tpe
        return fn(g)
    raise TypeError(f"unknown node {f!r}")


def traverse(fn: Callable[[Formula], None], f: Formula) -> None:
    fn(f)
    if isinstance(f, Application):
        for a in f.args:
            traverse(fn, a)
    elif isinstance(f, Binding):
        for v in f.vars:
            fn(v)
        traverse(fn, f.body)


def free_vars(f: Formula) -> Set[Variable]:
    """Free variables (FormulaUtils, Binding-aware)."""
    if isinstance(f, Literal):
        return set()
    if isinstance(f, Variable):
        return {f}
    if isinstance(f, Application):
        out: Set[Variable] = set()
        for a in f.args:
            out |= free_vars(a)
        return out
    if isinstance(f, Binding):
        return free_vars(f.body) - set(f.vars)
    raise TypeError(f"unknown node {f!r}")


def collect_symbols(f: Formula) -> Set[Symbol]:
    out: Set[Symbol] = set()

    def go(g):
        if isinstance(g, Application):
            out.add(g.fct)

    traverse(go, f)
    return out


def collect(pred: Callable[[Formula], bool], f: Formula) -> List[Formula]:
    out: List[Formula] = []

    def go(g):
        if pred(g):
            out.append(g)

    traverse(go, f)
    return out


def collect_ground_terms(f: Formula) -> Set[Formula]:
    """All subterms containing no (locally) bound variable — the candidates
    for quantifier instantiation (FormulaUtils.collectGroundTerms)."""
    out: Set[Formula] = set()

    from round_tpu_torch.verify.formula import BoolT

    def go(g: Formula, bound: frozenset) -> bool:
        """returns: is g ground wrt `bound`?"""
        if isinstance(g, Literal):
            return True
        if isinstance(g, Variable):
            if g not in bound:
                out.add(g)
                return True
            return False
        if isinstance(g, Application):
            ground = all([go(a, bound) for a in g.args])
            if ground and not isinstance(g.tpe, BoolT):
                out.add(g)
            return ground
        if isinstance(g, Binding):
            go(g.body, bound | frozenset(g.vars))
            return False
        return False

    go(f, frozenset())
    return out


def get_conjuncts(f: Formula) -> List[Formula]:
    if isinstance(f, Application) and f.fct == AND:
        out: List[Formula] = []
        for a in f.args:
            out.extend(get_conjuncts(a))
        return out
    return [f]


def get_disjuncts(f: Formula) -> List[Formula]:
    if isinstance(f, Application) and f.fct == OR:
        out: List[Formula] = []
        for a in f.args:
            out.extend(get_disjuncts(a))
        return out
    return [f]


def subst_vars(f: Formula, m: Dict[Variable, Formula]) -> Formula:
    """Capture-avoiding substitution of variables by formulas (Alpha +
    Mapper in Transforms.scala)."""
    if not m:
        return f
    if isinstance(f, Literal):
        return f
    if isinstance(f, Variable):
        return m.get(f, f)
    if isinstance(f, Application):
        g = Application(f.fct, [subst_vars(a, m) for a in f.args])
        g.tpe = f.tpe
        return g
    if isinstance(f, Binding):
        m2 = {k: v for k, v in m.items() if k not in f.vars}
        # capture check: if a replacement mentions a bound var, rename it
        clash = set()
        for v in m2.values():
            clash |= free_vars(v) & set(f.vars)
        if clash:
            ren = {v: fresh_variable(v) for v in clash}
            body = subst_vars(f.body, dict(ren))
            vars = [ren.get(v, v) for v in f.vars]
        else:
            body, vars = f.body, list(f.vars)
        g = Binding(f.binder, vars, subst_vars(body, m2))
        g.tpe = f.tpe
        return g
    raise TypeError(f"unknown node {f!r}")


_fresh_counter = itertools.count()


def fresh_variable(like: Variable, prefix: Optional[str] = None) -> Variable:
    base = prefix or like.name.split("$")[0]
    return Variable(f"{base}${next(_fresh_counter)}", like.tpe)


def _rename_bound(f: Formula, make_name: Callable[[Variable], Variable]) -> Formula:
    """Rebuild ``f`` with every bound variable renamed via ``make_name``."""

    def go(g: Formula, ren: Dict[Variable, Variable]) -> Formula:
        if isinstance(g, Literal):
            return g
        if isinstance(g, Variable):
            return ren.get(g, g)
        if isinstance(g, Application):
            h = Application(g.fct, [go(a, ren) for a in g.args])
            h.tpe = g.tpe
            return h
        if isinstance(g, Binding):
            ren2 = dict(ren)
            vars = []
            for v in g.vars:
                nv = make_name(v)
                ren2[v] = nv
                vars.append(nv)
            h = Binding(g.binder, vars, go(g.body, ren2))
            h.tpe = g.tpe
            return h
        raise TypeError(f"unknown node {g!r}")

    return go(f, {})


def alpha_all(f: Formula) -> Formula:
    """Make every bound variable unique (Simplify.boundVarUnique)."""
    return _rename_bound(f, fresh_variable)


def alpha_normalize(f: Formula) -> Formula:
    """De-Bruijn-style canonical renaming of bound variables so that
    alpha-equivalent formulas compare equal (Simplify.deBruijnIndex).
    Bound vars are renamed to _b0, _b1, ... in traversal order."""
    counter = itertools.count()
    return _rename_bound(f, lambda v: Variable(f"_b{next(counter)}", v.tpe))


def replace(f: Formula, old: Formula, new: Formula) -> Formula:
    """Replace every occurrence of subterm ``old`` by ``new``."""
    def fn(g):
        return new if g == old else g

    return fmap(fn, f)


def comprehensions(f: Formula) -> List[Binding]:
    return [
        g for g in collect(lambda g: isinstance(g, Binding), f)
        if g.binder == COMPREHENSION
    ]
