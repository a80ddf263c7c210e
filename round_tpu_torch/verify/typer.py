"""Unification-based type checker for formulas.

Reference parity: psync.formula.Typer (formula/Typer.scala:12-368) -- the
same HM-style flow: walk the tree generating equality constraints between
type variables, solve by Robinson unification with occurs check, then write
the solved types back into every node's ``tpe`` slot.

Port of round_tpu/verify/typer.py, copied with only the package name changed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from round_tpu_torch.verify.formula import (
    Application, Binding, Bool, COMPREHENSION, FSet, FunT, Formula,
    InterpretedFct, Literal, Product, TVar, Type, UnInterpretedFct, Variable,
    Wildcard, fresh_tvar,
)


class TypingError(Exception):
    pass


def _walk(t: Type, subst: Dict[TVar, Type]) -> Type:
    while isinstance(t, TVar) and t in subst:
        t = subst[t]
    return t


def _occurs(v: TVar, t: Type, subst) -> bool:
    t = _walk(t, subst)
    if t == v:
        return True
    if isinstance(t, FunT):
        return any(_occurs(v, a, subst) for a in t.args) or _occurs(v, t.ret, subst)
    for attr in ("elem", "key", "value"):
        if hasattr(t, attr) and _occurs(v, getattr(t, attr), subst):
            return True
    if isinstance(t, Product):
        return any(_occurs(v, a, subst) for a in t.args)
    return False


def unify(t1: Type, t2: Type, subst: Dict[TVar, Type]) -> None:
    """Destructively extend ``subst`` so that t1 == t2, or raise TypingError."""
    t1, t2 = _walk(t1, subst), _walk(t2, subst)
    if t1 == t2 or isinstance(t1, Wildcard) or isinstance(t2, Wildcard):
        return
    if isinstance(t1, TVar):
        if _occurs(t1, t2, subst):
            raise TypingError(f"occurs check: {t1!r} in {t2!r}")
        subst[t1] = t2
        return
    if isinstance(t2, TVar):
        unify(t2, t1, subst)
        return
    if type(t1) is not type(t2):
        raise TypingError(f"cannot unify {t1!r} with {t2!r}")
    if isinstance(t1, FunT):
        if len(t1.args) != len(t2.args):
            raise TypingError(f"arity mismatch: {t1!r} vs {t2!r}")
        for a, b in zip(t1.args, t2.args):
            unify(a, b, subst)
        unify(t1.ret, t2.ret, subst)
        return
    if isinstance(t1, Product):
        if len(t1.args) != len(t2.args):
            raise TypingError(f"tuple arity mismatch: {t1!r} vs {t2!r}")
        for a, b in zip(t1.args, t2.args):
            unify(a, b, subst)
        return
    for attrs in (("elem",), ("key", "value")):
        if all(hasattr(t1, a) for a in attrs):
            for a in attrs:
                unify(getattr(t1, a), getattr(t2, a), subst)
            return
    raise TypingError(f"cannot unify {t1!r} with {t2!r}")


def _resolve(t: Type, subst) -> Type:
    t = _walk(t, subst)
    if isinstance(t, FunT):
        return FunT([_resolve(a, subst) for a in t.args], _resolve(t.ret, subst))
    if isinstance(t, Product):
        return Product([_resolve(a, subst) for a in t.args])
    if isinstance(t, FSet):
        return FSet(_resolve(t.elem, subst))
    from round_tpu_torch.verify.formula import FMap, FOption

    if isinstance(t, FOption):
        return FOption(_resolve(t.elem, subst))
    if isinstance(t, FMap):
        return FMap(_resolve(t.key, subst), _resolve(t.value, subst))
    return t


def _gather(f: Formula, env: Dict[str, Type], subst, nodes: List[Formula]) -> None:
    nodes.append(f)
    if isinstance(f, Literal):
        return
    if isinstance(f, Variable):
        if f.name in env:
            unify(f.tpe, env[f.name], subst)
        else:
            # free variable: its declared tpe is the truth, record it
            env[f.name] = f.tpe
        return
    if isinstance(f, Application):
        for a in f.args:
            _gather(a, env, subst, nodes)
        ft = f.fct.instantiate_type(len(f.args))
        if len(ft.args) != len(f.args):
            raise TypingError(
                f"{f.fct.name}: expects {len(ft.args)} args, got {len(f.args)}"
            )
        for formal, actual in zip(ft.args, f.args):
            unify(formal, actual.tpe, subst)
        unify(f.tpe, ft.ret, subst)
        return
    if isinstance(f, Binding):
        inner = dict(env)
        for v in f.vars:
            inner[v.name] = v.tpe
        _gather(f.body, inner, subst, nodes)
        unify(f.body.tpe, Bool, subst)
        if f.binder == COMPREHENSION:
            if len(f.vars) == 1:
                unify(f.tpe, FSet(f.vars[0].tpe), subst)
            else:
                unify(f.tpe, FSet(Product([v.tpe for v in f.vars])), subst)
        else:
            unify(f.tpe, Bool, subst)
        return
    raise TypingError(f"unknown node {f!r}")


def typecheck(f: Formula, env: Optional[Dict[str, Type]] = None) -> Formula:
    """Type ``f`` in place (fills every node's ``tpe``); returns ``f``.

    ``env`` optionally pre-binds free-variable names to types.  Raises
    TypingError if no consistent assignment exists.
    """
    subst: Dict[TVar, Type] = {}
    nodes: List[Formula] = []
    _gather(f, dict(env or {}), subst, nodes)
    for n in nodes:
        n.tpe = _resolve(n.tpe, subst)
    return f


def is_well_typed(f: Formula, env: Optional[Dict[str, Type]] = None) -> bool:
    try:
        typecheck(f, env)
        return True
    except TypingError:
        return False
