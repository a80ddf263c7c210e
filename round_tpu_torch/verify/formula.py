"""Formula AST, types, and the interpreted-symbol catalog.

Reference parity: psync.formula.Formula (formula/Formula.scala:5-583) and
psync.formula.Types (formula/Types.scala:3-124).  Same node shapes --
Literal / Variable / Application(symbol, args) / Binding(binder, vars, body)
-- and the same symbol families: boolean connectives, integer arithmetic,
finite sets (with Cardinality), options, tuples, and maps.

Design differences from the reference (idiomatic Python, not a port):
  * Formulas are immutable value objects with structural equality/hash; the
    inferred type lives in a mutable ``tpe`` slot excluded from eq/hash
    (the reference does the same with a mutable ``tpe`` field).
  * Operator sugar (InlineOps.scala) is on the nodes themselves: ``a & b``,
    ``a | b``, ``~a``, ``a + b``, ``a < b`` build formulas.  ``==`` stays
    *structural* (so formulas can live in sets/dicts); use ``Eq(a, b)`` or
    ``a.eq(b)`` for the logical equality atom.

Port of round_tpu/verify/formula.py, copied with only the package name changed.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Types (formula/Types.scala)
# ---------------------------------------------------------------------------

class Type:
    """Base of all types.  Type-variable resolution lives in typer.py
    (_walk/_resolve); Type nodes themselves are plain immutable values."""

    __slots__ = ()


class BoolT(Type):
    def __repr__(self):
        return "Bool"

    def __eq__(self, o):
        return isinstance(o, BoolT)

    def __hash__(self):
        return hash("BoolT")


class IntT(Type):
    def __repr__(self):
        return "Int"

    def __eq__(self, o):
        return isinstance(o, IntT)

    def __hash__(self):
        return hash("IntT")


Bool = BoolT()
Int = IntT()


class FSet(Type):
    __slots__ = ("elem",)

    def __init__(self, elem: Type):
        self.elem = elem

    def __repr__(self):
        return f"Set({self.elem!r})"

    def __eq__(self, o):
        return isinstance(o, FSet) and self.elem == o.elem

    def __hash__(self):
        return hash(("FSet", self.elem))


class FOption(Type):
    __slots__ = ("elem",)

    def __init__(self, elem: Type):
        self.elem = elem

    def __repr__(self):
        return f"Option({self.elem!r})"

    def __eq__(self, o):
        return isinstance(o, FOption) and self.elem == o.elem

    def __hash__(self):
        return hash(("FOption", self.elem))


class FMap(Type):
    __slots__ = ("key", "value")

    def __init__(self, key: Type, value: Type):
        self.key = key
        self.value = value

    def __repr__(self):
        return f"Map({self.key!r},{self.value!r})"

    def __eq__(self, o):
        return isinstance(o, FMap) and self.key == o.key and self.value == o.value

    def __hash__(self):
        return hash(("FMap", self.key, self.value))


class Product(Type):
    __slots__ = ("args",)

    def __init__(self, args: Sequence[Type]):
        self.args = tuple(args)

    def __repr__(self):
        return "Product(" + ",".join(map(repr, self.args)) + ")"

    def __eq__(self, o):
        return isinstance(o, Product) and self.args == o.args

    def __hash__(self):
        return hash(("Product", self.args))


UnitT = Product(())


class FunT(Type):
    __slots__ = ("args", "ret")

    def __init__(self, args: Sequence[Type], ret: Type):
        self.args = tuple(args)
        self.ret = ret

    def __repr__(self):
        return "(" + ",".join(map(repr, self.args)) + f")->{self.ret!r}"

    def __eq__(self, o):
        return isinstance(o, FunT) and self.args == o.args and self.ret == o.ret

    def __hash__(self):
        return hash(("FunT", self.args, self.ret))


class UnInterpreted(Type):
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return self.name

    def __eq__(self, o):
        return isinstance(o, UnInterpreted) and self.name == o.name

    def __hash__(self):
        return hash(("UnInterpreted", self.name))


class TVar(Type):
    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __repr__(self):
        return f"'{self.index}"

    def __eq__(self, o):
        return isinstance(o, TVar) and self.index == o.index

    def __hash__(self):
        return hash(("TVar", self.index))


class Wildcard(Type):
    def __repr__(self):
        return "_"

    def __eq__(self, o):
        return isinstance(o, Wildcard)

    def __hash__(self):
        return hash("Wildcard")


_tvar_counter = itertools.count()


def fresh_tvar() -> TVar:
    return TVar(next(_tvar_counter))


# The process universe and round-time types (logic/CL.scala:13-16).
procType = UnInterpreted("ProcessID")
timeType = UnInterpreted("Time")


# ---------------------------------------------------------------------------
# Symbols (formula/Formula.scala:103-523)
# ---------------------------------------------------------------------------

class Symbol:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return self.name

    def instantiate_type(self, nargs: int) -> FunT:
        raise NotImplementedError

    def __eq__(self, o):
        return type(self) is type(o) and self.name == o.name

    def __hash__(self):
        return hash((type(self).__name__, self.name))


class InterpretedFct(Symbol):
    """An interpreted symbol with a (possibly polymorphic, possibly variadic)
    type scheme.  ``scheme(nargs)`` returns a *fresh* FunT instance."""

    __slots__ = ("_scheme", "fixed_arity")

    def __init__(self, name, scheme, fixed_arity=None):
        super().__init__(name)
        self._scheme = scheme
        self.fixed_arity = fixed_arity

    def instantiate_type(self, nargs: int) -> FunT:
        return self._scheme(nargs)


class UnInterpretedFct(Symbol):
    """A user/skolem function symbol with an explicit type (or None)."""

    __slots__ = ("tpe",)

    def __init__(self, name: str, tpe: Optional[FunT] = None):
        super().__init__(name)
        self.tpe = tpe

    def instantiate_type(self, nargs: int) -> FunT:
        if self.tpe is not None:
            return self.tpe
        return FunT([fresh_tvar() for _ in range(nargs)], fresh_tvar())

    def __eq__(self, o):
        return isinstance(o, UnInterpretedFct) and self.name == o.name

    def __hash__(self):
        return hash(("UFct", self.name))


def _variadic(arg_t_fn, ret_t_fn):
    def scheme(nargs):
        return FunT([arg_t_fn() for _ in range(nargs)], ret_t_fn())

    return scheme


def _mono(args, ret):
    def scheme(nargs):
        return FunT(list(args), ret)

    return scheme


def _poly(builder):
    """builder(a) -> (args, ret) with one fresh type var."""

    def scheme(nargs):
        a = fresh_tvar()
        args, ret = builder(a)
        return FunT(list(args), ret)

    return scheme


def _poly2(builder):
    def scheme(nargs):
        a, b = fresh_tvar(), fresh_tvar()
        args, ret = builder(a, b)
        return FunT(list(args), ret)

    return scheme


# Boolean connectives
NOT = InterpretedFct("Not", _mono([Bool], Bool), 1)
AND = InterpretedFct("And", _variadic(lambda: Bool, lambda: Bool))
OR = InterpretedFct("Or", _variadic(lambda: Bool, lambda: Bool))
IMPLIES = InterpretedFct("Implies", _mono([Bool, Bool], Bool), 2)

# Equality (polymorphic)
EQ = InterpretedFct("Eq", _poly(lambda a: ([a, a], Bool)), 2)
NEQ = InterpretedFct("Neq", _poly(lambda a: ([a, a], Bool)), 2)

# Integer arithmetic
PLUS = InterpretedFct("Plus", _variadic(lambda: Int, lambda: Int))
MINUS = InterpretedFct("Minus", _mono([Int, Int], Int), 2)
UMINUS = InterpretedFct("UMinus", _mono([Int], Int), 1)
TIMES = InterpretedFct("Times", _variadic(lambda: Int, lambda: Int))
DIVIDES = InterpretedFct("Divides", _mono([Int, Int], Int), 2)
LEQ = InterpretedFct("Leq", _poly(lambda a: ([a, a], Bool)), 2)
LT = InterpretedFct("Lt", _poly(lambda a: ([a, a], Bool)), 2)
GEQ = InterpretedFct("Geq", _poly(lambda a: ([a, a], Bool)), 2)
GT = InterpretedFct("Gt", _poly(lambda a: ([a, a], Bool)), 2)

# If-then-else (not in the reference AST; SSA joins play its role there.
# Kept here because TR extraction from Python round code produces joins.)
ITE = InterpretedFct("Ite", _poly(lambda a: ([Bool, a, a], a)), 3)

# Sets (Formula.scala set ops)
UNION = InterpretedFct("Union", _poly(lambda a: ([FSet(a), FSet(a)], FSet(a))), 2)
INTERSECTION = InterpretedFct(
    "Intersection", _poly(lambda a: ([FSet(a), FSet(a)], FSet(a))), 2
)
SETMINUS = InterpretedFct(
    "SetMinus", _poly(lambda a: ([FSet(a), FSet(a)], FSet(a))), 2
)
SUBSET_EQ = InterpretedFct("SubsetEq", _poly(lambda a: ([FSet(a), FSet(a)], Bool)), 2)
IN = InterpretedFct("In", _poly(lambda a: ([a, FSet(a)], Bool)), 2)
CARD = InterpretedFct("Cardinality", _poly(lambda a: ([FSet(a)], Int)), 1)
EMPTYSET = InterpretedFct("EmptySet", _poly(lambda a: ([], FSet(a))), 0)

# Options
FSOME = InterpretedFct("Some", _poly(lambda a: ([a], FOption(a))), 1)
FNONE_SYM = InterpretedFct("None", _poly(lambda a: ([], FOption(a))), 0)
IS_DEFINED = InterpretedFct("IsDefined", _poly(lambda a: ([FOption(a)], Bool)), 1)
GET = InterpretedFct("Get", _poly(lambda a: ([FOption(a)], a)), 1)

# Tuples (pairs/triples, like Fst/Snd/Trd in the reference)
def _tuple_scheme(nargs):
    ts = [fresh_tvar() for _ in range(nargs)]
    return FunT(ts, Product(ts))


TUPLE = InterpretedFct("Tuple", _tuple_scheme)
FST = InterpretedFct("Fst", _poly2(lambda a, b: ([Product((a, b))], a)), 1)
SND = InterpretedFct("Snd", _poly2(lambda a, b: ([Product((a, b))], b)), 1)


def _trd_scheme(nargs):
    a, b, c = fresh_tvar(), fresh_tvar(), fresh_tvar()
    return FunT([Product((a, b, c))], c)


TRD = InterpretedFct("Trd", _trd_scheme, 1)

# Maps (Formula.scala map ops)
KEYSET = InterpretedFct("KeySet", _poly2(lambda k, v: ([FMap(k, v)], FSet(k))), 1)
LOOKUP = InterpretedFct("LookUp", _poly2(lambda k, v: ([FMap(k, v), k], v)), 2)
IS_DEFINED_AT = InterpretedFct(
    "IsDefinedAt", _poly2(lambda k, v: ([FMap(k, v), k], Bool)), 2
)
MSIZE = InterpretedFct("Size", _poly2(lambda k, v: ([FMap(k, v)], Int)), 1)
UPDATED = InterpretedFct(
    "Updated", _poly2(lambda k, v: ([FMap(k, v), k, v], FMap(k, v))), 3
)

INTERPRETED = [
    NOT, AND, OR, IMPLIES, EQ, NEQ, PLUS, MINUS, UMINUS, TIMES, DIVIDES,
    LEQ, LT, GEQ, GT, ITE, UNION, INTERSECTION, SETMINUS, SUBSET_EQ, IN,
    CARD, EMPTYSET, FSOME, FNONE_SYM, IS_DEFINED, GET, TUPLE, FST, SND, TRD,
    KEYSET, LOOKUP, IS_DEFINED_AT, MSIZE, UPDATED,
]
SYMBOL_BY_NAME = {s.name: s for s in INTERPRETED}


# ---------------------------------------------------------------------------
# Formula nodes (formula/Formula.scala:5-96)
# ---------------------------------------------------------------------------

class Formula:
    __slots__ = ("tpe", "_hash")

    # -- operator sugar (InlineOps.scala) -----------------------------------
    def __and__(self, o):
        return And(self, o)

    def __or__(self, o):
        return Or(self, o)

    def __invert__(self):
        return Not(self)

    def __rshift__(self, o):  # a >> b  ==  a ==> b
        return Implies(self, o)

    def __add__(self, o):
        return Application(PLUS, [self, _lift(o)])

    def __radd__(self, o):
        return Application(PLUS, [_lift(o), self])

    def __sub__(self, o):
        return Application(MINUS, [self, _lift(o)])

    def __rsub__(self, o):
        return Application(MINUS, [_lift(o), self])

    def __mul__(self, o):
        return Application(TIMES, [self, _lift(o)])

    def __rmul__(self, o):
        return Application(TIMES, [_lift(o), self])

    def __floordiv__(self, o):
        return Application(DIVIDES, [self, _lift(o)])

    def __lt__(self, o):
        return Lt(self, _lift(o))

    def __le__(self, o):
        return Leq(self, _lift(o))

    def __gt__(self, o):
        return Gt(self, _lift(o))

    def __ge__(self, o):
        return Geq(self, _lift(o))

    def eq(self, o):
        return Eq(self, _lift(o))

    def neq(self, o):
        return Neq(self, _lift(o))

    def in_(self, s):
        return Application(IN, [self, s])

    @property
    def card(self):
        return Application(CARD, [self])

    def with_type(self, t: Type) -> "Formula":
        self.tpe = t
        return self


class Literal(Formula):
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value
        self.tpe = Bool if isinstance(value, bool) else Int
        self._hash = None

    def __repr__(self):
        return repr(self.value)

    def __eq__(self, o):
        return isinstance(o, Literal) and self.value == o.value \
            and type(self.value) is type(o.value)

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(("Lit", self.value))
        return self._hash


TRUE = Literal(True)
FALSE = Literal(False)


def IntLit(v: int) -> Literal:
    return Literal(int(v))


def _lift(x):
    if isinstance(x, Formula):
        return x
    if isinstance(x, bool):
        return Literal(x)
    if isinstance(x, int):
        return Literal(x)
    raise TypeError(f"cannot lift {x!r} into a formula")


class Variable(Formula):
    __slots__ = ("name",)

    def __init__(self, name: str, tpe: Optional[Type] = None):
        self.name = name
        self.tpe = tpe if tpe is not None else fresh_tvar()
        self._hash = None

    def __repr__(self):
        return self.name

    def __eq__(self, o):
        return isinstance(o, Variable) and self.name == o.name

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(("Var", self.name))
        return self._hash


class Application(Formula):
    __slots__ = ("fct", "args")

    def __init__(self, fct: Symbol, args: Iterable[Formula]):
        self.fct = fct
        self.args = tuple(args)
        self.tpe = fresh_tvar()
        self._hash = None
        if fct.__class__ is InterpretedFct and fct.fixed_arity is not None:
            assert len(self.args) == fct.fixed_arity, (
                f"{fct.name} expects {fct.fixed_arity} args, got {len(self.args)}"
            )

    def __repr__(self):
        return f"{self.fct.name}({', '.join(map(repr, self.args))})"

    def __eq__(self, o):
        return (
            isinstance(o, Application)
            and self.fct == o.fct
            and self.args == o.args
        )

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(("App", self.fct, self.args))
        return self._hash


FORALL = "ForAll"
EXISTS = "Exists"
COMPREHENSION = "Comprehension"


class Binding(Formula):
    __slots__ = ("binder", "vars", "body")

    def __init__(self, binder: str, vars: Sequence[Variable], body: Formula):
        assert binder in (FORALL, EXISTS, COMPREHENSION)
        self.binder = binder
        self.vars = tuple(vars)
        self.body = body
        self.tpe = fresh_tvar()
        self._hash = None

    def __repr__(self):
        vs = ", ".join(v.name for v in self.vars)
        if self.binder == COMPREHENSION:
            return f"{{ {vs} | {self.body!r} }}"
        sym = "forall" if self.binder == FORALL else "exists"
        return f"({sym} {vs}. {self.body!r})"

    def __eq__(self, o):
        return (
            isinstance(o, Binding)
            and self.binder == o.binder
            and self.vars == o.vars
            and self.body == o.body
        )

    def __hash__(self):
        if self._hash is None:
            self._hash = hash(("Bind", self.binder, self.vars, self.body))
        return self._hash


# ---------------------------------------------------------------------------
# Smart constructors (flattening / simplifying, Formula.scala companion)
# ---------------------------------------------------------------------------

def And(*args) -> Formula:
    flat = []
    for a in args:
        a = _lift(a)
        if isinstance(a, Application) and a.fct == AND:
            flat.extend(a.args)
        elif a == TRUE:
            continue
        elif a == FALSE:
            return FALSE
        else:
            flat.append(a)
    if not flat:
        return TRUE
    if len(flat) == 1:
        return flat[0]
    return Application(AND, flat)


def Or(*args) -> Formula:
    flat = []
    for a in args:
        a = _lift(a)
        if isinstance(a, Application) and a.fct == OR:
            flat.extend(a.args)
        elif a == FALSE:
            continue
        elif a == TRUE:
            return TRUE
        else:
            flat.append(a)
    if not flat:
        return FALSE
    if len(flat) == 1:
        return flat[0]
    return Application(OR, flat)


def Not(f) -> Formula:
    f = _lift(f)
    if isinstance(f, Literal) and isinstance(f.value, bool):
        return Literal(not f.value)
    if isinstance(f, Application) and f.fct == NOT:
        return f.args[0]
    return Application(NOT, [f])


def Implies(a, b) -> Formula:
    a, b = _lift(a), _lift(b)
    if a == TRUE:
        return b
    if a == FALSE or b == TRUE:
        return TRUE
    if b == FALSE:
        return Not(a)
    return Application(IMPLIES, [a, b])


def Eq(a, b) -> Formula:
    a, b = _lift(a), _lift(b)
    if a == b:
        return TRUE
    return Application(EQ, [a, b])


def Neq(a, b) -> Formula:
    a, b = _lift(a), _lift(b)
    if a == b:
        return FALSE
    return Application(NEQ, [a, b])


def Lt(a, b):
    return Application(LT, [_lift(a), _lift(b)])


def Leq(a, b):
    return Application(LEQ, [_lift(a), _lift(b)])


def Gt(a, b):
    return Application(GT, [_lift(a), _lift(b)])


def Geq(a, b):
    return Application(GEQ, [_lift(a), _lift(b)])


def Ite(c, t, e):
    return Application(ITE, [_lift(c), _lift(t), _lift(e)])


def Plus(*args):
    return Application(PLUS, [_lift(a) for a in args])


def Times(*args):
    return Application(TIMES, [_lift(a) for a in args])


def Minus(a, b):
    return Application(MINUS, [_lift(a), _lift(b)])


def Card(s):
    return Application(CARD, [s])


def In(x, s):
    return Application(IN, [_lift(x), s])


def SubsetEq(a, b):
    return Application(SUBSET_EQ, [a, b])


def Union(a, b):
    return Application(UNION, [a, b])


def Intersection(a, b):
    return Application(INTERSECTION, [a, b])


def FSome(x):
    return Application(FSOME, [_lift(x)])


def FNone(elem_t: Optional[Type] = None):
    f = Application(FNONE_SYM, [])
    if elem_t is not None:
        f.tpe = FOption(elem_t)
    return f


def ForAll(vars, body) -> Formula:
    vars = tuple(vars)
    if not vars:
        return _lift(body)
    return Binding(FORALL, vars, _lift(body))


def Exists(vars, body) -> Formula:
    vars = tuple(vars)
    if not vars:
        return _lift(body)
    return Binding(EXISTS, vars, _lift(body))


def Comprehension(vars, body) -> Formula:
    """{ x | body }: a set defined by a predicate (Binding(Comprehension,...))."""
    vars = tuple(vars)
    assert vars
    c = Binding(COMPREHENSION, vars, _lift(body))
    if len(vars) == 1:
        c.tpe = FSet(vars[0].tpe)
    else:
        c.tpe = FSet(Product([v.tpe for v in vars]))
    return c
