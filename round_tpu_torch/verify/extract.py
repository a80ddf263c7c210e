"""Transition-relation extraction from executable torch round code.

Port of round_tpu/verify/extract.py.  This is the macro layer's
counterpart (reference: psync.macros — Macros.scala:65-77,
TrExtractor.scala:101-160, FormulaExtractor.scala).  The reference rewrites
Scala ASTs with whitebox macros; round_tpu traces the *same function the
engine executes* to a jaxpr.  The port traces the same torch function the
port's engine executes to an aten graph
(``torch.fx.experimental.proxy_tensor.make_fx`` over a functionalized
function, so in-place ops trace as pure ones) and abstractly interprets
the graph over Formula values, producing the update/send equations of a
RoundTR.  The abstract domain, the Formula builders and the site axioms
are round_tpu's; only the graph source differs.

Domain of the abstract interpreter:
  * scalar slots  → a Formula over the receiver j (state fields are the
    localized functions f(j), tr.py),
  * mailbox slots → per-sender functions i ↦ Formula (payload fns), with
    the mask slot i ↦ (i ∈ HO(j) ∧ dest(i, j)),
  * reductions over the sender axis → comprehension forms:
      sum(bool mask)   → Cardinality{ i | … }      (mbox.count)
      any/or           → ∃ i ∈ senders. …
      all/and          → ∀ i ∈ senders. …

Like the reference (RoundRewrite.scala:48-50 warns EventRound extraction is
unsupported; complex helpers become AuxiliaryMethods with pre/post specs),
an unsupported aten op raises ExtractionError naming the op — the
algorithm then supplies that piece as an axiomatized auxiliary function
(tr.py RoundTR.aux, or an @aux_method helper, verify/auxmethod.py).

What the aten graph changes against a jaxpr:
  * ``n`` stays symbolic only as a 0-d tensor; a host read of a traced
    tensor (``.item()``, ``int(t)``, ``if t:``) would specialise the trace,
    and make_fx refuses it — surfaced here as an ExtractionError;
  * torch records ``k * x`` and ``x * k`` alike as ``mul(x, k)``: a product
    with a constant factor is built constant first, ``Times(k, x)``, as the
    round code writes it (``2 * n``);
  * ``sort`` returns values and indices; only the values may be read;
  * ``//`` is ``floor_divide`` (or ``div`` with ``rounding_mode="floor"``)
    and maps straight to the floor-div symbol, ``%`` to floor-mod — the
    shortcuts round_tpu takes on jnp's named ``floor_divide``/``remainder``
    pjits.
"""

from __future__ import annotations

import itertools
import operator
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from round_tpu_torch.verify.formula import (
    And, Application, Binding, Bool, BoolT, Card, Comprehension, Eq, Exists,
    ForAll, Formula, FunT, Geq, Gt, Implies, IntLit, IntT, Ite, Leq, Literal,
    Lt, Neq, Not, Or, Plus, Times, Minus, Type, UnInterpretedFct, Variable,
    procType,
)

Int = IntT()


class ExtractionError(Exception):
    """An aten op outside the supported fragment was traced.  Provide the
    enclosing computation as an axiomatized auxiliary instead
    (RoundTR.aux; the reference's AuxiliaryMethod.scala:9-67)."""


# -- abstract values --------------------------------------------------------

class Scalar:
    """A per-receiver scalar: one Formula."""

    __slots__ = ("f",)

    def __init__(self, f: Formula):
        self.f = f


class Vec:
    """A per-sender vector: i ↦ Formula (the sender axis of the mailbox)."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[Formula], Formula]):
        self.fn = fn


class Vec2:
    """A process×process matrix: (row, col) ↦ Formula — e.g. the sender
    equality matrix vals[:, None] == vals[None, :] of the executable mmor
    (ops/mailbox.py).  Rows/cols are both process-indexed."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[Formula, Formula], Formula]):
        self.fn = fn


class RankVec:
    """A vector indexed by POSITION/RANK (Int), not by process: the output
    of `sort` and anything derived from a non-process-length iota (the
    ε-model's selection indices over the sorted [2n] vector).  Reductions
    over a RankVec have no senders-domain guard and are kept OPAQUE
    (unaxiomatized sites) — the order-statistics axioms live on the sort
    site itself."""

    __slots__ = ("fn",)

    def __init__(self, fn: Callable[[Formula], Formula]):
        self.fn = fn


class ConcatVec:
    """concatenate([process-domain Vec, uniform pad]) — the ε-model's
    mailbox ++ halted layout with the halted half constant: base(i) over
    procType plus (symbolically) n copies of `pad`."""

    __slots__ = ("fn", "pad")

    def __init__(self, fn: Callable[[Formula], Formula], pad: Formula):
        self.fn = fn
        self.pad = pad


_ABS = (Scalar, Vec, Vec2, RankVec, ConcatVec)


class _Multi:
    """The tuple result of a multi-output aten op (``sort``, ``max.dim``).
    Each part is built only when a ``getitem`` reads it, so an unread part
    adds no site and no axiom; a part that must not be read raises."""

    __slots__ = ("parts", "done")

    def __init__(self, parts: Sequence[Callable[[], Any]]):
        self.parts = list(parts)
        self.done: Dict[int, Any] = {}

    def get(self, k: int):
        if k not in self.done:
            self.done[k] = self.parts[k]()
        return self.done[k]

# f32 ±inf mask sentinels, abstracted into the Int value order as opaque
# constants; the sort site emits the (f32-sound) dominance axiom
# ∀i. v(i) ≤ INF when it sees one as its padding
_INF_F = Application(
    UnInterpretedFct("float!inf", FunT([], Int)), []
).with_type(Int)
_NEG_INF_F = Application(
    UnInterpretedFct("float!neginf", FunT([], Int)), []
).with_type(Int)
# float division routes through _BINOPS' DIVIDES like integer div: with a
# non-constant divisor it stays uninterpreted (sound — the ε midpoint mean
# is opaque downstream; cl's floor axioms only attach to constant divisors)


def _lift(v) -> "Scalar | Vec":
    if isinstance(v, _ABS):
        return v
    if isinstance(v, torch.Tensor):
        # a constant the trace captured (a closed-over tensor)
        return _lift(v.detach().cpu().numpy())
    if isinstance(v, (bool, np.bool_)):
        return Scalar(Literal(bool(v)))
    if isinstance(v, (int, np.integer)):
        return Scalar(IntLit(int(v)))
    if isinstance(v, (float, np.floating)):
        if np.isposinf(v):
            return Scalar(_INF_F)
        if np.isneginf(v):
            return Scalar(_NEG_INF_F)
        if float(v) == int(v):
            return Scalar(IntLit(int(v)))
        raise ExtractionError(
            f"cannot lift non-integral float constant {v!r} (the int/bool "
            "fragment abstracts float payloads to their order)"
        )
    if isinstance(v, np.ndarray) and v.ndim == 0:
        if v.dtype == np.bool_:
            return Scalar(Literal(bool(v)))
        if np.issubdtype(v.dtype, np.floating):
            return _lift(float(v))
        return Scalar(IntLit(int(v)))
    if isinstance(v, np.ndarray) and v.ndim == 1 and v.size > 0:
        first = v[0]
        if bool((v == first).all()):  # uniform constant vector
            return Vec(lambda i, s=_lift(first): s.f)
    raise ExtractionError(f"cannot lift constant {v!r} into a formula")


def _elem_fn(v):
    return (lambda i: v.f) if isinstance(v, Scalar) else v.fn


def _binop(mk, a, b):
    a, b = _lift(a), _lift(b)
    if isinstance(a, Scalar) and isinstance(b, Scalar):
        return Scalar(mk(a.f, b.f))
    if isinstance(a, Vec2) or isinstance(b, Vec2):
        fa = _as2(a)
        fb = _as2(b)
        return Vec2(lambda r, c: mk(fa(r, c), fb(r, c)))
    if isinstance(a, ConcatVec) or isinstance(b, ConcatVec):
        if isinstance(a, (Vec, RankVec)) or isinstance(b, (Vec, RankVec)):
            raise ExtractionError("binop mixing concat and plain vectors")
        pa = a.f if isinstance(a, Scalar) else a.pad
        pb = b.f if isinstance(b, Scalar) else b.pad
        fa, fb = _elem_fn(a), _elem_fn(b)
        return ConcatVec(lambda i: mk(fa(i), fb(i)), mk(pa, pb))
    if isinstance(a, RankVec) or isinstance(b, RankVec):
        if isinstance(a, Vec) or isinstance(b, Vec):
            raise ExtractionError(
                "binop mixing rank-domain and process-domain vectors")
        fa, fb = _elem_fn(a), _elem_fn(b)
        return RankVec(lambda i: mk(fa(i), fb(i)))
    fa = (lambda i: a.f) if isinstance(a, Scalar) else a.fn
    fb = (lambda i: b.f) if isinstance(b, Scalar) else b.fn
    return Vec(lambda i: mk(fa(i), fb(i)))


def _as2(v):
    """View any abstract value as a (row, col) function.  Operands of a
    rank-2 result are oriented from their shapes first
    (``_Interpreter._orient``); a bare Vec left here defaults to rows."""
    if isinstance(v, Scalar):
        return lambda r, c: v.f
    if isinstance(v, Vec):
        return lambda r, c: v.fn(r)
    return v.fn


def _unop(mk, a):
    a = _lift(a)
    if isinstance(a, Scalar):
        return Scalar(mk(a.f))
    if isinstance(a, Vec2):
        return Vec2(lambda r, c: mk(a.fn(r, c)))
    if isinstance(a, ConcatVec):
        return ConcatVec(lambda i: mk(a.fn(i)), mk(a.pad))
    if isinstance(a, RankVec):
        return RankVec(lambda i: mk(a.fn(i)))
    return Vec(lambda i: mk(a.fn(i)))


def _idiv(x, y):
    from round_tpu_torch.verify.formula import DIVIDES
    return Application(DIVIDES, [x, y]).with_type(Int)


def _imod(x, y):
    """Floor-mod via the floor-div symbol: x mod y = x − y·(x div y).

    When the divisor is a positive constant, cl._eliminate_int_div's floor
    axioms (k·q ≤ x ≤ k·q + k − 1) make this exactly torch.remainder.
    With a *symbolic* divisor (the coordinator arithmetic's `% n`) DIVIDES
    stays uninterpreted — the axioms would be nonlinear — so the term is a
    sound over-approximation usable only up to congruence (enough for "j is
    the coordinator" hypotheses; NOT enough to derive 0 ≤ coord < n)."""
    return Minus(x, Times(y, _idiv(x, y)))


ID_TO_P = UnInterpretedFct("idToP", FunT([Int], procType))
P_TO_ID = UnInterpretedFct("pToId", FunT([procType], Int))


def _coerce_proc(x, y):
    """The runtime compares int32 lane ids against id arithmetic (e.g.
    ctx.id == (r // 4) % n, LastVoting.scala:95); formula-land keeps
    ProcessID opaque, so the Int side is wrapped in the uninterpreted
    idToP — the reference's SpecHelper.idToP ghost op (Specs.scala:28-41)."""
    tx, ty = getattr(x, "tpe", None), getattr(y, "tpe", None)
    if tx == procType and ty != procType:
        return x, Application(ID_TO_P, [y]).with_type(procType)
    if ty == procType and tx != procType:
        return Application(ID_TO_P, [x]).with_type(procType), y
    return x, y


def _to_int(x):
    """Move a ProcessID-typed term into the Int domain via the
    uninterpreted pToId (lane ids ARE ints 0..n-1 in the runtime; the
    extractor emits ∀p. pToId(p) ≥ 0 whenever pToId appears — see
    extract_lane_fn).  The sender-id tie-break reductions (FoldRound
    reduce forms: torch.where(mask, arange, -1) + max/argmax) need this:
    they order lane ids against the -1 sentinel."""
    if getattr(x, "tpe", None) == procType:
        return Application(P_TO_ID, [x]).with_type(Int)
    return x


def _coerce_order(mk):
    """Order/arithmetic binop with proc→Int coercion on either side."""
    return lambda x, y: mk(_to_int(x), _to_int(y))


_BINOPS = {
    "add": lambda x, y: Plus(x, y),
    "sub": lambda x, y: Minus(x, y),
    "mul": lambda x, y: Times(x, y),
    "div": _idiv,  # integer floor-div; cl._eliminate_int_div linearizes it
    "max": None,  # handled in interpreter (Ite form)
    "min": None,
    "lt": _coerce_order(lambda x, y: Lt(x, y)),
    "le": _coerce_order(lambda x, y: Leq(x, y)),
    "gt": _coerce_order(lambda x, y: Gt(x, y)),
    "ge": _coerce_order(lambda x, y: Geq(x, y)),
    "eq": lambda x, y: Eq(*_coerce_proc(x, y)),
    "ne": lambda x, y: Neq(*_coerce_proc(x, y)),
    "and": lambda x, y: And(x, y),
    "or": lambda x, y: Or(x, y),
    "xor": lambda x, y: Neq(x, y),
}


# aten ops that only change dtype, layout or a size-1 axis
_ADAPTERS = frozenset({
    "_to_copy", "clone", "alias", "alias_copy", "lift_fresh_copy",
    "lift_fresh", "detach", "detach_copy", "view", "view_copy",
    "_unsafe_view", "reshape", "squeeze", "squeeze_copy", "unsqueeze",
    "unsqueeze_copy", "contiguous",
})

# aten ops making a uniform constant tensor: op → its fill value
_FILLS = {
    "scalar_tensor": lambda a: a[0],
    "full": lambda a: a[1],
    "full_like": lambda a: a[1],
    "new_full": lambda a: a[2],
    "zeros": lambda a: 0,
    "zeros_like": lambda a: 0,
    "new_zeros": lambda a: 0,
    "ones": lambda a: 1,
    "ones_like": lambda a: 1,
    "new_ones": lambda a: 1,
}

# aten binary ops → the _BINOPS entry of the jaxpr primitive they replace
_ATEN_BINOPS = {
    "add": "add", "sub": "sub", "mul": "mul", "floor_divide": "div",
    "lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne",
    "bitwise_and": "and", "logical_and": "and",
    "bitwise_or": "or", "logical_or": "or",
    "bitwise_xor": "xor", "logical_xor": "xor",
}

# aten reductions → the reduce_<kind> primitive they replace
_REDUCTIONS = {"sum": "sum", "any": "or", "all": "and", "amax": "max",
               "amin": "min"}


def _shape_of(a) -> Tuple[int, ...]:
    """The traced shape of a graph argument (a python scalar is 0-d)."""
    val = a.meta.get("val") if isinstance(a, torch.fx.Node) else None
    return tuple(val.shape) if isinstance(val, torch.Tensor) else ()


def _dtype_of(a):
    val = a.meta.get("val") if isinstance(a, torch.fx.Node) else None
    return val.dtype if isinstance(val, torch.Tensor) else None


class _Interpreter:
    def __init__(
        self,
        senders_domain: Callable[[Formula], Formula],
        receiver: Optional[Formula] = None,
        proc_len: Optional[int] = None,
    ):
        """senders_domain(i): the guard restricting mailbox reductions —
        i ∈ HO(j) ∧ dest(i, j) (the mailboxLink semantics).  Pass
        ``lambda i: Literal(True)`` when the executable code applies its
        mask explicitly (the Mailbox-method style), so raw vector reductions
        range over the whole process domain.

        `receiver` is the receiver variable j; axiomatized site functions
        created for max/min/argmax reductions are parameterized on it and
        their defining axioms accumulate in ``self.axioms``
        (the AuxiliaryMethod mechanism, AuxiliaryMethod.scala:9-67)."""
        self.senders = senders_domain
        self.receiver = receiver if receiver is not None else \
            Variable("extj", procType)
        # the example trace's process-axis length: distinguishes the lane-id
        # iota (process domain) from rank-domain index vectors
        self.proc_len = proc_len
        self.axioms: List[Formula] = []
        # pre-condition obligations of @aux_method call sites: the verifier
        # must discharge these (invariants ⊢ pre), mirroring the
        # reference's AuxiliaryMethod VC class
        self.obligations: List[Formula] = []
        self._fresh = itertools.count()

    def var(self) -> Variable:
        return Variable(f"ext!{next(self._fresh)}", procType)

    def run(self, gm, args):
        """Interpret the aten graph of ``gm`` (a make_fx GraphModule) over the
        flat abstract ``args``, one per placeholder; returns the flat
        outputs (round_tpu/verify/extract.py::_Interpreter.run over a
        jaxpr)."""
        env: Dict[Any, Any] = {}
        flat = iter(args)

        def read(a):
            if isinstance(a, torch.fx.Node):
                return env[a]
            if isinstance(a, (list, tuple)):
                return type(a)(read(x) for x in a)
            return a

        out = None
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(flat)
            elif node.op == "get_attr":
                # a tensor the trace captured: a constant, lifted as a jaxpr
                # constvar is (0-d → Scalar; else kept raw until used)
                c = getattr(gm, node.target).detach().cpu().numpy()
                env[node] = _lift(c) if c.ndim == 0 else c
            elif node.op == "call_function":
                ins = [read(x) for x in node.args]
                if node.target is operator.getitem:
                    base = ins[0]
                    if not isinstance(base, _Multi):
                        raise ExtractionError("getitem of a single value")
                    env[node] = base.get(ins[1])
                else:
                    env[node] = self.eval_op(node, ins)
            elif node.op == "output":
                out = pytree.tree_leaves(
                    read(node.args[0]),
                    is_leaf=lambda x: isinstance(x, _ABS + (_Multi,)))
            else:
                raise ExtractionError(f"unsupported graph node {node.op}")
        return out

    # -- site functions (axiomatized reduction results) --------------------

    def _aux_call(self, spec, node, ins):
        """An @aux_method helper call: model it as an uninterpreted
        application over the argument formulas, assume its post, record its
        pre as a proof obligation (AuxiliaryMethod.scala:9-67;
        TransitionRelation.scala:93-111 inlines posts the same way)."""
        args = []
        for a in ins:
            a = _lift(a) if not isinstance(a, (Scalar, Vec, Vec2)) else a
            if not isinstance(a, Scalar):
                raise ExtractionError(
                    f"aux method '{spec.name}' with a non-scalar argument — "
                    "only per-lane scalar helpers are liftable"
                )
            args.append(a.f)
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor) or val.dim() != 0:
            raise ExtractionError(
                f"aux method '{spec.name}' must return one scalar"
            )
        dt = val.dtype
        if dt.is_floating_point or dt.is_complex:
            # an Int-typed site over a float value would hand integer
            # arithmetic to the reducer for a fractional runtime quantity
            raise ExtractionError(
                f"aux method '{spec.name}' returns dtype {dt}; the formula "
                "fragment is int/bool-only"
            )
        out_t = Bool if dt == torch.bool else Int
        arg_ts = [getattr(a, "tpe", None) or Int for a in args]
        fct = UnInterpretedFct(f"aux!{spec.name}", FunT(arg_ts, out_t))
        result = Application(fct, list(args)).with_type(out_t)
        if spec.post is not None:
            self.axioms.append(spec.post(result, *args))
        if spec.pre is not None:
            self.obligations.append(spec.pre(*args))
        return Scalar(result)

    def _site(self, tag: str, tpe: Type) -> Formula:
        """A fresh uninterpreted per-receiver function for a reduction site:
        site(j).  Its semantics are pinned by axioms in self.axioms."""
        k = next(self._fresh)
        fct = UnInterpretedFct(f"ext!{tag}!{k}", FunT([procType], tpe))
        return Application(fct, [self.receiver]).with_type(tpe)

    def _sort_site(self, op):
        """Order statistics as a DECLARED primitive (the sort/drop-f/select
        step of Epsilon.scala:34-62): the sorted vector becomes a fresh
        rank-indexed function ord(j, k) pinned by the exact multiset
        characterization —

          S1 (sortedness)  k ≤ k' → ord(k) ≤ ord(k')
          S2 (attainment)  ord(k) is an input element (or the pad)
          S3 (rank bounds) |{v ≤ ord(k)}| ≥ k+1  ∧  |{v < ord(k)}| ≤ k
                           (pads counted by their uniform value)

        — over the input's process-domain elements plus, for a ConcatVec,
        the symbolically-n uniform pad half.  An INF pad additionally emits
        the (f32-total-order-sound) dominance fact ∀i. v(i) ≤ INF.  This
        closes the sort extraction boundary that previously required
        @aux_method contracts."""
        from round_tpu_torch.verify.venn import N_VAR

        if not isinstance(op, (Vec, ConcatVec)):
            raise ExtractionError("sort over a non-vector value")
        uid = next(self._fresh)
        fct = UnInterpretedFct(f"ext!sort!{uid}", FunT([procType, Int], Int))

        def ord_at(r):
            return Application(fct, [self.receiver, r]).with_type(Int)

        total = Plus(N_VAR, N_VAR) if isinstance(op, ConcatVec) else N_VAR
        pad = op.pad if isinstance(op, ConcatVec) else None
        base = op.fn

        def pad_count(rel, bound):
            if pad is None:
                return None
            return Ite(rel(pad, bound), N_VAR, IntLit(0))

        k1 = Variable(f"srk!{uid}a", Int)
        k2 = Variable(f"srk!{uid}b", Int)

        def in_range(kv):
            return And(Leq(IntLit(0), kv), Lt(kv, total))

        # S1
        self.axioms.append(ForAll(
            [k1, k2],
            Implies(And(in_range(k1), in_range(k2), Leq(k1, k2)),
                    Leq(ord_at(k1), ord_at(k2))),
        ))
        # S2
        iv = self.var()
        attained = Exists([iv], Eq(base(iv), ord_at(k1)))
        if pad is not None:
            attained = Or(attained, Eq(ord_at(k1), pad))
        self.axioms.append(ForAll(
            [k1], Implies(in_range(k1), attained),
        ))
        # S3 (≤ with k+1 lower bound; < with k upper bound)
        for rel, mk_bound in (
            (Leq, lambda kv, c: Geq(c, Plus(kv, IntLit(1)))),
            (Lt, lambda kv, c: Leq(c, kv)),
        ):
            iw = self.var()
            card = Card(Comprehension([iw], rel(base(iw), ord_at(k1))))
            pc = pad_count(rel, ord_at(k1))
            count = card if pc is None else Plus(card, pc)
            self.axioms.append(ForAll(
                [k1], Implies(in_range(k1), mk_bound(k1, count)),
            ))
        if pad is not None and pad == _INF_F:
            ip = self.var()
            self.axioms.append(ForAll([ip], Leq(base(ip), _INF_F)))
        return RankVec(ord_at)

    def _extremum(self, body_fn, tpe: Type, is_max: bool,
                  guard_fn=None) -> Formula:
        """m = max/min over {i | guard} of body(i):
           ∀i. guard(i) → body(i) ≤ m        (≥ for min)
           ∃i. guard(i) ∧ m = body(i)        (attainment; sound because the
                                              executable reduces a nonempty
                                              axis)."""
        m = self._site("max" if is_max else "min", tpe)
        i = self.var()
        guard = guard_fn(i) if guard_fn is not None else Literal(True)
        bound = Leq(body_fn(i), m) if is_max else Geq(body_fn(i), m)
        self.axioms.append(ForAll([i], Implies(guard, bound)))
        i2 = self.var()
        self.axioms.append(
            Exists([i2], And(guard_fn(i2) if guard_fn is not None
                             else Literal(True), Eq(m, body_fn(i2))))
        )
        return m

    def _arg_extremum(self, body_fn, is_max: bool) -> Formula:
        """a = argmax/argmin over the process axis of body:
           ∀i. body(i) ≤ body(a)   (≥ for min).
        Over a BOOLEAN body (jnp.argmax(cand) = "first True", the
        Mailbox.arg_best tie-break pattern) the bound is the implication
        cand(i) → cand(a): if any candidate exists the site is one.  The
        tie-break (first index) is abstracted away — an over-approximation
        of the executable, sound for safety VCs."""
        a = self._site("argmax" if is_max else "argmin", procType)
        i = self.var()
        probe = body_fn(i)
        if _is_boolish(probe):
            bound = (Implies(probe, body_fn(a)) if is_max
                     else Implies(body_fn(a), probe))
        else:
            bound = (Leq(probe, body_fn(a)) if is_max
                     else Geq(probe, body_fn(a)))
        self.axioms.append(ForAll([i], bound))
        return a

    # -- aten op dispatch --------------------------------------------------

    def eval_op(self, node, ins):
        """One aten op of the graph (round_tpu/verify/extract.py::
        _Interpreter.eval_prim, whose jaxpr primitives map as the comments
        say)."""
        tgt = node.target
        if not isinstance(tgt, torch._ops.OpOverload):
            raise ExtractionError(f"unsupported graph call {tgt!r}")
        ns, op = tgt.namespace, tgt._schema.name.split("::")[-1]
        kw = node.kwargs

        def in_shape(k):
            return _shape_of(node.args[k])

        def out_shape():
            return _shape_of(node)

        from round_tpu_torch.verify.auxmethod import AUX_NAMESPACE, REGISTRY
        if ns == AUX_NAMESPACE:
            spec = REGISTRY.get(op)
            if spec is None:
                raise ExtractionError(
                    f"operator {ns}::{op} uses the reserved aux namespace "
                    "but is not registered"
                )
            return self._aux_call(spec, node, ins)
        if ns != "aten":
            raise ExtractionError(
                f"unsupported operator '{ns}::{op}' — express this "
                "computation as an axiomatized auxiliary function "
                "(RoundTR.aux, @aux_method) instead"
            )
        if op in _ADAPTERS:
            # convert_element_type / copy / squeeze / reshape: dtype
            # adapters and rank-preserving reshapes (n,)↔(n,1)↔(1,n) —
            # orientation is recovered from shapes at the consuming op
            return _lift(ins[0]) if not isinstance(
                ins[0], (Scalar, Vec, Vec2)) else ins[0]
        if op in ("expand", "expand_copy"):
            # broadcast_in_dim: torch aligns the input's axes trailing
            s_in, s_out = in_shape(0), out_shape()
            bdims = tuple(range(len(s_out) - len(s_in), len(s_out)))
            return self._broadcast(ins[0], s_in, s_out, bdims)
        if op in _FILLS:
            # a uniform constant tensor: broadcast_in_dim of a literal
            val = _FILLS[op](node.args)
            dt = _dtype_of(node)
            val = bool(val) if dt == torch.bool else (
                float(val) if dt is not None and dt.is_floating_point
                else val)
            return self._broadcast(_lift(val), (), out_shape(), ())
        if op in ("add", "sub") and kw.get("alpha", 1) != 1:
            raise ExtractionError(f"aten.{op} with alpha")
        if op == "div":
            mode = kw.get("rounding_mode")
            if mode not in (None, "floor"):
                raise ExtractionError(f"aten.div with rounding_mode={mode!r}")
            # integer floor-div and float division alike route through
            # DIVIDES (the jaxpr path's div primitive and its floor_divide
            # shortcut); cl._eliminate_int_div linearizes constant divisors
            return self._binop2(_idiv, ins, node)
        if op in _ATEN_BINOPS:
            mk = _BINOPS[_ATEN_BINOPS[op]]
            a, b = ins[0], ins[1]
            if op == "mul" and not isinstance(node.args[1], torch.fx.Node):
                # torch records 2 * n as mul(n, 2): keep the constant factor
                # first, as the round code writes it
                a, b = b, a
                node_args = (node.args[1], node.args[0])
            else:
                node_args = node.args[:2]
            return self._binop2(mk, [a, b], node, node_args)
        if op == "rsub":
            return self._binop2(lambda x, y: Minus(y, x), ins, node)
        if op == "remainder":
            # the % shortcut (the coordinator arithmetic (r // 4) % n,
            # LastVoting.scala:95)
            return self._binop2(_imod, ins, node)
        if op in ("clamp", "clamp_min", "clamp_max"):
            # jnp.maximum(x, lo) / jnp.minimum(x, hi) in one op
            lo = node.args[1] if len(node.args) > 1 else kw.get("min")
            hi = node.args[2] if len(node.args) > 2 else kw.get("max")
            if op == "clamp_max":
                lo, hi = None, lo
            if isinstance(lo, torch.fx.Node) or isinstance(hi, torch.fx.Node):
                raise ExtractionError("aten.clamp with tensor bounds")
            v = ins[0]
            if lo is not None:
                v = _binop(lambda x, y: Ite(Gt(_to_int(x), _to_int(y)),
                                            _to_int(x), _to_int(y)), v, lo)
            if hi is not None:
                v = _binop(lambda x, y: Ite(Gt(_to_int(x), _to_int(y)),
                                            _to_int(y), _to_int(x)), v, hi)
            return v
        if op in ("maximum", "minimum"):
            def mk(x, y, is_max=(op == "maximum")):
                x, y = _to_int(x), _to_int(y)
                c = Gt(x, y)
                return Ite(c, x, y) if is_max else Ite(c, y, x)
            return self._binop2(mk, ins, node)
        if op == "neg":
            from round_tpu_torch.verify.formula import UMINUS
            return _unop(lambda x: Application(UMINUS, [x]).with_type(Int),
                         ins[0])
        if op == "logical_not" or (op == "bitwise_not"
                                   and _dtype_of(node) == torch.bool):
            return _unop(lambda x: Not(x), ins[0])
        if op in ("where", "masked_fill"):
            # select_n(pred, on_false, on_true); mixed proc/int branches
            # (where(mask, arange, -1) in the FoldRound reduce forms)
            # unify in the Int domain via pToId
            # where(pred, on_true, on_false); masked_fill(x, pred, v)
            order = (0, 2, 1) if op == "where" else (1, 0, 2)
            if len(out_shape()) == 2:
                parts = [self._orient(ins[k], _shape_of(node.args[k]))
                         for k in order]
            else:
                parts = [ins[k] for k in order]
            return _binop_3(*parts, mixed_to_int=True)
        if op in _REDUCTIONS:
            kind = _REDUCTIONS[op]
            s_in = in_shape(0)
            if len(node.args) < 2 or node.args[1] is None:
                axes = tuple(range(len(s_in))) or (0,)
            else:
                dims = node.args[1]
                dims = [dims] if isinstance(dims, int) else list(dims)
                axes = tuple(sorted(d % max(len(s_in), 1) for d in dims)) \
                    or tuple(range(len(s_in)))
            return self._reduce(ins[0], kind, axes, s_in)
        if op in ("max", "min") and len(node.args) >= 2:
            # max.dim / min.dim: (values, indices)
            operand, kind = ins[0], op
            s_in = in_shape(0)
            axes = (node.args[1] % max(len(s_in), 1),)
            return _Multi([
                lambda: self._reduce(operand, kind, axes, s_in),
                lambda: self._argext(operand, kind == "max", f"{kind}.dim"),
            ])
        if op in ("max", "min"):
            return self._reduce(ins[0], op, (0,), in_shape(0))
        if op in ("argmax", "argmin"):
            return self._argext(ins[0], op == "argmax", op)
        if op == "dot":
            return self._dot(ins[0], ins[1], in_shape(0), in_shape(1),
                             (((0,), (0,)), ((), ())))
        if op == "mv":
            # M @ v contracts M's columns: v · Mᵀ
            return self._dot(ins[1], ins[0], in_shape(1), in_shape(0),
                             (((0,), (1,)), ((), ())))
        if op == "index":
            # v[idx] with a traced index (Mailbox._pick gathers a [1] index)
            idx = ins[1]
            if len(idx) != 1 or idx[0] is None:
                raise ExtractionError("unsupported index pattern")
            return self._gather(ins[0], idx[0], in_shape(0), out_shape())
        if op in ("select", "select_copy"):
            operand = _lift(ins[0]) if not isinstance(ins[0], _ABS) \
                else ins[0]
            dim, k = node.args[1], node.args[2]
            if isinstance(operand, Scalar) and in_shape(0) == (1,):
                return operand  # the size-1 pick of a gathered element
            if isinstance(operand, RankVec) and dim in (0, -1) \
                    and len(in_shape(0)) == 1:
                # static pick of a RANK-indexed vector (sorted_v[2f])
                return Scalar(operand.fn(IntLit(k % in_shape(0)[0])))
            raise ExtractionError("unsupported select pattern")
        if op in ("slice", "slice_copy"):
            operand = _lift(ins[0])
            args = list(node.args) + [None] * (5 - len(node.args))
            dim, start, step = args[1] or 0, args[2] or 0, args[4] or 1
            # static single-element pick of a RANK-indexed vector; process-
            # domain slices would need an Int→proc coercion and have no
            # use case
            if isinstance(operand, RankVec) and dim in (0, -1) \
                    and step == 1 and out_shape() == (1,):
                return Scalar(operand.fn(IntLit(start)))
            raise ExtractionError("unsupported slice pattern")
        if op == "arange":
            args = node.args
            if len(args) >= 2 and (args[0] != 0
                                   or (len(args) > 2 and args[2] != 1)):
                raise ExtractionError("arange with a start or a step")
            # a process-length iota is the lane-id vector; any other length
            # (the ε-model's [2n] selection indices) lives in the RANK
            # domain — its reductions must not get a senders guard
            if self.proc_len is not None and out_shape() != (self.proc_len,):
                return RankVec(lambda i: i)
            return Vec(lambda i: i)
        if op == "cat":
            parts = ins[0]
            dim = node.args[1] if len(node.args) > 1 else 0
            shapes = [_shape_of(x) for x in node.args[0]]
            # the mailbox ++ halted layout with a constant second half
            # (Epsilon.scala:55 with no prior halts): process-domain base
            # plus a uniform pad of symbolically n entries
            if len(parts) == 2 and dim in (0, -1):
                a, b = _lift(parts[0]), _lift(parts[1])
                if isinstance(a, Vec) and isinstance(b, Scalar) \
                        and shapes[0] == shapes[1]:
                    return ConcatVec(a.fn, b.f)
            raise ExtractionError(
                "unsupported cat pattern (only [proc-vector, uniform pad] "
                "of equal halves)"
            )
        if op == "sort":
            if node.kwargs.get("descending") or (
                    len(node.args) > 2 and node.args[2] is True):
                raise ExtractionError("descending sort")
            operand = _lift(ins[0])

            def indices():
                raise ExtractionError(
                    "sort indices read — only the sorted values extract "
                    "(the order-statistics site)")
            return _Multi([lambda: self._sort_site(operand), indices])
        raise ExtractionError(
            f"unsupported aten op '{tgt.name()}' — express this computation "
            f"as an axiomatized auxiliary function (RoundTR.aux, "
            f"@aux_method) instead"
        )

    def _orient(self, v, s_in):
        """View an operand of a rank-2 result as a Vec2 from its own shape
        under torch's trailing-aligned broadcasting: (n,1) → rows, (1,n) and
        (n,) → cols, (n,n) → as-is, scalar → const."""
        v = _lift(v) if not isinstance(v, _ABS) else v
        if isinstance(v, Vec):
            if len(s_in) == 2 and s_in[1] == 1 and s_in[0] != 1:
                return Vec2(lambda r, c: v.fn(r))
            return Vec2(lambda r, c: v.fn(c))
        if isinstance(v, Scalar):
            return Vec2(lambda r, c: v.f)
        return v

    def _binop2(self, mk, ins, node, node_args=None):
        node_args = node.args[:2] if node_args is None else node_args
        if len(_shape_of(node)) == 2:
            # rank-promoting binop (e.g. eq of (1,n) with (n,1)): orient
            # each operand from its own shape
            return _binop(mk, self._orient(ins[0], _shape_of(node_args[0])),
                          self._orient(ins[1], _shape_of(node_args[1])))
        return _binop(mk, ins[0], ins[1])

    def _argext(self, op, is_max, name):
        op = _lift(op) if not isinstance(op, _ABS) else op
        if not isinstance(op, Vec):
            raise ExtractionError(f"{name} over a non-vector value")
        return Scalar(self._arg_extremum(op.fn, is_max))

    def _broadcast(self, v, s_in, s_out, bdims):
        v = _lift(v) if not isinstance(v, _ABS) else v
        if len(s_out) <= 1 or (len(s_out) == 2 and 1 in s_out):
            return v  # vector-ish broadcast: same abstract value
        if len(s_out) == 2:
            if isinstance(v, Scalar):
                return Vec2(lambda r, c: v.f)
            if isinstance(v, Vec):
                # which output dim carries the original axis?
                if s_in == () or len(s_in) == 0:
                    return Vec2(lambda r, c: v.fn(r))  # unreachable
                if len(s_in) == 1:
                    dim = bdims[0] if bdims else 0
                elif len(s_in) == 2:
                    dim = 0 if s_in[0] != 1 else 1
                else:
                    raise ExtractionError("broadcast rank > 2")
                if dim == 0:
                    return Vec2(lambda r, c: v.fn(r))
                return Vec2(lambda r, c: v.fn(c))
            return v
        raise ExtractionError(f"broadcast to rank-{len(s_out)} shape {s_out}")

    def _dot(self, a, b, sa, sb, dnums):
        """Indicator contraction: dot(a, b) over 0/1 operands is a count.
        mmor's counts = mask[n] @ eq[n, n] (ops/mailbox.py) → per-slot
        cardinalities |{i | mask(i) ∧ eq(i, c)}|."""
        ((lc, rc), (lb, rb)) = dnums
        if lb or rb:
            raise ExtractionError("batched dot_general")
        if len(lc) != 1 or len(rc) != 1:
            raise ExtractionError("multi-axis contraction")
        a = _lift(a) if not isinstance(a, (Scalar, Vec, Vec2)) else a
        b = _lift(b) if not isinstance(b, (Scalar, Vec, Vec2)) else b

        def body(av, bv, i, rem):
            fa = av.fn(i) if isinstance(av, Vec) else av.fn(
                *( (i, rem) if lc == (0,) else (rem, i) ))
            fb = bv.fn(i) if isinstance(bv, Vec) else bv.fn(
                *( (i, rem) if rc == (0,) else (rem, i) ))
            if not (_is_boolish(fa) and _is_boolish(fb)):
                raise ExtractionError(
                    "dot_general over non-indicator values — use an "
                    "axiomatized auxiliary (RoundTR.aux)"
                )
            return And(fa, fb)

        if isinstance(a, Vec) and isinstance(b, Vec2):
            return Vec(lambda rem: Card(Comprehension(
                [iv := self.var()], body(a, b, iv, rem))))
        if isinstance(a, Vec2) and isinstance(b, Vec):
            return Vec(lambda rem: Card(Comprehension(
                [iv := self.var()], body(b, a, iv, rem))))
        if isinstance(a, Vec) and isinstance(b, Vec):
            i = self.var()
            return Scalar(Card(Comprehension([i], body(a, b, i, None))))
        raise ExtractionError("dot_general over unsupported operand kinds")

    def _gather(self, operand, idx, s_op, s_out):
        operand = _lift(operand) if not isinstance(
            operand, (Scalar, Vec, Vec2)) else operand
        idx = _lift(idx) if not isinstance(idx, _ABS) else idx
        if isinstance(operand, Vec) and isinstance(idx, Scalar) \
                and len(s_out) <= 1:
            # v[i] with a traced process index (e.g. payload of argmax sender)
            return Scalar(operand.fn(idx.f))
        if isinstance(operand, RankVec) and isinstance(idx, Scalar) \
                and len(s_out) <= 1:
            return Scalar(operand.fn(idx.f))
        if isinstance(operand, RankVec) and isinstance(idx, RankVec):
            # sorted_v[idx] with a rank-index vector (the ε selection) —
            # composition stays in the rank domain
            return RankVec(lambda k: operand.fn(idx.fn(k)))
        raise ExtractionError("unsupported gather pattern")

    def _reduce(self, operand, kind: str, axes, s_in):
        if isinstance(operand, Vec2) and len(axes) == 1:
            # partial reduction: the remaining process axis stays a Vec
            red_axis = axes[0]

            def partial(rem):
                i = self.var()
                body = operand.fn(i, rem) if red_axis == 0 \
                    else operand.fn(rem, i)
                return i, body

            if kind == "sum":
                def mk(rem):
                    i, body = partial(rem)
                    if not _is_boolish(body):
                        raise ExtractionError("sum over non-indicator values")
                    return Card(Comprehension([i], body))
                return Vec(mk)
            if kind in ("max", "min"):
                # one site per remaining index is not expressible; reduce to
                # a two-arg site fn applied at rem
                k = next(self._fresh)
                fct = UnInterpretedFct(
                    f"ext!{kind}2!{k}", FunT([procType, procType], Int))

                def at(rem):
                    return Application(fct, [self.receiver, rem]).with_type(Int)

                rem0 = self.var()
                i0 = self.var()
                body0 = operand.fn(i0, rem0) if red_axis == 0 \
                    else operand.fn(rem0, i0)
                bound = Leq(body0, at(rem0)) if kind == "max" \
                    else Geq(body0, at(rem0))
                self.axioms.append(ForAll([rem0, i0], bound))
                i1 = self.var()
                rem1 = self.var()
                body1 = operand.fn(i1, rem1) if red_axis == 0 \
                    else operand.fn(rem1, i1)
                self.axioms.append(
                    ForAll([rem1], Exists([i1], Eq(at(rem1), body1)))
                )
                return Vec(at)
            if kind == "or":
                def mk_or(rem):
                    i, body = partial(rem)
                    return Exists([i], body)
                return Vec(mk_or)
            if kind == "and":
                def mk_and(rem):
                    i, body = partial(rem)
                    return ForAll([i], body)
                return Vec(mk_and)
        if isinstance(operand, ConcatVec):
            from round_tpu_torch.verify.venn import N_VAR

            if kind != "sum":
                raise ExtractionError(
                    f"reduce_{kind} over a concatenated vector")
            ic = self.var()
            bodyc = operand.fn(ic)
            if not _is_boolish(bodyc):
                raise ExtractionError("sum over non-indicator concat values")
            base = Card(Comprehension([ic], And(self.senders(ic), bodyc)))
            # the uniform pad half contributes all-or-nothing
            return Scalar(Plus(base, Ite(operand.pad, N_VAR, IntLit(0))))
        if isinstance(operand, RankVec):
            # rank-domain reduction (the ε midpoint mean's numerator/count):
            # OPAQUE site, no axioms — sound ("some value"); the round-0
            # order-statistics lemmas never consume it
            return Scalar(self._site(f"rank{kind}", Int))
        if not isinstance(operand, Vec):
            raise ExtractionError(f"reduce_{kind} over a non-mailbox value")
        i = self.var()
        body = operand.fn(i)
        guard = self.senders(i)
        if kind == "sum":
            # count: Σ over senders of a 0/1 indicator → |{i | guard ∧ body}|
            if not _is_boolish(body):
                raise ExtractionError(
                    "reduce_sum over non-indicator values (a true sum, not "
                    "a count) — express it as an axiomatized auxiliary "
                    "function (RoundTR.aux) instead"
                )
            return Scalar(Card(Comprehension([i], And(guard, body))))
        if kind == "or":
            return Scalar(Exists([i], And(guard, body)))
        if kind == "and":
            return Scalar(ForAll([i], Implies(guard, body)))
        # max / min over the full axis
        tpe = body.tpe if body.tpe is not None else Int
        return Scalar(self._extremum(
            operand.fn, tpe if isinstance(tpe, Type) else Int,
            is_max=(kind == "max"),
            guard_fn=None if _is_true(self.senders) else self.senders,
        ))


def _is_true(guard_fn) -> bool:
    probe = guard_fn(Variable("probe", procType))
    return isinstance(probe, Literal) and probe.value is True


_BOOL_FCTS = None


def _is_boolish(f: Formula) -> bool:
    """Is this formula a 0/1 indicator (so summing it is a count)?"""
    global _BOOL_FCTS
    if _BOOL_FCTS is None:
        from round_tpu_torch.verify.formula import (
            AND, EQ, GEQ, GT, IMPLIES, IN, LEQ, LT, NEQ, NOT, OR,
        )
        _BOOL_FCTS = (AND, OR, NOT, IMPLIES, EQ, NEQ, LT, LEQ, GT, GEQ, IN)
    if isinstance(f, Literal):
        return isinstance(f.value, bool)
    if isinstance(f, Variable):
        return isinstance(f.tpe, BoolT)
    if isinstance(f, Application):
        if f.fct in _BOOL_FCTS:
            return True
        return isinstance(f.tpe, BoolT)
    return False


def _binop_3(which, on_false, on_true, mixed_to_int=False):
    which, a, b = _lift(which), _lift(on_false), _lift(on_true)
    if isinstance(which, Scalar) and isinstance(which.f, Literal) \
            and isinstance(which.f.value, bool):
        # fold a statically-decided select (e.g. the dead negative-index
        # correction branch around an argmax site)
        return b if which.f.value else a
    parts = [which, a, b]

    def mk_ite(c, t, e):
        if isinstance(c, Literal) and isinstance(c.value, bool):
            # constant-condition fold — in particular the uniform PAD lane
            # of a ConcatVec select, whose mask pad is a literal: folding
            # keeps the pad recognizable (the sort site's INF-dominance
            # axiom matches the INF constant, not an Ite around it)
            return t if c.value else e
        if mixed_to_int:
            tt = getattr(t, "tpe", None)
            te = getattr(e, "tpe", None)
            if (tt == procType) != (te == procType):
                t, e = _to_int(t), _to_int(e)
        return Ite(c, t, e)

    if all(isinstance(p, Scalar) for p in parts):
        return Scalar(mk_ite(which.f, on_true.f, on_false.f))
    if any(isinstance(p, Vec2) for p in parts):
        fns = [_as2(p) for p in parts]
        return Vec2(
            lambda r, c: mk_ite(fns[0](r, c), fns[2](r, c), fns[1](r, c))
        )
    if any(isinstance(p, ConcatVec) for p in parts):
        if any(isinstance(p, (Vec, RankVec)) for p in parts):
            raise ExtractionError("select mixing concat and plain vectors")
        fns = [_elem_fn(p) for p in parts]
        pads = [p.f if isinstance(p, Scalar) else p.pad for p in parts]
        return ConcatVec(
            lambda i: mk_ite(fns[0](i), fns[2](i), fns[1](i)),
            mk_ite(pads[0], pads[2], pads[1]),
        )
    if any(isinstance(p, RankVec) for p in parts):
        if any(isinstance(p, Vec) for p in parts):
            raise ExtractionError(
                "select mixing rank-domain and process-domain vectors")
        fns = [_elem_fn(p) for p in parts]
        return RankVec(lambda i: mk_ite(fns[0](i), fns[2](i), fns[1](i)))
    fns = [(lambda i, p=p: p.f) if isinstance(p, Scalar) else p.fn
           for p in parts]
    return Vec(lambda i: mk_ite(fns[0](i), fns[2](i), fns[1](i)))


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def _device(device) -> torch.device:
    """The device a trace runs on: the card unless the caller names one
    (the port's rule for every entry point); raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "extract_lane_fn traces on the CUDA device by default and "
                "none is available; pass device='cpu'"
            )
        return torch.device("cuda")
    return torch.device(device)


def trace_lane_fn(fn: Callable, example_args: Sequence[Any], device=None):
    """The aten graph of ``fn`` on ``example_args`` moved to ``device``:
    make_fx over the functionalized function (in-place ops trace as pure
    ones, views as copies), @aux_method helpers as one operator node each,
    ops.detsum.tree_sum as one plain sum, and fx's dead-code elimination
    in place of round_tpu's ``_dce`` — an extraction that asks for x
    must not be forced to handle ops on a path that only feeds outputs it
    drops, such as the ε-model's float horizon arithmetic.

    A host read of a traced tensor (``.item()``, ``int(t)``, ``if t:``)
    would specialise the trace to the example's value; make_fx refuses it
    and so does this function."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from round_tpu_torch.ops import detsum
    from round_tpu_torch.verify import auxmethod

    dev = _device(device)
    ex = pytree.tree_map(
        lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a,
        list(example_args))
    # under extraction, ops.detsum.tree_sum traces as a plain sum: the
    # deterministic add-tree exists for cross-engine bit-parity of float
    # sums, which the abstract interpreter cannot see anyway — such sites
    # are OPAQUE in the order abstraction (RankVec reduce), and tracing the
    # explicit tree would instead produce a spurious non-opaque Plus over
    # order symbols (unsound)
    with detsum.extracting(), auxmethod.tracing():
        try:
            gm = make_fx(torch.func.functionalize(
                fn, remove="mutations_and_views"))(*ex)
        except RuntimeError as e:
            if "_local_scalar_dense" in str(e):
                raise ExtractionError(
                    "the round code reads a traced tensor on the host "
                    "(.item(), int(t), bool(t) or `if t:`): the trace would "
                    "specialise to the example's value — keep it a tensor"
                ) from e
            raise
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm, ex


def extract_lane_fn(
    fn: Callable,
    example_args: Sequence[Any],
    formula_args: Sequence["Scalar | Vec"],
    senders_domain: Callable[[Formula], Formula],
    receiver: Optional[Formula] = None,
    return_axioms: bool = False,
    return_obligations: bool = False,
    device=None,
):
    """Trace `fn` (a pure per-lane function) with `example_args` (tensors
    fixing shapes and dtypes; ``n`` a 0-d tensor so that it stays a
    symbol) on ``device`` — the CUDA device unless named — and abstractly
    interpret its aten graph over `formula_args`
    (round_tpu/verify/extract.py::extract_lane_fn).  Returns the outputs as
    Scalars/Vecs (and, with return_axioms, the site axioms pinning
    max/min/argmax reduction results — quantify them over `receiver` when
    conjoining into the TR).

    This is processSendUpdate (TrExtractor.scala:101-160) with aten graphs
    instead of Scala trees: same inputs (the executable round code), same
    output (formulas for the transition relation)."""
    gm, ex = trace_lane_fn(fn, example_args, device)
    # the process-axis length, for rank-domain detection: the (single)
    # 1-D length among the example args
    lens = {a.shape[0] for a in pytree.tree_leaves(ex)
            if isinstance(a, torch.Tensor) and a.dim() == 1}
    proc_len = lens.pop() if len(lens) == 1 else None
    interp = _Interpreter(senders_domain, receiver=receiver,
                          proc_len=proc_len)
    flat_args = pytree.tree_leaves(
        list(formula_args), is_leaf=lambda x: isinstance(x, _ABS))
    outs = interp.run(gm, flat_args)
    if interp.obligations and not return_obligations:
        # a dropped pre-condition would let the verifier assume the post of
        # a helper called outside its contract — refuse to extract unless
        # the caller collects (and discharges) the obligations
        raise ExtractionError(
            "aux-method pre-conditions were recorded "
            f"({len(interp.obligations)}); pass return_obligations=True "
            "and discharge them as VCs"
        )
    extras = []
    if return_axioms:
        axioms = list(interp.axioms)
        probe = Variable("ptid!probe", procType)
        everything = axioms + [
            o.f if isinstance(o, Scalar)
            else (o.fn(probe) if isinstance(o, Vec)
                  else o.fn(probe, probe))
            for o in outs
            if isinstance(o, _ABS)
        ]

        def uses_ptoid(t):
            if isinstance(t, Application):
                return t.fct == P_TO_ID or any(uses_ptoid(a) for a in t.args)
            if isinstance(t, Binding):
                return uses_ptoid(t.body)
            return False

        if any(uses_ptoid(t) for t in everything):
            # lane ids are 0..n-1 in the runtime: the sentinel comparisons
            # of the FoldRound reduce forms (ids vs -1) are decided by this
            p = Variable("ptid", procType)
            axioms.append(ForAll([p], Geq(
                Application(P_TO_ID, [p]).with_type(Int), IntLit(0)
            )))
        extras.append(axioms)
    if return_obligations:
        extras.append(interp.obligations)
    return (outs, *extras) if extras else outs


def extract_update_equations(
    update_fn: Callable,
    sig,
    payloads: Dict[str, "Vec"],
    mask: "Vec",
    example_args: Sequence[Any],
    formula_args: Sequence["Scalar | Vec"],
    out_fields: Sequence[str],
    senders_domain: Callable[[Formula], Formula],
    j: Formula,
) -> Formula:
    """Extract a round's update as equations  field′(j) = extracted-expr.

    `out_fields` names the state fields in the order update_fn returns them."""
    outs = extract_lane_fn(update_fn, example_args, formula_args,
                           senders_domain)
    if len(outs) != len(out_fields):
        raise ExtractionError(
            f"update returns {len(outs)} values, expected {len(out_fields)}"
        )
    eqs = []
    for name, out in zip(out_fields, outs):
        if not isinstance(out, Scalar):
            raise ExtractionError(f"output {name} is not per-lane scalar")
        eqs.append(Eq(sig.get_primed(name, j), out.f))
    return And(*eqs)


# a name that may hold counter-made parts: a stem, then parts after "!"
# or "$" (ext!7, ext!max!3, snd!x!12, venn!4!pm, i$5, ext!0$31!9,
# srk!3a), or a type variable '<k>
_TOKEN = re.compile(r"(?<![\w!$'])[A-Za-z_][\w!$]*(?![\w!$])"
                    r"|(?<![\w'])'\d+(?!\w)")
_SEP = re.compile(r"([!$])")


def canon(strings: Sequence[str]) -> List[str]:
    """Rename fresh symbols canonically, the rule under which two prints of
    one extraction (round_tpu's and the port's, or the card's and the
    CPU's) are compared: in each distinct name that a global
    counter made — the extraction sites ``ext!<k>``/``ext!<tag>!<k>``, a
    sort site's ``srk!<k>a``/``srk!<k>b``, tr.py's ``snd!<field>!<k>`` and
    ``mbi!<k>``, venn's ``venn!<k>!<signs>``, futils.fresh's
    ``<name>$<k>``, a type variable ``'<k>`` — every counter-made part
    becomes the order in which the name first occurs across ``strings``;
    the other parts stay.  The extractor's counter ticks per graph node
    visited, and an aten graph visits other nodes than a jaxpr; the other
    counters depend on what the process built before.  Nothing else is
    renamed."""
    names = {}

    def sub(mo):
        t = mo.group(0)
        if t in names:
            return names[t]
        k = len(names)
        if t.startswith("'"):
            names[t] = f"'#{k}"
            return names[t]
        parts = _SEP.split(t)
        fresh = False
        for i in range(2, len(parts), 2):
            if parts[i].isdigit():
                parts[i], fresh = f"#{k}", True
            elif parts[0] == "srk" and re.fullmatch(r"\d+[ab]", parts[i]):
                parts[i], fresh = f"#{k}{parts[i][-1]}", True
        if not fresh:
            return t
        names[t] = "".join(parts)
        return names[t]

    return [_TOKEN.sub(sub, s) for s in strings]
