"""Threshold-automaton extraction from round aten-graph traces.

Port of round_tpu/analysis/threshold.py.  The Byzantine Model Checker line
of work proves round-based fault-tolerant algorithms safe/live for ALL n
by abstracting each process into a *threshold automaton*: a finite control
graph whose transition rules are guarded by linear threshold expressions
over message counts ("heard more than 2n/3 estimates", "a majority of
acks").  This module recovers that automaton from the same traces the
lint computes (tracerules._RoundTracer: make_fx over the engine's vmap of
one round, on small example tensors on ``device``):

  locations  = reachable valuations of the model's boolean state fields
               (decided / commit / ready / ...), per process;
  rules      = per-round transitions between locations, guarded by cubes
               over extracted guard atoms;
  thresholds = comparisons whose one side is a *message count* (a sum /
               count product over the mailbox mask) and whose other side
               is a function of n alone.

The count thresholds are recovered as affine-in-n expressions by MULTI-n
SAMPLING: round code computes ``(2 * ctx.n) // 3`` in Python with ``ctx.n``
a Python int, so a single trace only ever sees the literal 5 — tracing the
same code at several group sizes and fitting ``floor((a*n + b) / d)``
against the observed constants recovers the symbolic threshold (and
rejects guards that are not affine in n, the `threshold-extractable` lint
family).

The interpreter is round_tpu's over the same abstract domain (taint,
linear combinations of count atoms, boolean guard expressions); its input
is the aten graph instead of a jaxpr, each aten op taking the case of the
jaxpr primitive it replaces (``_RoundInterp.eval_op``).

The resilience condition (``n > 3f`` / ``n > 2f``) is taken from the
model's DECLARED fault envelope (Algorithm.fault_envelope) — extraction
recovers the guards, the model author states what faults they are meant
to survive, and verify/param.py proves the two consistent for all n.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from round_tpu_torch.analysis.findings import Finding, relpath
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.verify.extract import _ADAPTERS, _FILLS, _shape_of
from round_tpu_torch.analysis.tracerules import (
    _fn_anchor, _RoundTracer, flatten_with_names, init_state, resolve_device,
    trace_graph,
)

#: default group sizes for the affine fit.  Chosen to break floor-form
#: aliasing: e.g. floor(2n/3) and floor((3n-3)/4) agree on {5,7,9,12} and
#: are split by 16.  Residues cover 0,1,2 mod 3 and 0,1,3 mod 4.
DEFAULT_SAMPLES = (5, 7, 9, 12, 16)

#: the cheaper sample set the lint rule uses (extractability does not need
#: a canonical fit, only *a* fit)
LINT_SAMPLES = (5, 7, 9)


class ThresholdExtractionError(Exception):
    """The model's guards cannot be recovered as threshold expressions.
    Carries the offending guard's description so the refusal is actionable
    (the extractor must REFUSE rather than mis-extract)."""


# ---------------------------------------------------------------------------
# Abstract values: taint + linear-combination-of-counts + boolean expressions
# ---------------------------------------------------------------------------

#: taint tags
T_MASK = "mask"        # derived from the delivery mask (HO & dest)
T_PAYLOAD = "payload"  # derived from a received payload / sent value
T_RNG = "rng"          # derived from the per-lane PRNG key
T_ROUND = "round"      # derived from the round number r
T_ID = "id"            # derived from the lane-id iota


class Opaque:
    """A value the automaton does not model: carries taint tags plus the
    contributing state-field names, and whether it is a 0/1 indicator."""

    __slots__ = ("taint", "fields", "is01")

    def __init__(self, taint=frozenset(), fields=frozenset(), is01=False):
        self.taint = frozenset(taint)
        self.fields = frozenset(fields)
        self.is01 = bool(is01)

    def __repr__(self):
        return f"Opaque({sorted(self.taint)}, {sorted(self.fields)})"


class CountVec(Opaque):
    """A vector of message counts (the histogram/equality count-matmul
    output): reductions over it yield count atoms."""


@dataclasses.dataclass(frozen=True)
class CountAtom:
    """One message-count expression: a reduce_sum (or count-matmul + max)
    over the mailbox mask, possibly conjoined with payload/state
    predicates.

    kind:   "size" (mask alone), "support" (mask ∧ value predicate) or
            "max_support" (max over a histogram of supports).
    fields: the state fields feeding the predicate (empty for "size") —
            e.g. {"x"} for OTR's value-support count, {"ts"} for the LV
            ack count (the sender guard rides the dest mask).
    idx:    per-round registration order — the cross-sample matching key.
    """

    round: int
    idx: int
    kind: str
    fields: Tuple[str, ...]

    @property
    def label(self) -> str:
        return (self.kind if not self.fields
                else f"{self.kind}[{','.join(self.fields)}]")


class Lin:
    """An integer value that is a linear combination of count atoms plus a
    constant (known concretely for the current n sample):
    ``sum(coeffs[atom] * atom) + const``."""

    __slots__ = ("coeffs", "const")

    def __init__(self, coeffs: Optional[Dict[CountAtom, int]] = None,
                 const: int = 0):
        self.coeffs = {a: c for a, c in (coeffs or {}).items() if c != 0}
        self.const = int(const)

    @property
    def is_const(self) -> bool:
        return not self.coeffs

    def add(self, other: "Lin", sign: int = 1) -> "Lin":
        coeffs = dict(self.coeffs)
        for a, c in other.coeffs.items():
            coeffs[a] = coeffs.get(a, 0) + sign * c
        return Lin(coeffs, self.const + sign * other.const)

    def scale(self, k: int) -> "Lin":
        return Lin({a: c * k for a, c in self.coeffs.items()}, self.const * k)

    def __repr__(self):
        parts = [f"{c}*{a.label}" for a, c in self.coeffs.items()]
        parts.append(str(self.const))
        return " + ".join(parts)


# -- boolean expressions over guard atoms -----------------------------------

class BExpr:
    def atoms(self) -> frozenset:
        raise NotImplementedError

    def ev(self, env: Dict[str, bool]) -> bool:
        raise NotImplementedError


class BConst(BExpr):
    __slots__ = ("v",)

    def __init__(self, v: bool):
        self.v = bool(v)

    def atoms(self):
        return frozenset()

    def ev(self, env):
        return self.v


class BAtom(BExpr):
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def atoms(self):
        return frozenset([self.name])

    def ev(self, env):
        return env[self.name]


class BNot(BExpr):
    __slots__ = ("a",)

    def __init__(self, a: BExpr):
        self.a = a

    def atoms(self):
        return self.a.atoms()

    def ev(self, env):
        return not self.a.ev(env)


class BOp(BExpr):
    __slots__ = ("op", "a", "b")

    def __init__(self, op: str, a: BExpr, b: BExpr):
        self.op, self.a, self.b = op, a, b

    def atoms(self):
        return self.a.atoms() | self.b.atoms()

    def ev(self, env):
        x, y = self.a.ev(env), self.b.ev(env)
        if self.op == "and":
            return x and y
        if self.op == "or":
            return x or y
        return x != y  # xor


class BIte(BExpr):
    __slots__ = ("c", "t", "e")

    def __init__(self, c: BExpr, t: BExpr, e: BExpr):
        self.c, self.t, self.e = c, t, e

    def atoms(self):
        return self.c.atoms() | self.t.atoms() | self.e.atoms()

    def ev(self, env):
        return self.t.ev(env) if self.c.ev(env) else self.e.ev(env)


# ---------------------------------------------------------------------------
# Guard atoms
# ---------------------------------------------------------------------------

#: guard-atom kinds
G_THRESHOLD = "threshold"  # linear-in-counts vs affine-in-n
G_RECEIVE = "receive"      # heard a specific sender (mask point lookup)
G_PHASE = "phase"          # predicate over the round number r
G_ROLE = "role"            # lane-id vs round-derived coordinator arithmetic
G_STATE = "state"          # a boolean state field read as a guard
G_DATA = "data"            # data-/rng-dependent — NOT threshold-extractable


@dataclasses.dataclass
class GuardAtom:
    """One boolean guard atom of a round, registered in trace order (the
    cross-sample matching key is (round, idx))."""

    round: int
    idx: int
    kind: str
    #: "gt" | "ge" | "eq" | "ne" (thresholds; negations normalize on use)
    op: str = ""
    #: THRESHOLD: coefficients per count atom of (lhs - rhs)
    coeffs: Dict[CountAtom, int] = dataclasses.field(default_factory=dict)
    #: THRESHOLD: the constant part of (lhs - rhs) at THIS n sample
    const: int = 0
    #: human-readable description (receive/phase/role/data atoms)
    detail: str = ""
    #: DATA: why it is not a threshold (taint tags + fields)
    taint: Tuple[str, ...] = ()

    @property
    def name(self) -> str:
        return f"g{self.round}.{self.idx}"


@dataclasses.dataclass(frozen=True)
class Threshold:
    """A fitted threshold guard: ``sum(coeff_i * count_i)  op
    floor((a*n + b) / d)`` — e.g. OTR's quorum is size > (2n+0)/3 and a
    majority ack is support[ts] > (n+0)/2."""

    op: str                      # "gt" | "ge" | "eq" | "ne"
    counts: Tuple[str, ...]      # count labels, fit order
    coeffs: Tuple[int, ...]      # coefficients per count
    a: int                       # numerator n-coefficient
    b: int                       # numerator constant
    d: int                       # denominator (>= 1)

    def render(self) -> str:
        lhs = " + ".join(
            (f"{c}*{l}" if c != 1 else l)
            for c, l in zip(self.coeffs, self.counts)
        )
        sym = {"gt": ">", "ge": ">=", "eq": "==", "ne": "!="}[self.op]
        if self.d == 1:
            rhs = f"{self.a}n{self.b:+d}" if self.b else f"{self.a}n"
            if self.a == 0:
                rhs = str(self.b)
        else:
            rhs = f"({self.a}n{self.b:+d})//{self.d}" if self.b \
                else f"({self.a}n)//{self.d}"
        return f"{lhs} {sym} {rhs}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One automaton rule: in round `round`, a process at `src` moves to
    `dst` when the guard cube holds.  The guard is a tuple of
    (atom_name, polarity) literals; atom_name indexes the automaton's
    guard table."""

    round: int
    src: Tuple[Tuple[str, bool], ...]   # location as sorted (field, value)
    dst: Tuple[Tuple[str, bool], ...]
    guard: Tuple[Tuple[str, bool], ...]

    def render(self, guards: Dict[str, "GuardInfo"]) -> str:
        def loc(v):
            on = [f for f, b in v if b]
            return "{" + ",".join(on) + "}" if on else "{}"

        if not self.guard:
            g = "true"
        else:
            g = " & ".join(
                ("" if pol else "!") + guards[a].render()
                for a, pol in self.guard
            )
        return f"r{self.round}: {loc(self.src)} -> {loc(self.dst)} when {g}"


@dataclasses.dataclass(frozen=True)
class GuardInfo:
    """A fitted guard in the automaton's guard table."""

    name: str
    kind: str
    threshold: Optional[Threshold] = None
    detail: str = ""

    def render(self) -> str:
        if self.threshold is not None:
            return self.threshold.render()
        return self.detail or self.name


@dataclasses.dataclass
class ThresholdAutomaton:
    """The extracted automaton for one protocol."""

    protocol: str
    n_samples: Tuple[int, ...]
    fields: Tuple[str, ...]                       # boolean control fields
    locations: Tuple[Tuple[Tuple[str, bool], ...], ...]
    init_locations: Tuple[Tuple[Tuple[str, bool], ...], ...]
    rules: Tuple[Rule, ...]
    guards: Dict[str, GuardInfo]
    resilience: Optional[Tuple[int, str]]         # (K, "n > Kf") or None
    rounds_per_phase: int

    def thresholds(self) -> List[GuardInfo]:
        return [g for g in self.guards.values() if g.kind == G_THRESHOLD]

    def to_dict(self) -> dict:
        return {
            "protocol": self.protocol,
            "n_samples": list(self.n_samples),
            "fields": list(self.fields),
            "locations": [dict(l) for l in self.locations],
            "init_locations": [dict(l) for l in self.init_locations],
            "rules": [
                {"round": r.round, "src": dict(r.src), "dst": dict(r.dst),
                 "guard": [("" if pol else "!") +
                           self.guards[a].render()
                           for a, pol in r.guard]}
                for r in self.rules
            ],
            "guards": {name: {"kind": g.kind, "expr": g.render()}
                       for name, g in self.guards.items()},
            "resilience": self.resilience[1] if self.resilience else None,
            "rounds_per_phase": self.rounds_per_phase,
        }

    def render(self) -> str:
        lines = [f"threshold automaton: {self.protocol} "
                 f"(fit over n in {list(self.n_samples)})"]
        if self.resilience:
            lines.append(f"  resilience: {self.resilience[1]}")
        lines.append(f"  control fields: {', '.join(self.fields) or '-'}")
        for name, g in sorted(self.guards.items()):
            lines.append(f"  guard {name} [{g.kind}]: {g.render()}")
        for r in self.rules:
            lines.append("  rule " + r.render(self.guards))
        return "\n".join(lines)


def parse_envelope(envelope: Optional[str]) -> Optional[Tuple[int, str]]:
    """Parse a declared fault envelope ``"n > Kf"`` into (K, canonical)."""
    if not envelope:
        return None
    import re

    m = re.fullmatch(r"\s*n\s*>\s*(\d*)\s*\*?\s*f\s*", envelope)
    if not m:
        raise ThresholdExtractionError(
            f"unparseable fault envelope {envelope!r} (expected 'n > Kf')"
        )
    k = int(m.group(1) or "1")
    return k, f"n > {k}f"



# ---------------------------------------------------------------------------
# The taint/linear interpreter (one round, one n sample)
# ---------------------------------------------------------------------------

_CMP = {"lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq", "ne": "ne"}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
_BOOLOPS = {"and": "and", "or": "or", "xor": "xor"}

# aten ops → the jaxpr primitive whose case they take in eval_prim
# (round_tpu/analysis/threshold.py::_RoundInterp.eval_prim).  Ops that only
# change dtype, layout, a size-1 axis or a broadcast pass their operand on
# (convert_element_type, copy, squeeze, reshape, broadcast_in_dim,
# transpose, rev, expand_dims): verify/extract.py's adapters and the
# broadcasts and transposes; uniform constant tensors are its fills (a
# broadcast_in_dim of a literal)
_PASS = _ADAPTERS | frozenset({
    "expand", "expand_copy", "permute", "permute_copy", "t", "t_copy",
    "transpose", "transpose_copy", "flip",
})
_ATEN_CMP = {"lt": "lt", "le": "le", "gt": "gt", "ge": "ge", "eq": "eq",
             "ne": "ne"}
_ATEN_BOOL = {"bitwise_and": "and", "logical_and": "and", "__and__": "and",
              "bitwise_or": "or", "logical_or": "or", "__or__": "or",
              "bitwise_xor": "xor", "logical_xor": "xor", "__xor__": "xor"}
# the unary/binary arithmetic that folds on constants and is opaque else
# (div, rem, pow, max, min, neg, sign, abs, floor, ceil, round)
_ATEN_ARITH = {
    "div": "div", "floor_divide": "floordiv", "remainder": "rem",
    "fmod": "fmod", "pow": "pow", "maximum": "max", "minimum": "min",
    "fmax": "max", "fmin": "min", "neg": "neg", "sign": "sign",
    "abs": "abs", "floor": "floor", "ceil": "ceil", "round": "round",
    "clamp": "clamp", "clamp_min": "max", "clamp_max": "min",
}
# the count products (dot_general)
_ATEN_DOT = frozenset({"mm", "bmm", "matmul", "mv", "dot", "einsum"})
# reductions: op → (kind, whether it also returns the indices)
_ATEN_REDUCE = {"sum": "sum", "amax": "max", "amin": "min",
                "any": "or", "all": "and"}
# dynamic point lookups (gather / dynamic_slice)
_ATEN_LOOKUP = frozenset({"index", "gather", "index_select"})


def _node_val(a):
    return a.meta.get("val") if isinstance(a, torch.fx.Node) else None


@contextlib.contextmanager
def _marking_count_products():
    """Mark the sums that make_fx records inside the block as count
    products (``node.meta["count_product"]``)."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode

    mode = get_proxy_mode()
    graph = mode.tracer.graph if mode is not None else None
    before = set(graph.nodes) if graph is not None else set()
    try:
        yield
    finally:
        if graph is not None:
            for node in graph.nodes:
                if node not in before and node.op == "call_function" \
                        and getattr(node.target, "__name__", "").startswith(
                            "sum."):
                    node.meta["count_product"] = True


class _CountMarkingMailbox(Mailbox):
    """The engine's Mailbox, its count products marked in the trace.
    round_tpu's mailbox computes the per-value histogram and mmor's
    sender-equality counts as ``dot_general`` (a count vector the
    interpreter reads as CountVec); the port's computes them as a sum over
    the sender axis of a 0/1 product (ops/mailbox.py), which a model's own
    sums share.  The mark tells the two apart."""

    def value_histogram(self, num_values: int, values=None):
        with _marking_count_products():
            return super().value_histogram(num_values, values)

    def min_most_often_received(self, values=None,
                                num_values: Optional[int] = None):
        with _marking_count_products():
            return super().min_most_often_received(values, num_values)


class _RoundInterp:
    """Abstractly interprets one round's aten graph (send + exchange +
    update, vmapped over lanes) over the taint/Lin/BExpr domain,
    registering count atoms and guard atoms as it goes
    (round_tpu/analysis/threshold.py::_RoundInterp over a jaxpr).  TOTAL
    by construction: ops outside the modeled fragment produce Opaque
    values, never errors."""

    def __init__(self, round_idx: int, n: int):
        self.round_idx = round_idx
        self.n = n
        self.counts: List[CountAtom] = []
        self.guards: List[GuardAtom] = []
        self._guard_keys: Dict[Any, GuardAtom] = {}

    # -- registration -------------------------------------------------------

    def _count(self, kind: str, fields) -> Lin:
        atom = CountAtom(self.round_idx, len(self.counts), kind,
                         tuple(sorted(fields)))
        self.counts.append(atom)
        return Lin({atom: 1})

    def _guard(self, key, **kw) -> BAtom:
        """Register (or reuse) a guard atom; `key` dedupes structurally
        identical comparisons within the round."""
        if key in self._guard_keys:
            return BAtom(self._guard_keys[key].name)
        atom = GuardAtom(self.round_idx, len(self.guards), **kw)
        self.guards.append(atom)
        self._guard_keys[key] = atom
        return BAtom(atom.name)

    # -- value coercion -----------------------------------------------------

    def _lift(self, v):
        if isinstance(v, (Opaque, Lin)) or isinstance(v, BExpr):
            return v
        if v is None or isinstance(v, (list, tuple, str, torch.dtype,
                                       torch.device)):
            return Opaque()
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        arr = np.asarray(v)
        if arr.dtype == np.bool_:
            vals = np.unique(arr)
            if vals.size == 1:
                return BConst(bool(vals[0]))
            return Opaque(is01=True)
        if np.issubdtype(arr.dtype, np.integer) or np.issubdtype(
                arr.dtype, np.floating):
            vals = np.unique(arr)
            if vals.size == 1 and np.isfinite(vals[0]) \
                    and float(vals[0]) == int(vals[0]):
                return Lin(const=int(vals[0]))
            if arr.ndim == 1 and np.array_equal(
                    arr, np.arange(arr.shape[0])):
                # a captured lane-id vector (the vmapped ctx.id): the
                # coordinator-role comparisons need the tag
                return Opaque(frozenset([T_ID]))
        return Opaque()

    @staticmethod
    def _taint(v) -> frozenset:
        if isinstance(v, Opaque):
            return v.taint
        return frozenset()

    @staticmethod
    def _fields(v) -> frozenset:
        if isinstance(v, Opaque):
            return v.fields
        return frozenset()

    def _opaque_of(self, ins, is01=False, cls=Opaque):
        taint = frozenset().union(*[self._taint(self._lift(v)) for v in ins]) \
            if ins else frozenset()
        fields = frozenset().union(
            *[self._fields(self._lift(v)) for v in ins]) if ins else frozenset()
        return cls(taint, fields, is01=is01)

    def _is01(self, v) -> bool:
        v = self._lift(v)
        if isinstance(v, BExpr):
            return True
        if isinstance(v, Opaque):
            return v.is01
        if isinstance(v, Lin):
            return v.is_const and v.const in (0, 1)
        return False

    # -- the walk -----------------------------------------------------------

    def run(self, gm, args):
        """Interpret the aten graph of ``gm`` (a make_fx GraphModule) over
        the flat abstract ``args``, one per placeholder; returns the flat
        outputs."""
        env: Dict[Any, Any] = {}
        flat = iter(args)

        def read(a):
            if isinstance(a, torch.fx.Node):
                return env.get(a, Opaque())
            if isinstance(a, (list, tuple)):
                return type(a)(read(x) for x in a)
            return a

        outs: List[Any] = []
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(flat, Opaque())
            elif node.op == "get_attr":
                # a tensor the trace captured: a constant (a jaxpr constvar)
                env[node] = self._lift(getattr(gm, node.target))
            elif node.op == "call_function":
                ins = [read(x) for x in node.args]
                if node.target is operator.getitem:
                    base, k = ins
                    env[node] = base[k] if isinstance(base, list) \
                        and isinstance(k, int) and k < len(base) \
                        else self._opaque_of([base])
                else:
                    env[node] = self.eval_op(node, ins)
            elif node.op == "output":
                outs = pytree.tree_leaves(
                    read(node.args[0]),
                    is_leaf=lambda x: isinstance(x, (Opaque, Lin, BExpr)))
        return [self._lift(o) for o in outs]

    # -- op semantics -------------------------------------------------------

    def eval_op(self, node, ins):
        """One aten op, mapped onto the case of the jaxpr primitive it
        replaces (round_tpu/analysis/threshold.py::_RoundInterp.eval_prim).
        The count products (dot_general) are a sum over the sender axis of
        a 0/1 mask product that leaves a vector per lane, as the port's
        mailbox computes them (ops/mailbox.py), or a matmul."""
        tgt = node.target
        n_out = 1
        val = _node_val(node)
        if isinstance(val, (list, tuple)):
            n_out = len(val)
        if not isinstance(tgt, torch._ops.OpOverload):
            return self._many(self._opaque_of(ins), n_out)
        op = tgt._schema.name.split("::")[-1]
        lifted = [self._lift(v) for v in ins]

        if op in _PASS:
            return lifted[0]
        if op == "copy":
            return lifted[1]
        if op == "arange":
            return Opaque(frozenset([T_ID]))
        if op in _FILLS:
            fill = _FILLS[op](node.args)
            if isinstance(val, torch.Tensor) and val.dtype == torch.bool:
                fill = bool(fill)
            return self._lift(fill)
        if op in ("add", "sub", "rsub"):
            a, b = lifted[0], lifted[1]
            alpha = node.kwargs.get("alpha", 1)
            if len(node.args) > 2:
                alpha = node.args[2]
            if op == "rsub":
                a, b = b, a
            if isinstance(a, Lin) and isinstance(b, Lin) \
                    and isinstance(alpha, int):
                return a.add(b.scale(alpha), 1 if op == "add" else -1)
            return self._opaque_of(lifted[:2])
        if op == "mul":
            a, b = lifted[0], lifted[1]
            if isinstance(a, Lin) and isinstance(b, Lin):
                if a.is_const:
                    return b.scale(a.const)
                if b.is_const:
                    return a.scale(b.const)
            if self._is01(a) and self._is01(b):
                # indicator product = conjunction: keep 01-ness so a later
                # sum still reads as a count
                return self._opaque_of([a, b], is01=True)
            return self._opaque_of([a, b])
        if op in ("max", "min") and len(node.args) == 2 \
                and not isinstance(node.args[1], int):
            # max.other / min.other: the binary maximum/minimum
            return self._arith("max" if op == "max" else "min", lifted[:2],
                               node)
        if op in _ATEN_ARITH:
            args = [lifted[0]] + [self._lift(a) for a in node.args[1:2]
                                  if a is not None]
            if op == "clamp":
                args = [lifted[0]] + [self._lift(a) for a in node.args[1:3]
                                      if a is not None]
            return self._arith(_ATEN_ARITH[op], args, node)
        if op in ("logical_not", "bitwise_not"):
            a = lifted[0]
            if isinstance(a, BExpr):
                return BNot(a)
            return self._opaque_of(lifted[:1], is01=self._is01(a))
        if op in _ATEN_BOOL:
            a, b = lifted[0], lifted[1]
            if isinstance(a, BExpr) and isinstance(b, BExpr):
                return BOp(_ATEN_BOOL[op], a, b)
            return self._opaque_of([a, b], is01=True)
        if op in _ATEN_CMP:
            return self._compare(_ATEN_CMP[op], lifted[:2])
        if op in ("where", "masked_fill"):
            # select_n(pred, on_false, on_true)
            if op == "where":
                which, b, a = lifted[0], lifted[1], lifted[2]
            else:
                a, which, b = lifted[0], lifted[1], lifted[2]
            cases = [a, b]
            if isinstance(which, BConst):
                return b if which.v else a
            if isinstance(which, BExpr) and isinstance(a, BExpr) \
                    and isinstance(b, BExpr):
                return BIte(which, b, a)
            return self._opaque_of([which] + cases, is01=all(
                self._is01(c) for c in cases))
        if op in ("max", "min") and len(node.args) >= 2:
            # max.dim / min.dim: (values, indices)
            red = self._reduce("max" if op == "max" else "min", node,
                               lifted[0])
            return [red, self._opaque_of(lifted[:1])]
        if op in ("max", "min"):
            return self._reduce("max" if op == "max" else "min", node,
                                lifted[0])
        if op in _ATEN_REDUCE:
            return self._reduce(_ATEN_REDUCE[op], node, lifted[0])
        if op in ("argmax", "argmin"):
            return self._opaque_of(lifted[:1])
        if op in _ATEN_DOT:
            operands = lifted[1] if op == "einsum" else lifted[:2]
            if isinstance(operands, (list, tuple)) and len(operands) == 2:
                a, b = (self._lift(x) for x in operands)
                if self._is01(a) and self._is01(b) and (
                        T_MASK in self._taint(a) | self._taint(b)):
                    taint = self._taint(a) | self._taint(b)
                    fields = self._fields(a) | self._fields(b)
                    return CountVec(taint, fields, is01=False)
                return self._opaque_of([a, b])
            return self._opaque_of(list(operands) if isinstance(
                operands, (list, tuple)) else [operands])
        if op in _ATEN_LOOKUP:
            return self._lookup(op, ins, lifted)
        if op in ("select", "select_copy", "slice", "slice_copy"):
            # a static pick: a squeeze when it drops a size-1 axis or
            # keeps the whole axis, a jaxpr slice (opaque) else
            s_in, s_out = _shape_of(node.args[0]), _shape_of(node)
            if op.startswith("select") and s_in and \
                    s_in[node.args[1] % len(s_in)] == 1:
                return lifted[0]
            if op.startswith("slice") and s_in == s_out:
                return lifted[0]
        # anything else (cat/sort/scatter/random bits/...): taint-union the
        # inputs; random generators taint rng
        if "rand" in op or "bernoulli" in op or "multinomial" in op:
            return self._many(Opaque(frozenset([T_RNG])), n_out)
        flat_ins = [x for x in pytree.tree_leaves(
            lifted, is_leaf=lambda x: isinstance(x, (Opaque, Lin, BExpr)))]
        return self._many(self._opaque_of(flat_ins), n_out)

    @staticmethod
    def _many(v, n_out: int):
        return [v] * n_out if n_out > 1 else v

    def _arith(self, prim, lifted, node):
        out = self._opaque_of(lifted)
        # constant arithmetic stays constant
        if all(isinstance(v, Lin) and v.is_const for v in lifted):
            return self._const_fold(prim, lifted, node)
        if prim == "div" and node.kwargs.get("rounding_mode") == "floor":
            prim = "floordiv"
        if prim == "floordiv":
            self._jnp_floor_divide(*lifted[:2])
        elif prim == "rem":
            self._jnp_remainder(*lifted[:2])
        return out

    def _sign(self, v):
        return Lin(const=int(np.sign(v.const))) \
            if isinstance(v, Lin) and v.is_const else self._opaque_of([v])

    def _jnp_floor_divide(self, a, b):
        """The comparisons of jnp.floor_divide's integer lowering (div,
        then a correction where sign(a) != sign(b) and rem(a, b) != 0):
        round_tpu's interpreter registers them, so the port does too and
        the guard table numbers alike."""
        self._compare("ne", [self._sign(a), self._sign(b)])
        self._compare("ne", [self._opaque_of([a, b]), Lin(const=0)])

    def _jnp_remainder(self, a, b):
        """The comparisons of jnp.remainder's lowering (a zero divisor
        replaced by 1, rem, then a sign correction)."""
        is0 = self._compare("eq", [b, Lin(const=0)])
        if isinstance(is0, BConst):
            u = Lin(const=1) if is0.v else b
        else:
            u = self._opaque_of([b])
        v = self._opaque_of([a, u])
        self._compare("ne", [v, Lin(const=0)])
        self._compare("lt", [v, Lin(const=0)])
        self._compare("lt", [u, Lin(const=0)])

    def _const_fold(self, prim, lifted, node):
        a = lifted[0].const
        if prim == "neg":
            return Lin(const=-a)
        if prim == "sign":
            return Lin(const=int(np.sign(a)))
        if prim == "abs":
            return Lin(const=abs(a))
        if prim in ("floor", "ceil", "round"):
            return Lin(const=a)
        if len(lifted) < 2:
            return Opaque()
        b = lifted[1].const
        try:
            if prim == "div":
                mode = node.kwargs.get("rounding_mode")
                if mode == "floor":
                    return Lin(const=a // b)
                if mode == "trunc":
                    return Lin(const=int(a / b))
                return Lin(const=int(a / b)) if a % b == 0 else Opaque()
            if prim == "floordiv":
                return Lin(const=a // b)
            if prim == "rem":
                return Lin(const=a % b)
            if prim == "fmod":
                return Lin(const=int(np.fmod(a, b)))
            if prim == "max":
                return Lin(const=max(a, b))
            if prim == "min":
                return Lin(const=min(a, b))
            if prim == "clamp":
                lo = b
                hi = lifted[2].const if len(lifted) > 2 else None
                v = max(a, lo)
                return Lin(const=v if hi is None else min(v, hi))
            if prim == "pow":
                return Lin(const=int(a ** b))
        except Exception:  # noqa: BLE001
            return Opaque()
        return Opaque()

    def _reduce(self, kind, node, op):
        if kind == "sum":
            return self._reduce_sum(node, op)
        if kind in ("max", "min"):
            if isinstance(op, CountVec):
                return self._count("max_support", op.fields)
            return self._opaque_of([op], is01=self._is01(op))
        # or / and
        if isinstance(op, BConst):
            return op
        return self._opaque_of([op], is01=True)

    def _reduce_sum(self, node, op):
        s_in = _shape_of(node.args[0])
        if len(node.args) < 2 or node.args[1] is None \
                or node.args[1] == []:
            axes = tuple(range(len(s_in)))
        else:
            dims = node.args[1]
            dims = [dims] if isinstance(dims, int) else list(dims)
            axes = tuple(d % max(len(s_in), 1) for d in dims)
        if isinstance(op, Lin):
            # summing a constant/linear over an axis multiplies by its
            # length — length is a concrete int here, fine for consts
            k = 1
            for ax in axes:
                if ax < len(s_in):
                    k *= s_in[ax]
            return op.scale(k)
        if isinstance(op, CountVec):
            # summing the whole histogram = total count (size-like)
            return self._count("size", op.fields)
        taint = self._taint(op)
        if self._is01(op) and T_MASK in taint:
            if node.meta.get("count_product"):
                # the mailbox's count product (round_tpu's dot_general)
                return CountVec(taint, self._fields(op), is01=False)
            kind = "size" if not (self._fields(op)
                                  or T_PAYLOAD in taint) else "support"
            return self._count(kind, self._fields(op))
        return self._opaque_of([op])

    def _lookup(self, op, ins, lifted):
        """v[idx] with a traced index: a mask point-lookup is a RECEIVE
        guard (heard a specific sender); anything else keeps taint.  jnp
        indexing first wraps a negative index (``lt idx 0``, then a
        select), and that comparison registers as the jaxpr's does."""
        src = lifted[0]
        if op == "index":
            idx = [self._lift(v) for v in (ins[1] or []) if v is not None]
        else:  # gather / index_select: (self, dim, index)
            idx = [lifted[2]]
        for i in idx:
            if not (isinstance(i, Lin) and i.is_const):
                self._compare("lt", [i, Lin(const=0)])
        return self._point_lookup([src] + idx)

    def _point_lookup(self, lifted):
        op = lifted[0]
        taint = self._taint(op)
        idx_taints = frozenset().union(
            *[self._taint(v) for v in lifted[1:]]) if len(lifted) > 1 \
            else frozenset()
        if T_MASK in taint and not self._fields(op) and self._is01(op):
            who = "coord(r)" if T_ROUND in idx_taints else (
                "self" if T_ID in idx_taints and not idx_taints - {T_ID}
                else "expr")
            return self._guard(
                ("receive", who), kind=G_RECEIVE,
                detail=f"heard({who})",
            )
        return self._opaque_of(lifted, is01=self._is01(op))

    def _compare(self, op, lifted):
        a, b = lifted
        # Lin vs Lin with at least one genuine count → threshold guard
        if isinstance(a, Lin) and isinstance(b, Lin):
            diff = a.add(b, -1)
            if diff.is_const:
                return BConst(self._eval_const_cmp(op, diff.const))
            if op in ("lt", "le"):
                # normalize to gt/ge by flipping the difference: the
                # downstream vocabulary (render, threshold_applied) only
                # speaks gt/ge/eq/ne, and `a < b` IS `b > a`
                diff = diff.scale(-1)
                op = _FLIP[op]
            key = ("thr", op,
                   tuple(sorted(((c.idx, k) for c, k in diff.coeffs.items()))),
                   diff.const)
            return self._guard(
                key, kind=G_THRESHOLD, op=op,
                coeffs=dict(diff.coeffs), const=diff.const,
            )
        ta, tb = self._taint(a), self._taint(b)
        taint = ta | tb
        fields = self._fields(a) | self._fields(b)
        count_side = isinstance(a, Lin) and not a.is_const or \
            isinstance(b, Lin) and not b.is_const
        if count_side:
            # a message count compared against data / rng / state — the
            # canonical NON-extractable threshold
            return self._guard(
                ("data", op, tuple(sorted(taint)), tuple(sorted(fields))),
                kind=G_DATA, op=op,
                detail=f"count {op} non-constant "
                       f"({', '.join(sorted(taint | fields)) or 'data'})",
                taint=tuple(sorted(taint | fields)),
            )
        if T_ID in ta and (T_ROUND in tb or isinstance(b, Lin)) or \
                T_ID in tb and (T_ROUND in ta or isinstance(a, Lin)):
            return self._guard(
                ("role", op, tuple(sorted(taint))), kind=G_ROLE,
                detail="id == coord(r)" if op == "eq" else f"id {op} coord",
            )
        if T_ROUND in taint and not (taint - {T_ROUND}) and (
                isinstance(a, Lin) or isinstance(b, Lin)
                or (T_ROUND in ta and T_ROUND in tb)):
            c = a if isinstance(a, Lin) else (b if isinstance(b, Lin) else None)
            cval = c.const if c is not None and c.is_const else "?"
            return self._guard(
                ("phase", op, str(cval)), kind=G_PHASE,
                detail=f"r {op} {cval}",
            )
        if isinstance(a, BExpr) or isinstance(b, BExpr):
            # comparing booleans: eq/ne over BExprs
            if isinstance(a, BExpr) and isinstance(b, BExpr) and op in (
                    "eq", "ne"):
                e = BOp("xor", a, b)
                return BNot(e) if op == "eq" else e
        # payload-vs-payload and friends: an indicator, not a guard
        return self._opaque_of(lifted, is01=True)

    @staticmethod
    def _eval_const_cmp(op, diff):
        return {"lt": diff < 0, "le": diff <= 0, "gt": diff > 0,
                "ge": diff >= 0, "eq": diff == 0, "ne": diff != 0}[op]



# ---------------------------------------------------------------------------
# Per-sample round summaries + cross-sample matching
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RoundSample:
    """One round's interpretation at one n."""

    n: int
    counts: List[CountAtom]
    guards: List[GuardAtom]
    bool_outs: Dict[str, Any]       # field -> BExpr | Opaque



def _flatten_fields(tree) -> List[Tuple[str, Any]]:
    """(dot-path field name, leaf) pairs — '.x', '.decided' → 'x',
    'decided' — in the order make_fx numbers the placeholders."""
    return [(name.lstrip("."), leaf)
            for name, leaf in flatten_with_names(tree)]


def _is_control(leaf) -> bool:
    """Control bit = a per-lane boolean SCALAR ([n] after the lane vmap).
    Boolean vectors (kset's bitset maps, lattice joins) are data."""
    return leaf.dtype == torch.bool and leaf.dim() == 1


def _trace_round(model: str, n: int, algo, io, round_idx: int,
                 rnd, device=None, rolled=None) -> _RoundSample:
    """Trace round `round_idx` at group size n on ``device`` and interpret
    its aten graph.  ``rolled`` (a dict, optional) keeps the state before
    each round at each n across calls, so that a sweep over the rounds
    rolls each earlier round forward once."""
    tracer = _RoundTracer(model, n, algo, device)
    tracer.mailbox_cls = _CountMarkingMailbox
    rolled = {} if rolled is None else rolled
    start = max((j for (m, j) in rolled if m == n and j <= round_idx),
                default=0)
    state = rolled[(n, start)] if start else \
        init_state(algo, io, n, tracer.device)
    # roll the state forward through earlier rounds (shape fixed point per
    # comm-closure, but EventRound phases may reshape between rounds of a
    # phase in principle — mirror trace_phase)
    for j in range(start, round_idx):
        nxt = tracer.trace_round(j, algo.rounds[j], state)
        if nxt is None:
            raise ThresholdExtractionError(
                f"{model}: round {j} does not trace "
                f"(roundlint findings: {[f.rule for f in tracer.findings]})"
            )
        state = nxt
        rolled[(n, j + 1)] = state

    gm = trace_graph(tracer.round_fn(rnd),
                     (state, tracer.r, tracer.ho, tracer.keys))

    interp = _RoundInterp(round_idx, n)
    # tag the flat inputs: state leaves by field name, then r, ho, keys
    state_leaves = _flatten_fields(state)
    args: List[Any] = []
    for name, leaf in state_leaves:
        if _is_control(leaf):
            args.append(BAtom(f"state:{name}"))
        else:
            args.append(Opaque(frozenset([T_PAYLOAD]),
                               frozenset([name])))
    args.append(Opaque(frozenset([T_ROUND])))    # r
    args.append(Opaque(frozenset([T_MASK]), is01=True))  # ho
    args.append(Opaque(frozenset([T_RNG])))      # keys
    outs = interp.run(gm, args)

    bool_outs: Dict[str, Any] = {}
    for (name, leaf), out in zip(state_leaves, outs):
        if _is_control(leaf):
            bool_outs[name] = out
    return _RoundSample(n=n, counts=interp.counts, guards=interp.guards,
                        bool_outs=bool_outs)

# ---------------------------------------------------------------------------
# Affine fit
# ---------------------------------------------------------------------------

def fit_affine(ns: Sequence[int], ts: Sequence[int],
               max_d: int = 4) -> Optional[Tuple[int, int, int]]:
    """Fit t(n) = floor((a*n + b) / d) over the samples.  Returns (a, b, d)
    with the smallest d (then |b|), or None when no small-coefficient
    affine form fits — the non-affine refusal."""
    best = None
    for d in range(1, max_d + 1):
        for a in range(-2 * d, 2 * d + 1):
            lo, hi = -(10 ** 9), 10 ** 9
            ok = True
            for n, t in zip(ns, ts):
                # d*t <= a*n + b <= d*t + d - 1
                lo = max(lo, d * t - a * n)
                hi = min(hi, d * t - a * n + d - 1)
                if lo > hi:
                    ok = False
                    break
            if not ok:
                continue
            b = min(range(lo, hi + 1), key=abs)
            cand = (d, a, b)
            if best is None or (cand[0], abs(cand[2]), abs(cand[1])) < (
                    best[0], abs(best[2]), abs(best[1])):
                best = cand
        if best is not None and best[0] == d:
            break  # smallest denominator wins; no need to try larger
    if best is None:
        return None
    d, a, b = best
    return a, b, d


# ---------------------------------------------------------------------------
# Location/rule construction
# ---------------------------------------------------------------------------

def _loc_key(valuation: Dict[str, bool]) -> Tuple[Tuple[str, bool], ...]:
    return tuple(sorted(valuation.items()))


def _cube_expand(cube: Dict[str, bool],
                 atoms: List[str]) -> List[Tuple[Tuple[str, bool], ...]]:
    """All full assignments a cube covers."""
    free = [x for x in atoms if x not in cube]
    out = []
    for bits in itertools.product([False, True], repeat=len(free)):
        full = dict(cube)
        full.update(zip(free, bits))
        out.append(tuple(sorted(full.items())))
    return out


def _cube_reduce(assigns: List[Dict[str, bool]],
                 atoms: List[str]) -> List[Tuple[Tuple[str, bool], ...]]:
    """Greedy don't-care elimination: merge the guard assignments that
    produce one transition into a small set of cubes (not guaranteed
    minimal — stability across runs is what the goldens need)."""
    full = {tuple(sorted(a.items())) for a in assigns}
    cubes: List[Tuple[Tuple[str, bool], ...]] = []
    covered: set = set()
    for a in sorted(full):
        if a in covered:
            continue
        cube = dict(a)
        for atom in atoms:
            if atom not in cube:
                continue
            trial = {k: v for k, v in cube.items() if k != atom}
            if all(p in full for p in _cube_expand(trial, atoms)):
                cube = trial
        covered.update(_cube_expand(cube, atoms))
        cubes.append(tuple(sorted(cube.items())))
    return cubes


# ---------------------------------------------------------------------------
# Cross-sample matching + automaton assembly
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Problem:
    """One reason a guard is not threshold-extractable (becomes a lint
    finding in the rule pass, a refusal in strict extraction)."""

    rule: str          # finding rule suffix
    round: int
    message: str
    hint: str


def _match_round(samples: List[_RoundSample], round_idx: int,
                 problems: List[_Problem]) -> Tuple[
                     Dict[str, GuardInfo], Dict[str, Any], List[str]]:
    """Fit one round's guards across the n samples.  Returns
    (guard_table, bool_outs of the first sample, data_guard_names)."""
    first = samples[0]
    table: Dict[str, GuardInfo] = {}
    data_guards: List[str] = []

    aligned = all(
        len(s.guards) == len(first.guards)
        and all(a.kind == b.kind and a.op == b.op
                for a, b in zip(s.guards, first.guards))
        for s in samples[1:]
    )
    if not aligned:
        problems.append(_Problem(
            "sample-inconsistent", round_idx,
            f"round {round_idx}'s guard structure differs across group "
            f"sizes ({[s.n for s in samples]}): the round's control flow "
            "is not a fixed function of n",
            "make guard structure independent of the concrete n (no "
            "n-dependent Python branching in round code)",
        ))
        return table, first.bool_outs, data_guards

    for gi, g in enumerate(first.guards):
        name = g.name
        if g.kind == G_THRESHOLD:
            coeff_key = tuple(sorted(
                (c.idx, k) for c, k in g.coeffs.items()))
            same = all(
                tuple(sorted((c.idx, k)
                             for c, k in s.guards[gi].coeffs.items()))
                == coeff_key
                for s in samples[1:]
            )
            if not same:
                problems.append(_Problem(
                    "sample-inconsistent", round_idx,
                    f"round {round_idx} guard #{gi}: count coefficients "
                    "differ across group sizes",
                    "quorum arithmetic must use the same count expression "
                    "at every n",
                ))
                continue
            # guard is  sum(coeff*count) + const(n)  op  0, i.e.
            # sum(coeff*count)  op  t(n) := -const(n)
            ns = [s.n for s in samples]
            ts = [-s.guards[gi].const for s in samples]
            fit = fit_affine(ns, ts)
            if fit is None:
                problems.append(_Problem(
                    "non-affine", round_idx,
                    f"round {round_idx} guard #{gi}: threshold constant "
                    f"{dict(zip(ns, ts))} fits no floor((a*n+b)/d) with "
                    "d <= 4 — not a threshold expression",
                    "express the quorum bound as integer arithmetic affine "
                    "in ctx.n (e.g. (2*n)//3, n//2 + 1)",
                ))
                continue
            a, b, d = fit
            counts = sorted(g.coeffs.items(), key=lambda kv: kv[0].idx)
            table[name] = GuardInfo(
                name=name, kind=G_THRESHOLD,
                threshold=Threshold(
                    op=g.op,
                    counts=tuple(c.label for c, _k in counts),
                    coeffs=tuple(k for _c, k in counts),
                    a=a, b=b, d=d,
                ),
            )
        elif g.kind == G_DATA:
            data_guards.append(name)
            table[name] = GuardInfo(name=name, kind=G_DATA, detail=g.detail)
        else:
            table[name] = GuardInfo(name=name, kind=g.kind, detail=g.detail)
    return table, first.bool_outs, data_guards


def _truth_tables_consistent(samples: List[_RoundSample]) -> bool:
    """The per-field boolean update functions must agree across samples
    (same atoms, same table) — the control structure is n-independent."""
    first = samples[0]
    for s in samples[1:]:
        if set(s.bool_outs) != set(first.bool_outs):
            return False
        for field, expr in first.bool_outs.items():
            other = s.bool_outs[field]
            if isinstance(expr, BExpr) != isinstance(other, BExpr):
                return False
            if not isinstance(expr, BExpr):
                continue
            atoms = sorted(expr.atoms() | other.atoms())
            if len(atoms) > 14:
                return False
            for bits in itertools.product([False, True], repeat=len(atoms)):
                env = dict(zip(atoms, bits))
                if expr.ev(env) != other.ev(env):
                    return False
    return True



def _init_locations(build_at, n: int, device) -> List[Dict[str, bool]]:
    """Concrete per-lane boolean valuations of the initial state."""
    algo, io = build_at(n)
    state = init_state(algo, io, n, device)
    vals: List[Dict[str, bool]] = []
    bool_fields = [(name, leaf.cpu().numpy())
                   for name, leaf in _flatten_fields(state)
                   if _is_control(leaf)]
    for lane in range(n):
        v = {name: bool(leaf[lane]) for name, leaf in bool_fields}
        if v not in vals:
            vals.append(v)
    return vals



def _build_rules(per_round: List[Tuple[Dict[str, GuardInfo], Dict[str, Any]]],
                 init_locs: List[Dict[str, bool]],
                 fields: List[str],
                 problems: List[_Problem]) -> Tuple[List[Rule], List[Dict]]:
    """Close the init locations under the per-round boolean transition
    functions (round-robin over the phase) and emit location-changing
    rules with cube-reduced guards."""
    reachable: List[Dict[str, bool]] = [dict(v) for v in init_locs]
    rules: Dict[Tuple, List[Dict[str, bool]]] = {}

    def transition(round_idx, loc: Dict[str, bool]):
        table, outs = per_round[round_idx]
        guard_atoms = sorted(set().union(*[
            expr.atoms() for expr in outs.values()
            if isinstance(expr, BExpr)
        ]) - {f"state:{f}" for f in fields}) if outs else []
        if len(guard_atoms) > 10:
            problems.append(_Problem(
                "guard-explosion", round_idx,
                f"round {round_idx} control depends on {len(guard_atoms)} "
                "guard atoms — beyond the enumerable automaton fragment",
                "factor the round's decision logic into fewer guards",
            ))
            return
        opaque = [f for f, e in outs.items() if not isinstance(e, BExpr)]
        if opaque:
            problems.append(_Problem(
                "opaque-control", round_idx,
                f"round {round_idx}: boolean state field(s) "
                f"{', '.join(sorted(opaque))} are not a recoverable "
                "function of guards (sequential fold / data-dependent "
                "control)",
                "use vectorized masked updates (torch.where / |) over "
                "explicit quorum guards, or baseline with a reason",
            ))
            return
        base_env = {f"state:{f}": loc.get(f, False) for f in fields}
        for bits in itertools.product([False, True],
                                      repeat=len(guard_atoms)):
            env = dict(base_env)
            env.update(zip(guard_atoms, bits))
            new = {f: outs[f].ev(env) if f in outs else loc.get(f, False)
                   for f in fields}
            if new != loc:
                key = (round_idx, _loc_key(loc), _loc_key(new),
                       tuple(guard_atoms))
                rules.setdefault(key, []).append(dict(zip(guard_atoms, bits)))
            if new not in reachable:
                reachable.append(new)

    # fixpoint over the cyclic round structure
    changed = True
    iterations = 0
    while changed and iterations < 32:
        changed = False
        snapshot = [dict(v) for v in reachable]
        before = len(reachable)
        for round_idx in range(len(per_round)):
            for loc in snapshot:
                transition(round_idx, loc)
        if len(reachable) != before:
            changed = True
        iterations += 1
    if changed:
        # non-convergence would silently drop reachable locations/rules
        # and let param VCs "prove" over an incomplete automaton — refuse
        # instead (the extractor's contract)
        problems.append(_Problem(
            "guard-explosion", 0,
            f"location reachability did not converge in {iterations} "
            f"sweeps ({len(reachable)} locations and growing)",
            "the boolean control space is beyond the enumerable "
            "automaton fragment",
        ))

    out_rules: List[Rule] = []
    for (round_idx, src, dst, atoms), assigns in sorted(rules.items()):
        for cube in _cube_reduce(assigns, list(atoms)):
            out_rules.append(Rule(round=round_idx, src=src, dst=dst,
                                  guard=cube))
    return out_rules, reachable


def extract_automaton_from(
    build_at: Callable[[int], Tuple[Any, Any]],
    name: str,
    samples: Sequence[int] = DEFAULT_SAMPLES,
    strict: bool = True,
    device=None,
) -> Tuple[Optional[ThresholdAutomaton], List[_Problem]]:
    """Extract the threshold automaton for a model, tracing on ``device``
    (the card unless the caller names one; round_tpu/analysis/
    threshold.py::extract_automaton_from).  With strict=True any
    extraction problem raises ThresholdExtractionError (the refuse-rather-
    than-mis-extract contract); with strict=False problems are returned
    for the lint rule to report."""
    device = resolve_device(device)
    problems: List[_Problem] = []
    algo0, _io0 = build_at(samples[0])
    n_rounds = len(algo0.rounds)
    envelope = parse_envelope(getattr(algo0, "fault_envelope", None))

    # trace every round at every sample (one model object per sample, so
    # the rolled states stay those of the rounds traced)
    per_round_samples: List[List[_RoundSample]] = []
    built = {n: build_at(n) for n in samples}
    rolled: Dict[Tuple[int, int], Any] = {}
    for j in range(n_rounds):
        row: List[_RoundSample] = []
        for n in samples:
            algo, io = built[n]
            try:
                row.append(_trace_round(name, n, algo, io, j,
                                        algo.rounds[j], device, rolled))
            except ThresholdExtractionError:
                raise
            except Exception as e:  # noqa: BLE001 — refuse with context
                problems.append(_Problem(
                    "trace", j,
                    f"round {j} failed to trace at n={n}: "
                    f"{type(e).__name__}: {str(e).splitlines()[0][:200]}",
                    "fix the roundlint comm-closure findings first",
                ))
                row = []
                break
        if not row:
            if strict:
                _raise_problems(name, problems)
            return None, problems
        per_round_samples.append(row)

    guards: Dict[str, GuardInfo] = {}
    per_round: List[Tuple[Dict[str, GuardInfo], Dict[str, Any]]] = []
    data_guard_names: List[str] = []
    for j, row in enumerate(per_round_samples):
        if not _truth_tables_consistent(row):
            problems.append(_Problem(
                "sample-inconsistent", j,
                f"round {j}'s boolean control function differs across "
                f"group sizes ({[s.n for s in row]})",
                "control flow must be a fixed function of the guards, "
                "independent of the concrete n",
            ))
        table, outs, data = _match_round(row, j, problems)
        guards.update(table)
        data_guard_names.extend(data)
        per_round.append((table, outs))

    # data-dependent guards only matter when they steer CONTROL
    control_atoms = set().union(*[
        expr.atoms()
        for _t, outs in per_round
        for expr in outs.values() if isinstance(expr, BExpr)
    ]) if per_round else set()
    for gname in data_guard_names:
        if gname in control_atoms:
            rnd = int(gname[1:].split(".", 1)[0])
            problems.append(_Problem(
                "data-dependent", rnd,
                f"round {rnd}: control is guarded by {gname} — a message "
                f"count compared against a data-dependent bound "
                f"({guards[gname].detail})",
                "threshold automata need count-vs-affine(n) guards; make "
                "the bound a function of ctx.n, or baseline with a reason",
            ))

    fields = sorted(set().union(*[set(outs) for _t, outs in per_round])
                    ) if per_round else []
    init_locs = _init_locations(build_at, samples[0], device)
    rule_list, reachable = _build_rules(per_round, init_locs, fields,
                                        problems)

    if problems and strict:
        _raise_problems(name, problems)
    if problems:
        return None, problems

    # drop guard-table entries no rule references (mask-construction
    # artifacts like the unicast dest compare)
    used = set()
    for r in rule_list:
        used.update(a for a, _pol in r.guard)
    guards = {k: v for k, v in guards.items()
              if k in used or v.kind == G_THRESHOLD}

    automaton = ThresholdAutomaton(
        protocol=name,
        n_samples=tuple(samples),
        fields=tuple(fields),
        locations=tuple(_loc_key(v) for v in reachable),
        init_locations=tuple(_loc_key(v) for v in init_locs),
        rules=tuple(rule_list),
        guards=guards,
        resilience=envelope,
        rounds_per_phase=n_rounds,
    )
    return automaton, []


def _raise_problems(name: str, problems: List[_Problem]):
    lines = [f"{name}: threshold extraction refused "
             f"({len(problems)} problem(s)):"]
    lines += [f"  [{p.rule}] {p.message}" for p in problems]
    raise ThresholdExtractionError("\n".join(lines))


def extract_automaton(
    model: str,
    samples: Sequence[int] = DEFAULT_SAMPLES,
    device=None,
) -> ThresholdAutomaton:
    """Extract the threshold automaton of a REGISTERED model (the model
    must declare build_at — see analysis/registry.py), tracing on
    ``device`` (the card unless the caller names one; round_tpu/analysis/
    threshold.py::extract_automaton).  Memoized per
    (model, samples, device): extraction is deterministic over the
    registry's code, and callers treat the automaton as read-only (the CLI
    extracts twice per suite — once for the VC hash, once for the run)."""
    return _extract_cached(model, tuple(samples),
                           str(resolve_device(device)))


@functools.lru_cache(maxsize=64)
def _extract_cached(model: str, samples: Tuple[int, ...], device: str):
    from round_tpu_torch.analysis.registry import get

    entry = get(model)
    if entry.build_at is None:
        raise ThresholdExtractionError(
            f"{model}: registry entry has no build_at constructor — the "
            "model is outside the parameterized pass's scope"
        )
    automaton, _problems = extract_automaton_from(
        entry.build_at, model, samples, strict=True, device=device)
    assert automaton is not None
    return automaton


# ---------------------------------------------------------------------------
# The `threshold-extractable` lint rule family
# ---------------------------------------------------------------------------

def threshold_rules(entry, device=None) -> List[Finding]:
    """Lint findings for one registry entry: every reason the extractor
    cannot recover the model's quorum guards as threshold expressions,
    traced on ``device`` (the card unless the caller names one;
    round_tpu/analysis/threshold.py::threshold_rules).  Models without
    build_at are out of scope (no findings)."""
    if getattr(entry, "build_at", None) is None:
        return []
    algo, _io = entry.build()
    findings: List[Finding] = []
    try:
        _automaton, problems = extract_automaton_from(
            entry.build_at, entry.name, LINT_SAMPLES, strict=False,
            device=device)
    except ThresholdExtractionError as e:
        problems = [_Problem("trace", 0, str(e).splitlines()[0], "")]
    except Exception as e:  # noqa: BLE001 — an extractor crash IS a finding
        problems = [_Problem(
            "trace", 0,
            f"extractor crashed: {type(e).__name__}: "
            f"{str(e).splitlines()[0][:200]}",
            "report/fix analysis/threshold.py",
        )]
    seen = set()
    for p in problems:
        rnd = algo.rounds[p.round] if p.round < len(algo.rounds) else None
        anchor = _fn_anchor(type(rnd).update) if rnd is not None \
            else (relpath(__file__), 0)
        key = (p.rule, anchor, p.message)
        if key in seen:
            continue
        seen.add(key)
        findings.append(Finding(
            rule=f"threshold-extractable/{p.rule}",
            severity="warn",
            model=entry.name,
            file=anchor[0],
            line=anchor[1],
            message=p.message,
            hint=p.hint,
        ))
    return findings
