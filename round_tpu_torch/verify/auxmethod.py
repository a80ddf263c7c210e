"""AuxiliaryMethod: require/ensuring lifting for round-code helpers.

Port of round_tpu/verify/auxmethod.py.  Reference parity: psync lifts a
helper's `require`/`ensuring` clauses into an AuxiliaryMethod pre/post spec
at macro time (TrExtractor.scala:78-99, AuxiliaryMethod.scala:9-67); call
sites inline the post as an assumption (TransitionRelation.scala:93-111)
and the pre becomes a proof obligation.

round_tpu gets the boundary from a named ``jax.jit``; the port gets it from
``torch.library``: decorating a helper with ``@aux_method(pre=..., post=...)``
registers it as a custom operator ``rtaux::<name>`` with a fake
implementation, and while a round is traced for extraction
(``verify/extract.py::extract_lane_fn``) every call goes through that
operator, so the aten graph holds ONE opaque node per call.  The extractor
intercepts the node by its namespace and name instead of looking inside,
models the call as an uninterpreted application over the argument
formulas, assumes ``post(result, *args)`` as a site axiom, and records
``pre(*args)`` as a proof obligation for the verifier.  Outside extraction
the decorator is transparent: the engine calls the helper itself.

    @aux_method(post=lambda r, a, b: And(Geq(r, a), Geq(r, b)))
    def imax(a, b):
        return torch.maximum(a, b)
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import warnings
from typing import Callable, Dict, Optional

import torch


def _contract_src(pre, post) -> tuple:
    """Comparable identity of a (pre, post) pair: bytecode + names +
    captured values (line numbers excluded, so the same lambda re-defined
    on a different line still counts as the same contract; closure cells
    and defaults included, so a contract change routed through a captured
    variable is still detected)."""

    seen: set = set()

    def type_key(x):
        return ("obj", type(x).__module__, type(x).__qualname__)

    def ident(x, depth):
        if callable(x):
            return one(x, depth)
        try:
            r = repr(x)
        except Exception:  # noqa: BLE001 - identity only, never raise
            return type_key(x)
        if " at 0x" in r:
            # default object repr embeds the address: compares unequal on
            # every reload — fall back to type identity (same tradeoff as
            # exotic callables below)
            return type_key(x)
        return r

    def one(f, depth=0):
        if f is None:
            return None
        if depth > 8 or id(f) in seen:
            # cycle (e.g. a self-recursive helper captured in a closure
            # cell) or pathological nesting: stop at type identity
            return type_key(f)
        seen.add(id(f))
        if isinstance(f, functools.partial):
            return (
                "partial", one(f.func, depth + 1),
                tuple(ident(a, depth + 1) for a in f.args),
                tuple(sorted(
                    (k, ident(v, depth + 1)) for k, v in f.keywords.items()
                )),
            )
        try:
            c = f.__code__
        except AttributeError:
            # exotic callable: same type counts as same contract (avoids
            # spurious warnings on every reload; changes inside such
            # objects are invisible to this check)
            return type_key(f)
        consts = tuple(
            x.co_code if hasattr(x, "co_code") else x for x in c.co_consts
        )

        def cell_val(cell):
            try:
                return ident(cell.cell_contents, depth + 1)
            except ValueError:  # empty cell
                return "<empty-cell>"

        closure = tuple(cell_val(cell) for cell in (f.__closure__ or ()))
        defaults = tuple(ident(d, depth + 1) for d in (f.__defaults__ or ()))
        return (c.co_code, c.co_names, c.co_varnames, consts, closure,
                defaults)

    return (one(pre), one(post))


# the reserved operator namespace marking aux boundaries: a user's own
# custom operator cannot be mistaken for an aux unless it deliberately
# lives in "rtaux" (round_tpu reserves the jit-name prefix "rtaux!")
AUX_NAMESPACE = "rtaux"


@dataclasses.dataclass(frozen=True)
class AuxSpec:
    """Pre/post spec of a helper (AuxiliaryMethod.scala:9-67).

    pre:  (*arg_formulas) -> Formula — obligation at every call site.
    post: (result_formula, *arg_formulas) -> Formula — assumed axiom.
    """

    name: str
    pre: Optional[Callable] = None
    post: Optional[Callable] = None
    fn_qualname: str = ""


REGISTRY: Dict[str, AuxSpec] = {}
# the helper each name currently runs (a tolerated re-registration swaps
# it; the operator, defined once per name, always calls the current one)
_IMPLS: Dict[str, Callable] = {}
_OPS: Dict[str, Callable] = {}

# set by extract_lane_fn while it traces: only then do helpers route
# through their operator
_TRACING = contextvars.ContextVar("aux_tracing", default=False)


@contextlib.contextmanager
def tracing():
    """Within this context, @aux_method helpers call their custom operator
    (one opaque graph node per call) instead of running inline."""
    tok = _TRACING.set(True)
    try:
        yield
    finally:
        _TRACING.reset(tok)


def _operator(nm: str, arity: int):
    """The custom operator ``rtaux::<nm>`` taking ``arity`` tensors, defined
    at the first traced call.  Its implementation (real and fake alike)
    runs the registered helper; the result is copied so that it never
    aliases an input, which a custom operator may not do."""
    op = _OPS.get(nm)
    if op is not None:
        if op.arity != arity:
            raise ValueError(
                f"aux method {nm!r} called with {arity} arguments, "
                f"traced before with {op.arity}"
            )
        return op
    params = ", ".join(f"Tensor a{k}" for k in range(arity))

    def impl(*args):
        return torch.as_tensor(_IMPLS[nm](*args)).clone()

    op = torch.library.custom_op(
        f"{AUX_NAMESPACE}::{nm}", impl, mutates_args=(),
        schema=f"({params}) -> Tensor",
    )
    op.register_fake(impl)
    op.arity = arity
    _OPS[nm] = op
    return op


def aux_method(pre: Optional[Callable] = None,
               post: Optional[Callable] = None,
               name: Optional[str] = None):
    """Register a helper's pre/post spec and give it an operator boundary
    the extractor can see (round_tpu/verify/auxmethod.py::aux_method).  The
    reference's @requires/@ensures annotations
    (verification/Annotations.scala:12-32) by decorator."""

    def deco(fn):
        nm = name or fn.__name__
        qual = f"{fn.__module__}.{fn.__qualname__}"
        prev = REGISTRY.get(nm)
        if prev is not None and prev.fn_qualname != qual:
            # same-name re-registration of the SAME function (module
            # reloads, dual import paths) is tolerated; a different
            # function must pick its own name
            raise ValueError(
                f"aux method name {nm!r} already registered by "
                f"{prev.fn_qualname}; pass an explicit name= to "
                "disambiguate"
            )
        if prev is not None and _contract_src(prev.pre, prev.post) != \
                _contract_src(pre, post):
            # tolerated re-registration, but the CONTRACT changed: formulas
            # extracted before the reload baked in the old pre/post, so a
            # weaker replacement could silently supersede obligations
            # already assumed elsewhere
            warnings.warn(
                f"aux method {nm!r} re-registered with a different pre/post "
                "contract; formulas extracted earlier used the previous one "
                "— re-run extraction",
                stacklevel=3,
            )
        REGISTRY[nm] = AuxSpec(name=nm, pre=pre, post=post,
                               fn_qualname=qual)
        _IMPLS[nm] = fn

        @functools.wraps(fn)
        def wrapped(*args):
            if not _TRACING.get():
                return fn(*args)
            dev = next((a.device for a in args
                        if isinstance(a, torch.Tensor)), None)
            targs = [a if isinstance(a, torch.Tensor)
                     else torch.as_tensor(a, device=dev) for a in args]
            return _operator(nm, len(targs))(*targs)

        wrapped.aux_name = nm
        return wrapped

    return deco
