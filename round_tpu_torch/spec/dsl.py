"""The spec DSL: quantified formulas over process state, as torch reductions.

Port of round_tpu/spec/dsl.py.  Users write specs almost verbatim from the
reference (e.g. Otr.scala:94-120):

    def agreement(e):
        P = e.P
        return P.forall(lambda i: P.forall(lambda j: implies(
            i.decided & j.decided, i.decision == j.decision)))

Each formula is a function of an Env — the evaluation context holding the
current state, the previous-round snapshot (``old``), the initial snapshot
(``init``), and the round's HO matrix.  Quantifiers evaluate by
``torch.func.vmap`` of the body over a fresh lane axis (round_tpu:
``jax.vmap``), so nesting composes.

View semantics (reference: SpecHelper, Specs.scala:21-28):
    i.x          — field x of process i (any field of the state pytree)
    i.id         — i's ProcessID
    i.HO         — i's heard-of set this round (SetView over the HO row)
    i.old.x      — x at the previous step   (old(i.x))
    i.init.x     — x at initialization      (init(i.x))

State fields named ``old``, ``init``, ``id`` or ``HO`` would shadow these
accessors; the framework's algorithms avoid those names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
from torch.func import vmap

from round_tpu_torch.utils.tree import tree_leaves


def implies(a, b):
    """``a ==> b`` (SpecHelper.BoolOps, Specs.scala:22-24;
    round_tpu/spec/dsl.py::implies)."""
    return torch.logical_or(torch.logical_not(torch.as_tensor(a)),
                            torch.as_tensor(b))


class SpecFieldError(AttributeError):
    """A spec formula referenced a state field that does not exist
    (round_tpu/spec/dsl.py::SpecFieldError).

    Carries the missing field, the fields that do exist, and — once the
    checker attaches it via :meth:`with_formula` — the formula being
    evaluated."""

    def __init__(self, field, available, where="state", formula=None):
        self.field = field
        self.available = tuple(available)
        self.where = where
        self.formula = formula
        at = f" (while evaluating {formula})" if formula else ""
        super().__init__(
            f"spec formula references unknown {where} field {field!r}{at}; "
            f"the state pytree has fields: {', '.join(self.available) or '<none>'}"
        )

    def with_formula(self, name: str) -> "SpecFieldError":
        """A copy of this error naming the formula it came from."""
        return SpecFieldError(self.field, self.available, self.where, name)


def _state_fields(state) -> tuple:
    """Field names of a state pytree (a ``struct`` dataclass in this
    package; dicts by key; else non-private instance attributes)."""
    if dataclasses.is_dataclass(state):
        return tuple(f.name for f in dataclasses.fields(state))
    if isinstance(state, dict):
        return tuple(state)
    return tuple(k for k in vars(state) if not k.startswith("_")) \
        if hasattr(state, "__dict__") else ()


def _field(state, name, where):
    """getattr with the friendly error (dict states get the same message)."""
    if isinstance(state, dict):
        try:
            return state[name]
        except KeyError:
            raise SpecFieldError(name, _state_fields(state), where) from None
    try:
        return getattr(state, name)
    except AttributeError:
        raise SpecFieldError(name, _state_fields(state), where) from None


def _at(v, idx):
    """``v[idx]`` along the lane axis.  A 0-d index tensor is gathered as a
    [1] index on the device: indexing with it directly reads it to the
    host first (a sync per call on the card; ``e.proc`` of a round-derived
    coordinator is such an index)."""
    if isinstance(idx, torch.Tensor) and idx.dim() == 0:
        return v[idx.reshape(1)][0]
    return v[idx]


class _Snapshot:
    """Field accessor over a state snapshot at a fixed lane index."""

    __slots__ = ("_state", "_idx", "_where")

    def __init__(self, state, idx, where="state"):
        self._state = state
        self._idx = idx
        self._where = where

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return _at(_field(self._state, name, self._where), self._idx)


class ProcView:
    """One process's view of the world inside a quantifier body
    (round_tpu/spec/dsl.py::ProcView)."""

    __slots__ = ("_env", "_idx")

    def __init__(self, env: "Env", idx):
        self._env = env
        self._idx = idx

    @property
    def id(self):
        return self._idx

    @property
    def HO(self) -> "SetView":
        ho = self._env.ho
        if ho is None:
            raise ValueError("this Env carries no HO matrix (pass ho= to Env)")
        return SetView(_at(ho, self._idx))

    @property
    def old(self) -> _Snapshot:
        if self._env.old is None:
            raise ValueError("this Env carries no previous-round snapshot")
        return _Snapshot(self._env.old, self._idx, where="old-snapshot")

    @property
    def init(self) -> _Snapshot:
        if self._env.init0 is None:
            raise ValueError("this Env carries no init snapshot")
        return _Snapshot(self._env.init0, self._idx, where="init-snapshot")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return _at(_field(self._env.state, name, "state"), self._idx)

    def __eq__(self, other):
        if isinstance(other, ProcView):
            return self._idx == other._idx
        return self._idx == other

    def __ne__(self, other):
        return torch.logical_not(torch.as_tensor(self.__eq__(other)))

    __hash__ = None


class SetView:
    """A set of processes as an [n] membership mask (HO sets, filter
    results; round_tpu/spec/dsl.py::SetView): size (Cardinality), contains
    (∈), == (extensional equality), ∪/∩/⊆."""

    __slots__ = ("mask",)

    def __init__(self, mask: torch.Tensor):
        self.mask = mask

    @property
    def size(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum(dtype=torch.int32)

    def contains(self, p) -> torch.Tensor:
        idx = p._idx if isinstance(p, ProcView) else p
        return self.mask[idx]

    def subset_of(self, other: "SetView") -> torch.Tensor:
        return implies(self.mask, other.mask).all()

    def __eq__(self, other):
        if isinstance(other, SetView):
            return (self.mask == other.mask).all()
        return NotImplemented

    def __ne__(self, other):
        return torch.logical_not(self.__eq__(other))

    def __and__(self, other):
        return SetView(self.mask & other.mask)

    def __or__(self, other):
        return SetView(self.mask | other.mask)

    __hash__ = None


class ProcDomain:
    """The process domain ``P`` (Algorithm.scala:91-95 Domain ops;
    round_tpu/spec/dsl.py::ProcDomain).  Quantifiers vmap the body over the
    lane ids."""

    def __init__(self, env: "Env"):
        self._env = env

    def _over_lanes(self, f: Callable[[ProcView], Any]) -> torch.Tensor:
        env = self._env
        ids = torch.arange(env.n, dtype=torch.int32, device=env.device)
        return vmap(lambda i: torch.as_tensor(f(ProcView(env, i))))(ids)

    def forall(self, f) -> torch.Tensor:
        return self._over_lanes(f).all()

    def exists(self, f) -> torch.Tensor:
        return self._over_lanes(f).any()

    def filter(self, f) -> SetView:
        return SetView(self._over_lanes(f))

    def count(self, f) -> torch.Tensor:
        return self.filter(f).size


class ValueDomain:
    """A finite value domain ``V`` with explicit witness candidates
    (round_tpu/spec/dsl.py::ValueDomain).

    The reference's ``Domain[Int].exists`` quantifies over the full type
    and relies on the solver to find witnesses; the checker quantifies
    over an explicit candidate array.  For the consensus specs the
    candidates are the current/initial estimates — any satisfying value
    must occur in the state, so checking over them is exact."""

    def __init__(self, candidates: torch.Tensor):
        self.candidates = torch.as_tensor(candidates).reshape(-1)

    def exists(self, f) -> torch.Tensor:
        return vmap(lambda v: torch.as_tensor(f(v)))(self.candidates).any()

    def forall(self, f) -> torch.Tensor:
        return vmap(lambda v: torch.as_tensor(f(v)))(self.candidates).all()


class SetDomain:
    """The domain ``S`` of process sets, witnessed by the round's HO rows
    (round_tpu/spec/dsl.py::SetDomain).  Sound for specs of the shape
    ``S.exists(s => P.forall(p => p.HO == s && ...))`` (OTR's goodRound,
    Otr.scala:95): any witness equal to every HO row is itself an HO row."""

    def __init__(self, env: "Env"):
        self._env = env

    def exists(self, f) -> torch.Tensor:
        env = self._env
        if env.ho is None:
            raise ValueError("set domain needs an HO matrix in the Env")
        ids = torch.arange(env.n, dtype=torch.int32, device=env.device)
        return vmap(lambda i: torch.as_tensor(f(SetView(env.ho[i]))))(
            ids).any()


@dataclasses.dataclass
class Env:
    """Evaluation context for one (state, old, init, HO) snapshot
    (round_tpu/spec/dsl.py::Env).  Leaves of ``state``/``old``/``init0``
    are [n, ...] (one trace step, one scenario)."""

    state: Any
    n: int
    old: Any = None
    init0: Any = None
    ho: Optional[torch.Tensor] = None
    r: Any = 0

    @property
    def device(self) -> torch.device:
        """The device the state lives on (quantifier index tensors and
        literal candidate arrays are made there)."""
        leaves = tree_leaves(self.state)
        return leaves[0].device if leaves else torch.device("cpu")

    @property
    def P(self) -> ProcDomain:
        return ProcDomain(self)

    @property
    def S(self) -> SetDomain:
        return SetDomain(self)

    def values(self, *arrays) -> ValueDomain:
        """Value domain whose candidates are the concatenation of the given
        arrays (e.g. ``e.values(e.state.x)``)."""
        dev = self.device
        return ValueDomain(torch.cat(
            [torch.as_tensor(a, device=dev).reshape(-1) for a in arrays]))

    def proc(self, idx) -> ProcView:
        """View a specific process (e.g. the current phase's coordinator —
        the spec-only ``coord`` of LastVoting.scala:17)."""
        return ProcView(self, torch.as_tensor(idx, dtype=torch.int32,
                                              device=self.device))


Formula = Callable[[Env], torch.Tensor]


class Spec:
    """Mirror of the reference Spec trait (Specs.scala:9-19;
    round_tpu/spec/dsl.py::Spec).

    Fields (all optional, all formulas are ``Env -> bool scalar``):
      safety_predicate: network assumption required for safety (checked as a
        precondition on each round's HO; e.g. BenOr needs majority HO).
      liveness_predicate: per-phase-in-the-invariant-chain "magic round"
        conditions.
      invariants: the invariant chain; the checker reports which (if any)
        holds at each step.
      round_invariants: per-round-in-phase extra invariants.
      properties: named properties; safety ones are checked at every step,
        Termination-style ones at the end of the run.
    """

    safety_predicate: Optional[Formula] = None
    liveness_predicate: Sequence[Formula] = ()
    invariants: Sequence[Formula] = ()
    round_invariants: Sequence[Sequence[Formula]] = ()
    properties: Sequence[Tuple[str, Formula]] = ()


class TrivialSpec(Spec):
    """No constraints (Specs.scala:37-41)."""
