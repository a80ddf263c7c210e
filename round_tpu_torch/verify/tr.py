"""Transition relations: the formula-level model of one round.

Reference parity: psync.verification.RoundTransitionRelation
(verification/TransitionRelation.scala:11-154).  The reference extracts
send/update formulas from Scala trees with macros; here the round is modeled
directly in the formula DSL (the jaxpr extractor in extract.py can derive
the update equations from per-lane JAX code for supported ops).

Modeling (one round, n processes, HO semantics):
  * every per-process state field f becomes a function  f : ProcessID → T
    (localization, verification/Utils.scala:43-49); its primed version f′
    holds the post-round value (primeFormula, TransitionRelation.scala:145).
  * the send phase defines payload functions  snd_p : ProcessID → T  (what i
    would send) and a dest relation  dest(i, j)  (does i address j).
  * the mailbox of receiver j is the *set of senders heard*:
        mb(j) = { i | i ∈ HO(j) ∧ dest(i, j) }
    — this IS the mailboxLink axiom (TransitionRelation.scala:73-91): a
    payload from i reaches j iff i ∈ HO(j) and i sent to j, and
    |mb(j)| ≤ |HO(j)| follows from the comprehension.  Receiver j reads i's
    payload as snd_p(i) (communication-closed rounds: no cross-round mixing).
  * the update phase is a conjunction of equations defining each primed
    field of j from unprimed fields and mailbox comprehensions.

Port of round_tpu/verify/tr.py, copied with only the package name changed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from round_tpu_torch.verify.formula import (
    And, Application, Binding, Bool, Card, Comprehension, Eq, FORALL, FSet,
    Formula, FunT, Implies, IN, In, Int, TRUE, Type, UnInterpretedFct,
    Variable, procType,
)
from round_tpu_torch.verify.futils import fmap


# ---------------------------------------------------------------------------
# State signature: per-process fields as localized functions
# ---------------------------------------------------------------------------

class StateSig:
    """The per-process state fields of a protocol, as ProcessID→T functions
    plus their primed (post-round) versions."""

    def __init__(self, fields: Dict[str, Type]):
        self.fields = dict(fields)
        self.fns: Dict[str, UnInterpretedFct] = {
            name: UnInterpretedFct(name, FunT([procType], t))
            for name, t in fields.items()
        }
        self.primed_fns: Dict[str, UnInterpretedFct] = {
            name: UnInterpretedFct(name + "!prime", FunT([procType], t))
            for name, t in fields.items()
        }

    def get(self, name: str, i: Formula) -> Formula:
        f = Application(self.fns[name], [i])
        f.tpe = self.fields[name]
        return f

    def get_primed(self, name: str, i: Formula) -> Formula:
        f = Application(self.primed_fns[name], [i])
        f.tpe = self.fields[name]
        return f

    def prime(self, f: Formula) -> Formula:
        """Rewrite every unprimed field application to its primed twin
        (primeFormula, TransitionRelation.scala:145-152)."""
        by_name = {fn.name: self.primed_fns[name]
                   for name, fn in self.fns.items()}

        def step(g: Formula) -> Formula:
            if isinstance(g, Application) and isinstance(g.fct, UnInterpretedFct) \
                    and g.fct.name in by_name:
                h = Application(by_name[g.fct.name], g.args)
                h.tpe = g.tpe
                return h
            return g

        return fmap(step, f)

    def frame_equal(self, names: Sequence[str], i: Variable) -> Formula:
        """f′(i) = f(i) for the given fields (unchanged-by-this-round)."""
        return And(*[Eq(self.get_primed(n, i), self.get(n, i)) for n in names])


# The Heard-Of assignment of the round: HO : ProcessID → Set[ProcessID]
HO_FN = UnInterpretedFct("HO", FunT([procType], FSet(procType)))


def ho_of(j: Formula) -> Formula:
    f = Application(HO_FN, [j])
    f.tpe = FSet(procType)
    return f


class Mailbox:
    """Receiver j's view of the round's messages (the mailboxLink semantics,
    TransitionRelation.scala:73-91)."""

    def __init__(self, tr: "RoundTR", j: Formula):
        self.tr = tr
        self.j = j

    def senders(self) -> Formula:
        """{ i | i ∈ HO(j) ∧ dest(i, j) } — the set of heard senders."""
        i = Variable(f"mbi!{id(self) % 10_000}", procType)
        return Comprehension([i], And(In(i, ho_of(self.j)),
                                      self.tr.dest(i, self.j)))

    def senders_where(self, pred: Callable[[Formula], Formula]) -> Formula:
        """{ i ∈ mb(j) | pred(i) } — e.g. senders whose payload equals v."""
        i = Variable(f"mbw!{id(self) % 10_000}", procType)
        return Comprehension(
            [i],
            And(In(i, ho_of(self.j)), self.tr.dest(i, self.j), pred(i)),
        )

    def size(self) -> Formula:
        return Card(self.senders())

    def payload(self, name: str, i: Formula) -> Formula:
        """Payload field `name` as received from sender i (= what i sent —
        communication-closed rounds)."""
        return self.tr.payload(name, i)


@dataclasses.dataclass
class RoundTR:
    """One round's transition relation.

    payload_defs: name → (i → defining Formula): what process i puts in the
      payload field (send phase).  The payload function snd_name(i) is
      axiomatized as equal to this definition for all i.
    dest_fn: (i, j) → Formula: does i address j (broadcast = True).
    update_fn: (j, mailbox, sig) → Formula: conjunction of equations pinning
      every primed field of j (use sig.frame_equal for untouched fields).
    aux: extra axioms (e.g. properties of an uninterpreted min-most-often
      function), the AuxiliaryMethod mechanism (AuxiliaryMethod.scala:9-67).
    """

    sig: StateSig
    payload_defs: Dict[str, Tuple[Type, Callable[[Formula], Formula]]]
    update_fn: Callable[["Mailbox", Formula, StateSig], Formula]
    dest_fn: Optional[Callable[[Formula, Formula], Formula]] = None
    aux: Optional[Callable[[], List[Formula]]] = None

    def __post_init__(self):
        self._payload_fns: Dict[str, UnInterpretedFct] = {
            name: UnInterpretedFct(f"snd!{name}!{id(self) % 10_000}",
                                   FunT([procType], t))
            for name, (t, _def) in self.payload_defs.items()
        }

    def payload(self, name: str, i: Formula) -> Formula:
        f = Application(self._payload_fns[name], [i])
        f.tpe = self.payload_defs[name][0]
        return f

    def dest(self, i: Formula, j: Formula) -> Formula:
        if self.dest_fn is None:
            return TRUE  # broadcast
        return self.dest_fn(i, j)

    def full_tr(self) -> Formula:
        """The complete round formula (makeFullTr,
        TransitionRelation.scala:118-132): payload definitions ∀i, update
        equations ∀j, plus aux axioms."""
        parts: List[Formula] = []
        i = Variable("tri", procType)
        for name, (_t, defn) in self.payload_defs.items():
            parts.append(
                Binding(FORALL, [i],
                        Eq(self.payload(name, i), defn(i))).with_type(Bool)
            )
        j = Variable("trj", procType)
        mb = Mailbox(self, j)
        parts.append(
            Binding(FORALL, [j], self.update_fn(mb, j, self.sig)).with_type(Bool)
        )
        if self.aux is not None:
            parts.extend(self.aux())
        return And(*parts)
