"""OTR — One-Third-Rule consensus.

Port of round_tpu/models/otr.py.  Protocol (example/Otr.scala:56-84):
every round, broadcast x; if more than 2n/3 messages arrive, set x to the
minimum most-often-received value, and if that value itself was received
from more than 2n/3 processes, decide it.  After deciding, keep
participating for `after_decision` more rounds, then exit.

Spec (Otr.scala:95-120): agreement/validity/integrity/irrevocability +
termination under "good rounds"; checked on traces by round_tpu_torch.spec.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.models.common import (
    agreement, ghost_decide, integrity, irrevocability, termination, validity,
)
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.spec.dsl import Spec, implies
from round_tpu_torch.utils.tree import struct


@struct
class OtrState:
    x: torch.Tensor         # current estimate (int32)
    decided: torch.Tensor   # bool
    decision: torch.Tensor  # int32, -1 until decided
    after: torch.Tensor     # rounds left before exiting once decided

    @classmethod
    def fresh(cls, init, S: int, n: int,
              after_decision: int = 2) -> "OtrState":
        """[S, n]-batched undecided state from an [n] initial-value vector,
        on the device of ``init``."""
        init = torch.as_tensor(init)
        dev = init.device
        return cls(
            x=init.to(torch.int32).expand((S, n)).contiguous(),
            decided=torch.zeros((S, n), dtype=torch.bool, device=dev),
            decision=torch.full((S, n), -1, dtype=torch.int32, device=dev),
            after=torch.full((S, n), after_decision, dtype=torch.int32,
                             device=dev),
        )


class OtrRound(Round):
    def __init__(self, n_values: int | None = None):
        # Static value-domain hint: when every estimate lives in
        # [0, n_values) the update counts over the [n, V] histogram instead
        # of the [n, n] sender-equality matrix.
        self.n_values = n_values

    def send(self, ctx: RoundCtx, state: OtrState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: OtrState, mbox: Mailbox) -> OtrState:
        n = ctx.n
        quorum = mbox.size() > (2 * n) // 3
        if self.n_values is not None:
            counts = mbox.value_histogram(self.n_values)
            # first maximum = the smallest most-often-received value (mmor)
            v = torch.argmax(counts).to(state.x.dtype)
            v_count = counts.max()
        else:
            v = mbox.min_most_often_received()
            v_count = mbox.count(lambda vals: vals == v)
        super_quorum = quorum & (v_count > (2 * n) // 3)

        state = ghost_decide(state, super_quorum, v)
        after = torch.where(state.decided, state.after - 1, state.after)
        ctx.exit_at_end_of_round(state.decided & (after <= 0))
        return state.replace(x=torch.where(quorum, v, state.x), after=after)


def _keep_init(e):
    """Every estimate is some process's initial value (Otr.scala:102,107)."""
    P = e.P
    return P.forall(lambda i: P.exists(lambda j: i.x == j.init.x))


def _decided_on(P, v):
    return P.forall(lambda i: implies(i.decided, i.decision == v))


class OtrSpec(Spec):
    """Otr.scala:94-120, checked on traces instead of proven
    (round_tpu/models/otr.py::OtrSpec)."""

    def _good_round(self, e):
        # S.exists(s => P.forall(p => p.HO == s && s.size > 2n/3))  (:95)
        return e.S.exists(
            lambda s: e.P.forall(lambda p: (p.HO == s) & (s.size > 2 * e.n // 3))
        )

    def _inv0(self, e):
        P, V = e.P, e.values(e.state.x)
        no_decision = P.forall(lambda i: ~i.decided)
        quorum_on_v = V.exists(
            lambda v: (P.filter(lambda i: i.x == v).size > 2 * e.n // 3)
            & _decided_on(P, v)
        )
        return (no_decision | quorum_on_v) & _keep_init(e)

    def _inv1(self, e):
        P, V = e.P, e.values(e.state.x)
        all_on_v = V.exists(
            lambda v: (P.filter(lambda i: i.x == v).size == e.n)
            & _decided_on(P, v)
        )
        return all_on_v & _keep_init(e)

    def _inv2(self, e):
        P = e.P
        return P.exists(
            lambda j: P.forall(lambda i: i.decided & (i.decision == j.init.x))
        )

    def __init__(self):
        self.liveness_predicate = (self._good_round, self._good_round)
        self.invariants = (self._inv0, self._inv1, self._inv2)
        self.properties = (
            ("Termination", termination),
            ("Agreement", agreement),
            ("Validity", validity),
            ("Integrity", integrity),
            ("Irrevocability", irrevocability),
        )


class OTR(Algorithm):
    """One-Third-Rule consensus over int payloads."""

    fault_envelope = "n > 3f"

    def __init__(self, after_decision: int = 2, n_values: int | None = None):
        self.after_decision = after_decision
        self.rounds = (OtrRound(n_values=n_values),)
        self.spec = OtrSpec()

    def make_init_state(self, ctx: RoundCtx, io) -> OtrState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        zero = torch.zeros_like(x)
        return OtrState(
            x=x,
            decided=zero != 0,
            decision=zero - 1,
            after=zero + self.after_decision,
        )

    def decided(self, state: OtrState):
        return state.decided

    def decision(self, state: OtrState):
        return state.decision
