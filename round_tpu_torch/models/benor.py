"""Ben-Or — randomized binary consensus (two-round phases, coin flips).

Port of round_tpu/models/benor.py.  Protocol (example/BenOr.scala:11-88,
after Ben-Or PODC'83 with the termination tweak of Aguilera-Toueg):

  phase round 1: broadcast (x, canDecide).  If canDecide: decide(x) and exit.
    Else vote := Some(true) if >n/2 say true or someone who canDecide says
    true; symmetric for false; else None.  canDecide := anyone canDecide.
  phase round 2: broadcast vote.  If >n/2 vote Some(b): x := b, canDecide.
    Else if more than one vote Some(b): x := b.  Else x := coin flip.

The coin is bit 0 of the per-(scenario, process, round) hash word
``ctx.rng`` (round_tpu draws ``jax.random.bernoulli(ctx.rng)``: another
fair coin, never bit-compared), or with ``coin_salt=(salt0, salt1)`` the
deterministic ``ops.fused.hash_coin`` that the fused engines use, so a
FaultMix scenario replays bit-exactly against them.

Option[Boolean] on the wire is an int32 here: vote in
{-1 = None, 0 = Some(false), 1 = Some(true)}.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.models.common import (
    agreement, ghost_decide, irrevocability,
)
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.spec.dsl import Spec, implies
from round_tpu_torch.utils.tree import struct

VOTE_NONE = -1
VOTE_FALSE = 0
VOTE_TRUE = 1


@struct
class BenOrState:
    x: torch.Tensor           # bool estimate
    can_decide: torch.Tensor  # bool
    vote: torch.Tensor        # int32 in {-1, 0, 1}
    decided: torch.Tensor     # bool (ghost)
    decision: torch.Tensor    # bool (ghost)

    @classmethod
    def fresh(cls, init, S: int, n: int) -> "BenOrState":
        """[S, n]-batched undecided state from an [n] initial-bit vector,
        on the device of ``init``."""
        init = torch.as_tensor(init)
        dev = init.device
        false = torch.zeros((S, n), dtype=torch.bool, device=dev)
        return cls(
            x=(init != 0).expand((S, n)).contiguous(),
            can_decide=false,
            vote=torch.full((S, n), VOTE_NONE, dtype=torch.int32, device=dev),
            decided=false,
            decision=false,
        )


class BenOrRound1(Round):
    def send(self, ctx: RoundCtx, state: BenOrState):
        return broadcast(ctx, {"x": state.x, "can": state.can_decide})

    def update(self, ctx: RoundCtx, state: BenOrState, mbox: Mailbox):
        n = ctx.n
        t_cnt = mbox.count(lambda m: m["x"])
        f_cnt = mbox.count(lambda m: ~m["x"])
        t_dec = mbox.exists(lambda m: m["x"] & m["can"])
        f_dec = mbox.exists(lambda m: ~m["x"] & m["can"])

        vote = torch.where(
            (t_cnt > n // 2) | t_dec,
            VOTE_TRUE,
            torch.where((f_cnt > n // 2) | f_dec, VOTE_FALSE, VOTE_NONE),
        ).to(torch.int32)
        can = mbox.exists(lambda m: m["can"])

        # the canDecide branch decides and freezes (exit at end of round);
        # its vote/can updates never matter afterwards but are masked anyway
        deciding = state.can_decide
        ctx.exit_at_end_of_round(deciding)
        state = ghost_decide(state, deciding, state.x)
        return state.replace(
            vote=torch.where(deciding, state.vote, vote),
            can_decide=torch.where(deciding, state.can_decide, can),
        )


class BenOrRound2(Round):
    def __init__(self, coin_salt=None):
        # coin_salt = (salt0, salt1): use the deterministic hash coin
        # (ops.fused.hash_coin) instead of ctx.rng — the differential-parity
        # bridge to the fused engine, same role as hash-mode link masks
        self.coin_salt = coin_salt

    def send(self, ctx: RoundCtx, state: BenOrState):
        return broadcast(ctx, state.vote)

    def update(self, ctx: RoundCtx, state: BenOrState, mbox: Mailbox):
        n = ctx.n
        t = mbox.count(lambda v: v == VOTE_TRUE)
        f = mbox.count(lambda v: v == VOTE_FALSE)
        if self.coin_salt is None:
            coin = (ctx.rng & 1) == 1
        else:
            from round_tpu_torch.ops.fused import hash_coin

            coin = hash_coin(self.coin_salt[0], self.coin_salt[1], ctx.r,
                             ctx.id)

        x = torch.where(
            t > n // 2,
            True,
            torch.where(
                f > n // 2,
                False,
                torch.where(t > 1, True, torch.where(f > 1, False, coin)),
            ),
        )
        can = (t > n // 2) | (f > n // 2) | state.can_decide

        # decided lanes already exited in round 1 of this phase, but keep the
        # update masked for the phase in which they decide
        frozen = state.decided
        return state.replace(
            x=torch.where(frozen, state.x, x),
            can_decide=torch.where(frozen, state.can_decide, can),
        )


class BenOrSpec(Spec):
    """BenOr.scala:92-119, checked on traces
    (round_tpu/models/benor.py::BenOrSpec).

    Safety needs every receiver to hear a majority each round (the spec's
    safetyPredicate, BenOr.scala:96) — under that assumption the invariant
    says: either nobody is committed yet, or a majority holds some value v
    and every decision/defined vote is on v.
    """

    def _safety(self, e):
        return e.P.forall(lambda p: p.HO.size > e.n // 2)

    def _inv0(self, e):
        P = e.P
        V = e.values(torch.tensor([False, True], device=e.device))
        fresh = P.forall(lambda i: ~i.decided & ~i.can_decide)
        locked = V.exists(
            lambda v: (P.filter(lambda i: i.x == v).size > e.n // 2)
            & P.forall(
                lambda i: implies(i.decided, i.decision == v)
                & implies(i.vote != VOTE_NONE, i.vote == v.to(torch.int32))
            )
        )
        return fresh | locked

    def _vote_majority(self, e):
        # roundInvariants[0]: a defined vote names a majority value
        # (BenOr.scala:112-114); holds after the first round of a phase.
        P = e.P
        return P.forall(
            lambda p: implies(
                p.vote != VOTE_NONE,
                P.filter(lambda i: i.x == (p.vote == VOTE_TRUE)).size > e.n // 2,
            )
        )

    def __init__(self):
        self.safety_predicate = self._safety
        self.invariants = (self._inv0,)
        self.round_invariants = ((self._vote_majority,),)
        self.properties = (
            ("Agreement", agreement),
            ("Irrevocability", irrevocability),
        )


class BenOr(Algorithm):
    """Randomized binary consensus; terminates with probability 1.

    ``coin_salt=(salt0, salt1)`` switches round 2 to the deterministic hash
    coin so a FaultMix scenario replays bit-exactly against the fused
    engine (see BenOrRound2)."""

    def __init__(self, coin_salt=None):
        self.rounds = (BenOrRound1(), BenOrRound2(coin_salt=coin_salt))
        self.spec = BenOrSpec()

    def make_init_state(self, ctx: RoundCtx, io) -> BenOrState:
        x = torch.as_tensor(io["initial_value"]) != 0
        false = torch.zeros_like(x)
        return BenOrState(
            x=x,
            can_decide=false,
            vote=torch.full_like(x, VOTE_NONE, dtype=torch.int32),
            decided=false,
            decision=false,
        )

    def decided(self, state: BenOrState):
        return state.decided

    def decision(self, state: BenOrState):
        return state.decision
