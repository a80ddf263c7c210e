"""LastVoting — Paxos in the HO model (Charron-Bost & Schiper).

Port of round_tpu/models/lastvoting.py (``LastVoting``, ``LVSpec`` and
``LastVotingBytes``; the event variant is models/lastvoting_event.py).  Protocol (example/
LastVoting.scala:80-212): 4-round phases with a rotating coordinator
``coord = (r / 4) % n`` (LastVoting.scala:95):

  round 0: everyone sends (x, ts) to coord; coord with a majority picks the
           value with the highest timestamp as vote, commits.
  round 1: coord broadcasts vote if committed; receivers adopt x := vote,
           ts := current phase.
  round 2: processes with ts == phase ack to coord; coord with majority acks
           becomes ready.
  round 3: coord broadcasts vote if ready; receivers decide it.  ready and
           commit reset for the next phase.

ts = -1 means "never adopted" and the mailbox presence mask replaces the
reference's sentinel values, so 0 is a legal input.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast, unicast
from round_tpu_torch.models.common import (
    agreement, ghost_decide, integrity, irrevocability, termination, validity,
)
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.spec.dsl import Spec, implies
from round_tpu_torch.utils.tree import struct


@struct
class LVState:
    x: torch.Tensor         # int32 estimate
    ts: torch.Tensor        # int32 timestamp (phase of adoption), -1 initially
    ready: torch.Tensor     # bool (coordinator)
    commit: torch.Tensor    # bool (coordinator)
    vote: torch.Tensor      # int32 (coordinator's proposal)
    decided: torch.Tensor   # bool
    decision: torch.Tensor  # int32, -1 until decided


def _coord(ctx: RoundCtx):
    return (ctx.r // 4) % ctx.n


class LVCollect(Round):
    """Round 0: send (x, ts) to coord; coord picks highest-ts value."""

    def send(self, ctx: RoundCtx, state: LVState):
        return unicast(ctx, _coord(ctx), {"x": state.x, "ts": state.ts})

    def update(self, ctx: RoundCtx, state: LVState, mbox: Mailbox):
        n = ctx.n
        is_coord = ctx.id == _coord(ctx)
        first_phase = ctx.r == 0
        have = mbox.size()
        act = is_coord & ((have > n // 2) | (first_phase & (have > 0)))
        # vote := the x of one of the largest ts received (maxBy over ts,
        # ties -> smallest sender id; LastVoting.scala:132)
        best = mbox.best_by(mbox.values["ts"])
        return state.replace(
            vote=torch.where(act, best["x"], state.vote),
            commit=state.commit | act,
        )


class LVPropose(Round):
    """Round 1: committed coord broadcasts vote; receivers adopt it."""

    def send(self, ctx: RoundCtx, state: LVState):
        return broadcast(ctx, state.vote,
                         guard=(ctx.id == _coord(ctx)) & state.commit)

    def update(self, ctx: RoundCtx, state: LVState, mbox: Mailbox):
        coord = _coord(ctx)
        got = mbox.contains(coord)
        return state.replace(
            x=torch.where(got, mbox.get(coord), state.x),
            ts=torch.where(got, ctx.r // 4, state.ts),
        )


class LVAck(Round):
    """Round 2: adopters ack to coord; coord with majority acks is ready."""

    def send(self, ctx: RoundCtx, state: LVState):
        return unicast(ctx, _coord(ctx), state.x, guard=state.ts == ctx.r // 4)

    def update(self, ctx: RoundCtx, state: LVState, mbox: Mailbox):
        n = ctx.n
        act = (ctx.id == _coord(ctx)) & (mbox.size() > n // 2)
        return state.replace(ready=state.ready | act)


class LVDecide(Round):
    """Round 3: ready coord broadcasts vote; receivers decide."""

    def send(self, ctx: RoundCtx, state: LVState):
        return broadcast(ctx, state.vote,
                         guard=(ctx.id == _coord(ctx)) & state.ready)

    def update(self, ctx: RoundCtx, state: LVState, mbox: Mailbox):
        coord = _coord(ctx)
        got = mbox.contains(coord)
        ctx.exit_at_end_of_round(got)
        state = ghost_decide(state, got, mbox.get(coord))
        false = torch.zeros_like(state.ready)
        return state.replace(ready=false, commit=false)


class LVSpec(Spec):
    """LastVoting.scala:19-70, checked on traces at phase boundaries
    (round_tpu/models/lastvoting.py::LVSpec).

    The phase invariant (``safetyInv``): either nothing is decided/ready
    yet, or some value v backed by a majority of timestamps ≥ t locks every
    decision, commit and ready vote to v.  Evaluated with the engine's
    post-state round convention (env.r = recorded round + 1).
    """

    def _liveness(self, e):
        def good_coord(p):
            return e.P.forall(
                lambda q: (p.id == (e.r // 4) % e.n)
                & p.HO.contains(q)
                & (p.HO.size > e.n // 2)
            )

        return e.P.exists(good_coord)

    def _no_decision(self, e):
        return e.P.forall(lambda i: ~i.decided & ~i.ready)

    def _majority(self, e):
        P = e.P
        V = e.values(e.state.x, e.state.vote)
        T_dom = e.values(e.state.ts)
        coord = e.proc((e.r // 4) % e.n)

        def with_v_t(v, t):
            A = P.filter(lambda i: i.ts >= t)
            return (
                (A.size > e.n // 2)
                & (e.r > 0)
                & (t <= e.r // 4)
                & P.forall(
                    lambda i: implies(A.contains(i), i.x == v)
                    & implies(i.decided, i.decision == v)
                    & implies(i.commit, i.vote == v)
                    & implies(i.ready, i.vote == v)
                    & implies(i.ts == e.r // 4, coord.commit)
                )
            )

        return V.exists(lambda v: T_dom.exists(lambda t: with_v_t(v, t)))

    def _keep_init(self, e):
        return e.P.forall(lambda i: e.P.exists(lambda j: i.x == j.init.x))

    def _inv0(self, e):
        return self._keep_init(e) & (self._no_decision(e) | self._majority(e))

    def _inv1(self, e):
        return e.P.exists(
            lambda j: e.P.forall(lambda i: i.decided & (i.decision == j.init.x))
        )

    def __init__(self):
        self.liveness_predicate = (self._liveness,)
        self.invariants = (self._inv0, self._inv1)
        self.properties = (
            ("Termination", termination),
            ("Agreement", agreement),
            ("Validity", validity),
            ("Integrity", integrity),
            ("Irrevocability", irrevocability),
        )


class LastVoting(Algorithm):
    """Paxos-style consensus with rotating coordinator (4-round phases)."""

    # Paxos resilience: majority quorums intersect, and a correct majority
    # exists whenever n > 2f (LastVoting.scala's benign-crash envelope)
    fault_envelope = "n > 2f"

    def __init__(self):
        self.rounds = (LVCollect(), LVPropose(), LVAck(), LVDecide())
        self.spec = LVSpec()

    def make_init_state(self, ctx: RoundCtx, io) -> LVState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        zero = torch.zeros_like(x)
        return LVState(
            x=x,
            ts=zero - 1,
            ready=zero != 0,
            commit=zero != 0,
            vote=zero,
            decided=zero != 0,
            decision=zero - 1,
        )

    def decided(self, state: LVState):
        return state.decided

    def decision(self, state: LVState):
        return state.decision


class LastVotingBytes(LastVoting):
    """LastVoting over opaque fixed-width byte payloads — the LastVotingB
    role (example/LastVotingB.scala: consensus on Array[Byte] command
    batches; round_tpu/models/lastvoting.py::LastVotingBytes).  The value is
    a uint8[payload_bytes] vector (pad short commands); the four rounds are
    inherited unchanged, since they touch the value only through gathers and
    masked selects.  The int-domain trace spec does not apply."""

    def __init__(self, payload_bytes: int = 16):
        super().__init__()
        self.payload_bytes = payload_bytes
        self.spec = None

    def make_init_state(self, ctx: RoundCtx, io) -> LVState:
        x = torch.as_tensor(io["initial_value"]).to(torch.uint8)
        assert x.shape == (self.payload_bytes,), x.shape
        zeros = torch.zeros_like(x)
        no = torch.zeros((), dtype=torch.bool, device=x.device)
        ts = torch.full((), -1, dtype=torch.int32, device=x.device)
        return LVState(
            x=x,
            ts=ts,
            ready=no,
            commit=no,
            vote=zeros,
            decided=no,
            # no -1 sentinel in the byte domain: `decided` is the truth
            decision=zeros,
        )
