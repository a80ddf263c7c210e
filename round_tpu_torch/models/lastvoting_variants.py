"""LastVoting variants: ShortLastVoting (3-round flood) and MultiLastVoting
(coordinator election + Option values).

Port of round_tpu/models/lastvoting_variants.py.

ShortLastVoting (example/ShortLastVoting.scala:13-106): drops the ack
round — after adopting the coordinator's vote, adopters flood x to
everyone and any process hearing a majority of floods decides.

MultiLastVoting (example/MultiLastVoting.scala:15-125): processes start as
acceptor (Left(coord hint)) or proposer (Right(v)); round 0 elects the
coordinator among senders (the hint if it sent, else the smallest sender
id) and adopts its value; round 1 acks to the elected coordinator; round 2
the ready coordinator floods and receivers decide Some(v) — or decide None
after round 30 (suspected leader crash, triggering an election upstream).
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast, unicast
from round_tpu_torch.models.common import ghost_decide
from round_tpu_torch.ops.mailbox import Mailbox, first_true
from round_tpu_torch.utils.tree import struct


# -- ShortLastVoting -------------------------------------------------------


@struct
class SlvState:
    x: torch.Tensor
    ts: torch.Tensor
    commit: torch.Tensor
    vote: torch.Tensor
    decided: torch.Tensor
    decision: torch.Tensor


def _coord4(ctx: RoundCtx):
    return (ctx.r // 4) % ctx.n


class SlvCollect(Round):
    """Round 0: (x, ts) to coord; coord with a majority votes the max-ts x
    (round_tpu/models/lastvoting_variants.py::SlvCollect)."""

    def send(self, ctx: RoundCtx, state: SlvState):
        return unicast(ctx, _coord4(ctx), {"x": state.x, "ts": state.ts})

    def update(self, ctx: RoundCtx, state: SlvState, mbox: Mailbox):
        act = (ctx.id == _coord4(ctx)) & (mbox.size() > ctx.n // 2)
        best = mbox.best_by(mbox.values["ts"])
        return state.replace(
            vote=torch.where(act, best["x"], state.vote),
            commit=state.commit | act,
        )


class SlvPropose(Round):
    """Round 1: committed coord broadcasts vote; receivers adopt it
    (round_tpu/models/lastvoting_variants.py::SlvPropose)."""

    def send(self, ctx: RoundCtx, state: SlvState):
        return broadcast(ctx, state.vote,
                         guard=(ctx.id == _coord4(ctx)) & state.commit)

    def update(self, ctx: RoundCtx, state: SlvState, mbox: Mailbox):
        got = mbox.contains(_coord4(ctx))
        return state.replace(
            x=torch.where(got, mbox.get(_coord4(ctx)), state.x),
            ts=torch.where(got, ctx.r // 4, state.ts),
        )


class SlvFlood(Round):
    """Round 2: adopters flood x; a majority of floods decides
    (round_tpu/models/lastvoting_variants.py::SlvFlood)."""

    def send(self, ctx: RoundCtx, state: SlvState):
        return broadcast(ctx, state.x, guard=state.ts == ctx.r // 4)

    def update(self, ctx: RoundCtx, state: SlvState, mbox: Mailbox):
        quorum = mbox.size() > ctx.n // 2
        v = mbox.any_value()  # mailbox.head (all flooded values agree)
        state = ghost_decide(state, quorum, v)
        ctx.exit_at_end_of_round(state.decided)
        return state.replace(commit=torch.zeros_like(state.commit))


class ShortLastVoting(Algorithm):
    """3-round LastVoting: collect / propose / flood-decide
    (round_tpu/models/lastvoting_variants.py::ShortLastVoting).  The
    reference keeps the 4-round coordinator arithmetic (coord(r/4),
    ts = r/4) while the phase is 3 rounds long (ShortLastVoting.scala:37,
    78), so the coordinator rotates irregularly; mirrored faithfully."""

    def __init__(self):
        self.rounds = (SlvCollect(), SlvPropose(), SlvFlood())

    def make_init_state(self, ctx: RoundCtx, io) -> SlvState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        zero = torch.zeros_like(x)
        return SlvState(
            x=x,
            ts=zero - 1,
            commit=zero != 0,
            vote=zero,
            decided=zero != 0,
            decision=zero - 1,
        )

    def decided(self, state: SlvState):
        return state.decided

    def decision(self, state: SlvState):
        return state.decision


# -- MultiLastVoting -------------------------------------------------------

MLV_NULL = -1


@struct
class MlvState:
    x_val: torch.Tensor
    x_def: torch.Tensor
    coord_val: torch.Tensor
    coord_def: torch.Tensor
    ready: torch.Tensor
    decided: torch.Tensor
    decision: torch.Tensor  # int32, -1 = None (suspected leader crash)


class MlvElect(Round):
    """Round 0: proposers broadcast; receivers elect the hinted coordinator
    if it sent, else the smallest sender, and adopt its value
    (round_tpu/models/lastvoting_variants.py::MlvElect)."""

    def send(self, ctx: RoundCtx, state: MlvState):
        return broadcast(ctx, state.x_val, guard=state.x_def)

    def update(self, ctx: RoundCtx, state: MlvState, mbox: Mailbox):
        got_any = mbox.size() > 0
        hint_ok = state.coord_def & mbox.contains(state.coord_val)
        min_sender = first_true(mbox.mask)  # smallest present id (minBy)
        chosen = torch.where(hint_ok, state.coord_val, min_sender).to(
            torch.int32)
        v = mbox.get(chosen)
        return state.replace(
            coord_val=torch.where(got_any, chosen, state.coord_val),
            coord_def=state.coord_def | got_any,
            x_val=torch.where(got_any, v, state.x_val),
            x_def=state.x_def | got_any,
        )


class MlvAck(Round):
    """Round 1: ack to the elected coordinator; a majority makes it ready
    (round_tpu/models/lastvoting_variants.py::MlvAck)."""

    def send(self, ctx: RoundCtx, state: MlvState):
        return unicast(ctx, state.coord_val, state.x_val,
                       guard=state.x_def & state.coord_def)

    def update(self, ctx: RoundCtx, state: MlvState, mbox: Mailbox):
        return state.replace(ready=state.ready | (mbox.size() > ctx.n // 2))


class MlvDecide(Round):
    """Round 2: the ready coordinator floods; receivers decide Some(v), or
    None after round 30 (round_tpu/models/lastvoting_variants.py::
    MlvDecide)."""

    def send(self, ctx: RoundCtx, state: MlvState):
        return broadcast(ctx, state.x_val, guard=state.ready)

    def update(self, ctx: RoundCtx, state: MlvState, mbox: Mailbox):
        got = mbox.size() > 0
        v = mbox.any_value()
        give_up = ~got & (ctx.r > 30)
        ctx.exit_at_end_of_round(got | give_up)
        state = ghost_decide(state, got | give_up,
                             torch.where(got, v, MLV_NULL))
        no = torch.zeros_like(state.ready)
        return state.replace(ready=no, coord_def=no)


class MultiLastVoting(Algorithm):
    """Coordinator-electing LastVoting over Option values
    (round_tpu/models/lastvoting_variants.py::MultiLastVoting)."""

    def __init__(self):
        self.rounds = (MlvElect(), MlvAck(), MlvDecide())

    def make_init_state(self, ctx: RoundCtx, io) -> MlvState:
        x_val = torch.as_tensor(io["value"]).to(torch.int32)
        no = torch.zeros_like(x_val, dtype=torch.bool)
        return MlvState(
            x_val=x_val,
            x_def=torch.as_tensor(io["is_proposer"]) != 0,
            coord_val=torch.as_tensor(io["coord_hint"]).to(torch.int32),
            coord_def=torch.as_tensor(io["has_hint"]) != 0,
            ready=no,
            decided=no,
            decision=torch.full_like(x_val, MLV_NULL),
        )

    def decided(self, state: MlvState):
        return state.decided

    def decision(self, state: MlvState):
        return state.decision


def mlv_io(n: int, proposers: dict, coord_hints: dict = None,
           device=None) -> dict:
    """io: ``proposers`` maps pid -> value (Right(v)); everyone else is an
    acceptor, optionally with a coord hint (Left(pid))
    (round_tpu/models/lastvoting_variants.py::mlv_io)."""
    coord_hints = coord_hints or {}
    val = torch.zeros(n, dtype=torch.int32, device=device)
    is_prop = torch.zeros(n, dtype=torch.bool, device=device)
    hint = torch.zeros(n, dtype=torch.int32, device=device)
    has_hint = torch.zeros(n, dtype=torch.bool, device=device)
    for p, v in proposers.items():
        val[p] = v
        is_prop[p] = True
    for p, c in coord_hints.items():
        hint[p] = c
        has_hint[p] = True
    return {"value": val, "is_proposer": is_prop, "coord_hint": hint,
            "has_hint": has_hint}
