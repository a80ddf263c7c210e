"""Two-Phase Commit in the HO model.

Port of round_tpu/models/tpc.py.  Protocol (example/TwoPhaseCommit.scala:
16-81): a fixed coordinator (from the IO, not rotating):

  round 0: coord broadcasts PrepareCommit (placeholder payload).
  round 1: everyone sends its vote (canCommit) to coord; coord decides
           Some(true) iff it heard *all n* votes and all are yes, else
           Some(false).
  round 2: coord broadcasts the decision; receivers adopt it if present and
           decide — deciding None means the coordinator is suspected of a
           crash (TpcIO.decide doc, TwoPhaseCommit.scala:13).

Decision encoding: int32 {-1 = None (suspect), 0 = abort, 1 = commit}.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast, unicast
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import struct

DEC_NONE = -1
DEC_ABORT = 0
DEC_COMMIT = 1


@struct
class TpcState:
    coord: torch.Tensor     # int32, fixed coordinator id
    vote: torch.Tensor      # bool, this process's canCommit
    decision: torch.Tensor  # int32 in {-1, 0, 1}
    decided: torch.Tensor   # bool (ghost: callback fired)

    @classmethod
    def fresh(cls, coord: int, votes, S: int, n: int) -> "TpcState":
        """[S, n]-batched undecided state from an [n] vote vector, on the
        device of ``votes``."""
        votes = torch.as_tensor(votes)
        dev = votes.device
        return cls(
            coord=torch.full((S, n), coord, dtype=torch.int32, device=dev),
            vote=(votes != 0).expand((S, n)).contiguous(),
            decision=torch.full((S, n), DEC_NONE, dtype=torch.int32,
                                device=dev),
            decided=torch.zeros((S, n), dtype=torch.bool, device=dev),
        )


class TpcPrepare(Round):
    def send(self, ctx: RoundCtx, state: TpcState):
        dev = state.coord.device
        return broadcast(ctx, torch.ones((), dtype=torch.bool, device=dev),
                         guard=ctx.id == state.coord)

    def update(self, ctx: RoundCtx, state: TpcState, mbox: Mailbox):
        return state  # nothing to do (TwoPhaseCommit.scala:42-44)


class TpcVote(Round):
    def send(self, ctx: RoundCtx, state: TpcState):
        return unicast(ctx, state.coord, state.vote)

    def update(self, ctx: RoundCtx, state: TpcState, mbox: Mailbox):
        n = ctx.n
        is_coord = ctx.id == state.coord
        all_yes = (mbox.size() == n) & mbox.forall(lambda v: v)
        dec = torch.where(all_yes, DEC_COMMIT, DEC_ABORT).to(torch.int32)
        return state.replace(
            decision=torch.where(is_coord, dec, state.decision))


class TpcCommit(Round):
    def send(self, ctx: RoundCtx, state: TpcState):
        return broadcast(ctx, state.decision == DEC_COMMIT,
                         guard=ctx.id == state.coord)

    def update(self, ctx: RoundCtx, state: TpcState, mbox: Mailbox):
        got = mbox.size() > 0
        v = torch.where(mbox.any_value(), DEC_COMMIT, DEC_ABORT).to(
            torch.int32)
        ctx.exit_at_end_of_round(torch.ones_like(state.decided))
        return state.replace(
            decision=torch.where(got, v, state.decision),
            decided=torch.ones_like(state.decided),
        )


class TwoPhaseCommit(Algorithm):
    """2PC with a fixed coordinator; one 3-round phase, always terminates."""

    def __init__(self):
        self.rounds = (TpcPrepare(), TpcVote(), TpcCommit())

    def make_init_state(self, ctx: RoundCtx, io) -> TpcState:
        coord = torch.as_tensor(io["coord"]).to(torch.int32)
        return TpcState(
            coord=coord,
            vote=torch.as_tensor(io["can_commit"]) != 0,
            decision=torch.full_like(coord, DEC_NONE),
            decided=torch.zeros_like(coord, dtype=torch.bool),
        )

    def decided(self, state: TpcState):
        return state.decided

    def decision(self, state: TpcState):
        return state.decision


def tpc_io(coord, can_commit, device=None) -> dict:
    """io: the coordinator id repeated per process, and each process's
    canCommit vote (round_tpu/models/tpc.py::tpc_io)."""
    cc = torch.as_tensor(can_commit, device=device) != 0
    return {
        "coord": torch.as_tensor(coord, device=cc.device).to(
            torch.int32).expand(cc.shape).contiguous(),
        "can_commit": cc,
    }
