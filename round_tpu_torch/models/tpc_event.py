"""Two-Phase Commit with event rounds: blocking / timeout / all-or-quorum.

Port of round_tpu/models/tpc_event.py.  Protocol (example/
TwoPhaseCommitEvent.scala:26-114): the 3-round 2PC of the closed model
with the reference's two progress modes per round:

  blocking=True  → Progress.waitMessage: the round cannot end until its
    goAhead condition fires.  In the lockstep HO model a lane whose
    condition never fires is DEADLOCKED; it freezes — ``blocked`` ghost
    set, lane exits undecided.
  blocking=False → Progress.timeout: the round ends anyway and the handler
    sees didTimeout (the reference default).

  ``all_votes``: round 2's coordinator waits for ALL n votes before
  committing; without it one NO aborts at once
  (TwoPhaseCommitEvent.scala:64-66: (!all && !ok) || nMsg == n).

Rounds:
  1: coord broadcasts PrepareCommit; any message → goAhead (:36-48).
  2: everyone votes to coord; coord folds ok &= vote (:54-75); the decision
     is set from the heard votes even on timeout (finishRound, :69-74).
  3: coord broadcasts the decision; receivers decide it; a lane that heard
     nothing decides None (-1, coordinator suspected); everyone exits
     (finishRound returns false, :95-101).

Decision encoding as models/tpc.py: {-1 = None, 0 = abort, 1 = commit}.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import FoldRound, RoundCtx, broadcast, unicast
from round_tpu_torch.models.tpc import DEC_ABORT, DEC_COMMIT, DEC_NONE
from round_tpu_torch.utils.tree import struct


@struct
class TpcEState:
    coord: torch.Tensor     # int32, fixed coordinator id
    vote: torch.Tensor      # bool, this process's canCommit
    decision: torch.Tensor  # int32 in {-1, 0, 1}
    decided: torch.Tensor   # bool (ghost: callback fired)
    blocked: torch.Tensor   # bool (ghost: waitMessage deadlock)


def _flag(v: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.bool, device=like.device)


class _TpcERound(FoldRound):
    def __init__(self, blocking: bool, all_votes: bool):
        self.blocking = blocking
        self.all_votes = all_votes

    def _block_or_pass(self, ctx, state, ok_to_proceed):
        """waitMessage semantics: a lane whose condition did not fire
        freezes (deadlock ghost) instead of timing out."""
        if not self.blocking:
            return state
        newly_blocked = ~ok_to_proceed & ~state.blocked
        ctx.exit_at_end_of_round(newly_blocked)
        return state.replace(blocked=state.blocked | newly_blocked)


class TpcEPrepare(_TpcERound):
    """Round 1: PrepareCommit broadcast; heard anything → goAhead
    (round_tpu/models/tpc_event.py::TpcEPrepare)."""

    def send(self, ctx: RoundCtx, state: TpcEState):
        return broadcast(ctx, _flag(True, state.vote),
                         guard=ctx.id == state.coord)

    def zero(self, ctx: RoundCtx, state: TpcEState):
        return _flag(False, state.vote)

    def lift(self, ctx: RoundCtx, state: TpcEState, sender, payload):
        return torch.ones_like(payload, dtype=torch.bool)

    def combine(self, a, b):
        return a | b

    def reduce(self, ctx: RoundCtx, state: TpcEState, lifted, mask):
        # OR-monoid: the tree fold is any() over the present senders
        return torch.where(mask, lifted, False).any()

    def go_ahead(self, ctx: RoundCtx, state: TpcEState, m, count):
        return m

    def post(self, ctx: RoundCtx, state: TpcEState, m, count, did_timeout):
        return self._block_or_pass(ctx, state, ~did_timeout)


class TpcEVote(_TpcERound):
    """Round 2: votes to coord; ok &= payload; decision from heard votes
    (round_tpu/models/tpc_event.py::TpcEVote)."""

    def send(self, ctx: RoundCtx, state: TpcEState):
        return unicast(ctx, state.coord, state.vote)

    def zero(self, ctx: RoundCtx, state: TpcEState):
        return _flag(True, state.vote)

    def lift(self, ctx: RoundCtx, state: TpcEState, sender, payload):
        return payload

    def combine(self, a, b):
        return a & b

    def reduce(self, ctx: RoundCtx, state: TpcEState, lifted, mask):
        # AND-monoid: the tree fold is all() over the present senders
        return torch.where(mask, lifted, True).all()

    def go_ahead(self, ctx: RoundCtx, state: TpcEState, m, count):
        nonc = ctx.id != state.coord
        full = count == ctx.n
        early_no = ~m if not self.all_votes else torch.zeros_like(m)
        return nonc | full | early_no

    def post(self, ctx: RoundCtx, state: TpcEState, m, count, did_timeout):
        is_coord = ctx.id == state.coord
        dec = torch.where(m, DEC_COMMIT, DEC_ABORT).to(torch.int32)
        # timeout mode: finishRound runs even on timeout (:69-74) — the
        # coordinator judges the votes it heard.  blocking mode: a starved
        # lane never reaches finishRound (waitMessage), so no decision is
        # stamped before the freeze.
        act = is_coord & ~state.blocked
        if self.blocking:
            act = act & ~did_timeout
        state = state.replace(decision=torch.where(act, dec, state.decision))
        return self._block_or_pass(ctx, state, ~did_timeout)


class TpcECommit(_TpcERound):
    """Round 3: decision broadcast; decide whatever arrived (None if
    nothing); everyone exits (round_tpu/models/tpc_event.py::TpcECommit)."""

    def send(self, ctx: RoundCtx, state: TpcEState):
        return broadcast(ctx, state.decision == DEC_COMMIT,
                         guard=(ctx.id == state.coord) & ~state.blocked)

    def zero(self, ctx: RoundCtx, state: TpcEState):
        return {"got": _flag(False, state.vote),
                "v": _flag(False, state.vote)}

    def lift(self, ctx: RoundCtx, state: TpcEState, sender, payload):
        return {"got": torch.ones_like(payload, dtype=torch.bool),
                "v": payload}

    def combine(self, a, b):
        return {"got": a["got"] | b["got"],
                "v": torch.where(b["got"], b["v"], a["v"])}

    def reduce(self, ctx: RoundCtx, state: TpcEState, lifted, mask):
        # last-sender-wins fold: the winner is the highest-id present sender
        # (sender-id fold order)
        got = mask.any()
        ids = torch.where(mask, torch.arange(mask.shape[0],
                                             device=mask.device), -1)
        idx = ids.max().clamp(min=0)
        return {"got": got, "v": torch.where(got, lifted["v"][idx], False)}

    def go_ahead(self, ctx: RoundCtx, state: TpcEState, m, count):
        return m["got"]

    def post(self, ctx: RoundCtx, state: TpcEState, m, count, did_timeout):
        # blocking: a lane that missed the decision broadcast waits forever
        # (waitMessage) — it freezes instead of deciding None
        state = self._block_or_pass(ctx, state, ~did_timeout)
        dec = torch.where(
            m["got"],
            torch.where(m["v"], DEC_COMMIT, DEC_ABORT),
            DEC_NONE,
        ).to(torch.int32)
        live = ~state.blocked
        state = state.replace(
            decision=torch.where(live, dec, state.decision),
            decided=state.decided | live,
        )
        # finishRound returns false (:101); a tensor on the lane's device
        ctx.exit_at_end_of_round(torch.ones_like(state.decided))
        return state


class TwoPhaseCommitEvent(Algorithm):
    """Event-round 2PC (TwoPhaseCommitEvent.scala:26-114;
    round_tpu/models/tpc_event.py::TwoPhaseCommitEvent).

    blocking: waitMessage mode (lanes freeze on missing messages).
    all_votes: coordinator needs all n votes (no early abort short-circuit).
    """

    def __init__(self, blocking: bool = False, all_votes: bool = False):
        self.blocking = blocking
        self.all_votes = all_votes
        self.rounds = (
            TpcEPrepare(blocking, all_votes),
            TpcEVote(blocking, all_votes),
            TpcECommit(blocking, all_votes),
        )

    def make_init_state(self, ctx: RoundCtx, io) -> TpcEState:
        coord = torch.as_tensor(io["coord"]).to(torch.int32)
        no = torch.zeros_like(coord, dtype=torch.bool)
        return TpcEState(
            coord=coord,
            vote=torch.as_tensor(io["can_commit"]) != 0,
            decision=torch.full_like(coord, DEC_NONE),
            decided=no,
            blocked=no,
        )

    def decided(self, state: TpcEState):
        return state.decided

    def decision(self, state: TpcEState):
        return state.decision
