"""Deliberately broken rounds: one fixture per wire monitor.

Port of round_tpu/rv/fixtures.py.  Each fixture is a tiny OTR-shaped
consensus whose update is broken in exactly one way, so the
injected-violation tests can pin that the RIGHT monitor trips, under the
lane driver AND the host runner, and that the dumped artifact replays to
the same violating state on the engine.

All three are selector-registered (``rv-broken-agreement`` /
``rv-broken-validity`` / ``rv-broken-revoke``) so dump artifacts replay
through the standard ``fuzz_cli`` surfaces.  They are test fixtures, not
protocols: never deploy one.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.models.common import ghost_decide
from round_tpu_torch.models.otr import OtrSpec, OtrState
from round_tpu_torch.ops.mailbox import Mailbox

# rounds a fixture keeps participating after deciding: long enough for
# FLAG_DECISION gossip to land while the lane is still live (the
# agreement monitor's deterministic trip window)
_AFTER = 6


class _BrokenOtrRound(Round):
    """OtrRound's shape with a pluggable (wrong) decision rule
    (round_tpu/rv/fixtures.py::_BrokenOtrRound)."""

    def send(self, ctx: RoundCtx, state: OtrState):
        return broadcast(ctx, state.x)

    def _decide_value(self, ctx: RoundCtx, state: OtrState,
                      mbox: Mailbox):
        raise NotImplementedError

    def update(self, ctx: RoundCtx, state: OtrState,
               mbox: Mailbox) -> OtrState:
        quorum = mbox.size() > (2 * ctx.n) // 3
        v = self._decide_value(ctx, state, mbox)
        state = ghost_decide(state, quorum, v)
        after = torch.where(state.decided, state.after - 1, state.after)
        ctx.exit_at_end_of_round(state.decided & (after <= 0))
        # x is deliberately NOT overwritten: the heterogeneous proposals
        # keep flowing every round, so min != max stays observable after
        # the (broken) decisions land
        return state.replace(after=after)


class _AgreementBreakRound(_BrokenOtrRound):
    """Even pids decide the MIN received value, odd pids the MAX
    (round_tpu/rv/fixtures.py::_AgreementBreakRound): validity holds,
    agreement breaks the moment proposals differ."""

    def _decide_value(self, ctx, state, mbox):
        lo = mbox.masked_min()
        hi = mbox.masked_max()
        return torch.where(ctx.id % 2 == 0, lo, hi).to(state.x.dtype)


class _ValidityBreakRound(_BrokenOtrRound):
    """Decides a FABRICATED value no process proposed (the schedule
    domain is mod 5; 99 is unreachable)
    (round_tpu/rv/fixtures.py::_ValidityBreakRound)."""

    def _decide_value(self, ctx, state, mbox):
        return torch.full_like(state.x, 99)


class _RevokeRound(_BrokenOtrRound):
    """Decides the MIN received value, then from round 2 on silently
    flips a decided lane's decision to the MAX proposal it heard
    (round_tpu/rv/fixtures.py::_RevokeRound): irrevocability breaks."""

    def _decide_value(self, ctx, state, mbox):
        return mbox.masked_min().to(state.x.dtype)

    def update(self, ctx, state, mbox):
        hi = mbox.masked_max().to(state.x.dtype)
        state = super().update(ctx, state, mbox)
        revoke = state.decided & (ctx.r >= 2) & (hi > state.decision)
        return state.replace(
            decision=torch.where(revoke, hi, state.decision))


class _BrokenConsensus(Algorithm):
    """OTR's state, init, accessors and Spec around one broken round
    (round_tpu/rv/fixtures.py::_BrokenConsensus)."""

    fault_envelope = "n > 3f"

    def __init__(self, rnd: Round):
        self.rounds = (rnd,)
        self.spec = OtrSpec()

    def make_init_state(self, ctx: RoundCtx, io) -> OtrState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        zero = torch.zeros_like(x)
        return OtrState(x=x, decided=zero != 0, decision=zero - 1,
                        after=zero + _AFTER)

    def decided(self, state: OtrState):
        return state.decided

    def decision(self, state: OtrState):
        return state.decision

    def adopt_decision(self, state, decision):
        # adoption would HEAL the injected violation nondeterministically;
        # the fixtures refuse it so every replica's broken update runs
        return None


FIXTURES = {
    "rv-broken-agreement": _AgreementBreakRound,
    "rv-broken-validity": _ValidityBreakRound,
    "rv-broken-revoke": _RevokeRound,
}


def select_fixture(name: str) -> Algorithm:
    return _BrokenConsensus(FIXTURES[name]())
