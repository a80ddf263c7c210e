"""A deliberately broken round INVISIBLE to every per-lane monitor.

Port of round_tpu/snap/fixtures.py.  ``snap-broken-conservation`` has
OTR's shape, but from round 1 on every process silently corrupts its
estimate ``x`` to a fabricated value no process proposed (9900 + pid,
outside the mod-5 schedule domain and distinct per pid), and nobody ever
decides.  Every decision-plane monitor is vacuously satisfied while
OTR's ``keep_init`` invariant ("every estimate is some process's initial
value") fails the moment the corruption lands: only an evaluator holding
the global state, a round-consistent cut, can see it.

Selector-registered so violation artifacts replay through the standard
``fuzz_cli`` surfaces.  A test fixture, not a protocol: never deploy it.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.models.otr import OtrState
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.rv.fixtures import _BrokenConsensus


class _ConservationBreakRound(Round):
    """OTR's send, a corrupting update, no decisions ever
    (round_tpu/snap/fixtures.py::_ConservationBreakRound)."""

    def send(self, ctx: RoundCtx, state: OtrState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: OtrState,
               mbox: Mailbox) -> OtrState:
        fabricated = (9900 + ctx.id).to(state.x.dtype)
        return state.replace(x=torch.where(ctx.r >= 1, fabricated, state.x))


FIXTURES = {
    "snap-broken-conservation": _ConservationBreakRound,
}


def select_fixture(name: str):
    return _BrokenConsensus(FIXTURES[name]())
