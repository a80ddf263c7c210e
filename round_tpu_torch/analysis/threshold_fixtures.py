"""The threshold extractor's self-test corpus: one toy model per guard
shape, with golden automata pinned in tests/test_torch_threshold.py.

Port of round_tpu/analysis/threshold_fixtures.py over torch, the states
``utils.tree.struct`` dataclasses where round_tpu uses flax's.

Like analysis/fixtures.py for the lint families, these are NOT in the main
registry — each model isolates exactly one guard shape the extractor must
recover (or, for the negative fixture, must REFUSE):

  majority     — decide when size > n//2            (LastVoting's quorum)
  two-thirds   — decide when size > (2n)//3         (OTR's quorum)
  plurality    — decide when 2*support > size       (count-vs-count,
                 a RELATIVE threshold: affine constant 0, two counts)
  fold-probe   — a FoldRound whose go_ahead is count > n//2 (the event-
                 round probe shape, extracted through post())
  data-bound   — decide when size > x (a DATA-dependent threshold: the
                 extractor must refuse, not mis-extract an affine form)

Every fixture's ``build_at`` is parametric in n (multi-n sampling is what
makes the affine fit possible at all).
"""

from __future__ import annotations

import numpy as np
import torch

from round_tpu_torch.analysis.registry import ModelEntry
from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import FoldRound, Round, RoundCtx, broadcast
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import struct


@struct
class TState:
    x: torch.Tensor        # int32
    decided: torch.Tensor  # bool
    decision: torch.Tensor


class _TBase(Algorithm):
    fault_envelope = "n > 2f"

    def make_init_state(self, ctx: RoundCtx, io) -> TState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        zero = torch.zeros_like(x)
        return TState(x=x, decided=zero != 0, decision=zero - 1)

    def decided(self, state):
        return state.decided

    def decision(self, state):
        return state.decision


def _decide(state, fire, v):
    return state.replace(
        decided=state.decided | fire,
        decision=torch.where(fire & ~state.decided, v, state.decision),
    )


class MajorityRound(Round):
    def send(self, ctx: RoundCtx, state: TState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: TState, mbox: Mailbox):
        fire = mbox.size() > ctx.n // 2
        return _decide(state, fire, mbox.any_value())


class MajorityToy(_TBase):
    def __init__(self):
        self.rounds = (MajorityRound(),)


class TwoThirdsRound(Round):
    def send(self, ctx: RoundCtx, state: TState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: TState, mbox: Mailbox):
        fire = mbox.size() > (2 * ctx.n) // 3
        return _decide(state, fire, mbox.any_value())


class TwoThirdsToy(_TBase):
    fault_envelope = "n > 3f"

    def __init__(self):
        self.rounds = (TwoThirdsRound(),)


class PluralityRound(Round):
    """Relative threshold: value 1's support strictly beats the rest of
    the mailbox (2*support > size, affine constant 0)."""

    def send(self, ctx: RoundCtx, state: TState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: TState, mbox: Mailbox):
        support = mbox.count(lambda v: v == 1)
        fire = 2 * support > mbox.size()
        return _decide(state, fire, torch.ones_like(state.x))


class PluralityToy(_TBase):
    def __init__(self):
        self.rounds = (PluralityRound(),)


class FoldProbeRound(FoldRound):
    """The event-round probe shape: go_ahead at a majority count, decision
    folded through post().  The monoid is a masked max."""

    def zero(self, ctx: RoundCtx, state: TState):
        return torch.full((), -1, dtype=torch.int32,
                          device=state.x.device)

    def lift(self, ctx: RoundCtx, state: TState, sender, payload):
        return payload

    def combine(self, m1, m2):
        return torch.maximum(m1, m2)

    def reduce(self, ctx: RoundCtx, state: TState, lifted, mask):
        return torch.where(mask, lifted, -1).max()

    def send(self, ctx: RoundCtx, state: TState):
        return broadcast(ctx, state.x)

    def go_ahead(self, ctx: RoundCtx, state: TState, m, count):
        return count > ctx.n // 2

    def post(self, ctx: RoundCtx, state: TState, m, count, did_timeout):
        return _decide(state, ~did_timeout, m)


class FoldProbeToy(_TBase):
    def __init__(self):
        self.rounds = (FoldProbeRound(),)


class DataBoundRound(Round):
    """NEGATIVE: the quorum bound is this process's own estimate — a
    data-dependent threshold no automaton rule can carry."""

    def send(self, ctx: RoundCtx, state: TState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: TState, mbox: Mailbox):
        fire = mbox.size() > state.x  # data-dependent bound
        return _decide(state, fire, mbox.any_value())


class DataBoundToy(_TBase):
    def __init__(self):
        self.rounds = (DataBoundRound(),)


def _entry(name, cls, note):
    def build_at(n, cls=cls):
        return cls(), {"initial_value": np.arange(n, dtype=np.int32) % 2}

    def build(cls=cls):
        return build_at(4)

    return ModelEntry(name, build, n=4, note=note, build_at=build_at)


THRESHOLD_FIXTURES = (
    _entry("tfix-majority", MajorityToy, "size > n//2 (majority quorum)"),
    _entry("tfix-two-thirds", TwoThirdsToy, "size > (2n)//3 (OTR quorum)"),
    _entry("tfix-plurality", PluralityToy, "2*support > size (relative)"),
    _entry("tfix-fold-probe", FoldProbeToy, "FoldRound go_ahead probe"),
    _entry("tfix-data-bound", DataBoundToy,
           "NEGATIVE: count vs state (must refuse)"),
)

THRESHOLD_FIXTURES_BY_NAME = {e.name: e for e in THRESHOLD_FIXTURES}
