"""The linter's self-test corpus: deliberately broken toy algorithms.

Port of round_tpu/analysis/fixtures.py over torch (states are
``utils.tree.struct`` dataclasses).  One tiny model per rule family, each
carrying exactly the defect its rule catches (plus one clean model that
must produce ZERO findings).  round_tpu's ``fixture-int-reduce`` demoed
only the tpu-lowerability family, which the port does not carry, and is
not carried either.  These are NOT in the main registry —
tests/test_torch_analysis.py lints them directly and pins the golden
(rule, file:line) findings.

Every `# lint:` comment marks the defect line the golden test anchors on.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from round_tpu_torch.analysis.registry import ModelEntry
from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.spec.dsl import Spec
from round_tpu_torch.utils.tree import struct


@struct
class ToyState:
    x: torch.Tensor        # int32
    decided: torch.Tensor  # bool
    decision: torch.Tensor


class _ToyBase(Algorithm):
    def make_init_state(self, ctx: RoundCtx, io) -> ToyState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        zero = torch.zeros_like(x)
        return ToyState(x=x, decided=zero != 0, decision=zero - 1)

    def decided(self, state):
        return state.decided

    def decision(self, state):
        return state.decision


# -- comm-closure: send/update dtype mismatch -------------------------------


class DtypeDriftRound(Round):
    def send(self, ctx: RoundCtx, state: ToyState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: ToyState, mbox: Mailbox):
        mean = mbox.masked_sum(mbox.values.to(torch.float32)) / ctx.n
        return state.replace(x=mean)  # lint: comm-closure/state-drift


class DtypeDrift(_ToyBase):
    """x silently becomes float32 after one round — breaks the scan carry."""

    def __init__(self):
        self.rounds = (DtypeDriftRound(),)


# -- comm-closure: update consumes a payload key send never produced --------


class MailboxMisuseRound(Round):
    def send(self, ctx: RoundCtx, state: ToyState):
        return broadcast(ctx, {"est": state.x})

    def update(self, ctx: RoundCtx, state: ToyState, mbox: Mailbox):
        got = mbox.values["vote"]  # lint: comm-closure/mailbox
        return state.replace(x=torch.where(mbox.mask, got, 0).max())


class MailboxMisuse(_ToyBase):
    """update reads mbox.values['vote'] but send broadcast {'est': ...}."""

    def __init__(self):
        self.rounds = (MailboxMisuseRound(),)


# -- purity: unseeded host randomness + clock reads -------------------------


class ImpureRound(Round):
    def send(self, ctx: RoundCtx, state: ToyState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: ToyState, mbox: Mailbox):
        coin = np.random.rand()  # lint: purity/unseeded-random
        t0 = time.time()  # lint: purity/time
        self.last_round = t0  # lint: purity/closure-mutation
        x = torch.where(torch.as_tensor(coin > 0.5), state.x + 1, state.x)
        return state.replace(x=x.to(torch.int32))


class ImpureToy(_ToyBase):
    """Host RNG / clock / closure mutation inside traced round code."""

    def __init__(self):
        self.rounds = (ImpureRound(),)


# -- spec-coherence: formula references a field that does not exist ---------


class TypoSpec(Spec):
    def __init__(self):
        self.properties = (
            ("Agreement",
             # lint: spec-coherence/missing-field ('decidedd' is a typo)
             lambda e: e.P.forall(lambda i: ~i.decidedd | (i.decision >= 0))),
        )


class SpecTypoRound(Round):
    def send(self, ctx: RoundCtx, state: ToyState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: ToyState, mbox: Mailbox):
        return state.replace(x=mbox.masked_sum().to(torch.int32))


class SpecTypo(_ToyBase):
    """Well-formed rounds; the spec formula typos a state field."""

    def __init__(self):
        self.rounds = (SpecTypoRound(),)
        self.spec = TypoSpec()


# -- recompile-hazard: Python branching on a traced value -------------------


class TracedBranchRound(Round):
    def send(self, ctx: RoundCtx, state: ToyState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: ToyState, mbox: Mailbox):
        if mbox.size() > 0:  # lint: recompile-hazard/traced-branch
            return state.replace(x=state.x + 1)
        return state


class TracedBranch(_ToyBase):
    """`if` on a traced mailbox count: an error under vmap."""

    def __init__(self):
        self.rounds = (TracedBranchRound(),)


# -- the clean control: must produce ZERO findings --------------------------


class FloodOrRound(Round):
    """Bool-OR flooding: pure, bool/sum reductions only, fixed-point state."""

    def send(self, ctx: RoundCtx, state: ToyState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: ToyState, mbox: Mailbox):
        heard = mbox.count(lambda v: v > 0)
        x = torch.where(heard > 0, torch.ones_like(state.x), state.x)
        deciding = ctx.r >= 2
        ctx.exit_at_end_of_round(deciding)
        return state.replace(
            x=x,
            decided=state.decided | deciding,
            decision=torch.where(deciding & ~state.decided, x,
                                 state.decision),
        )


class CleanSpec(Spec):
    def __init__(self):
        self.properties = (
            ("Irrevocability",
             lambda e: e.P.forall(
                 lambda i: ~i.old.decided | (i.decided & (i.decision == i.old.decision))
             )),
        )


class CleanToy(_ToyBase):
    """The zero-findings control model."""

    def __init__(self):
        self.rounds = (FloodOrRound(),)
        self.spec = CleanSpec()


def _entry(name, cls, note):
    def build(cls=cls):
        return cls(), {"initial_value": np.arange(4, dtype=np.int32) % 2}

    return ModelEntry(name, build, n=4, note=note)


FIXTURES = (
    _entry("fixture-dtype-drift", DtypeDrift, "comm-closure/state-drift demo"),
    _entry("fixture-mailbox-misuse", MailboxMisuse, "comm-closure/mailbox demo"),
    _entry("fixture-impure", ImpureToy, "purity demos (rng/clock/mutation)"),
    _entry("fixture-spec-typo", SpecTypo, "spec-coherence/missing-field demo"),
    _entry("fixture-traced-branch", TracedBranch, "recompile-hazard demo"),
    _entry("fixture-clean", CleanToy, "the zero-findings control"),
)

FIXTURES_BY_NAME = {e.name: e for e in FIXTURES}
