"""FloodMin — synchronous min-flooding consensus under f crash faults.

Port of round_tpu/models/floodmin.py.  Protocol (example/FloodMin.scala:
22-33): every round broadcast x; fold the received values into x with min;
after f+1 rounds (``r > f``) decide x and exit.  Tolerates f crash-stop
faults in the synchronous model.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.models.common import ghost_decide
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import struct


@struct
class FloodMinState:
    x: torch.Tensor         # current min estimate (int32)
    decided: torch.Tensor   # bool (ghost; reference decides via callback)
    decision: torch.Tensor  # int32, -1 until decided

    @classmethod
    def fresh(cls, init, S: int, n: int) -> "FloodMinState":
        """[S, n]-batched undecided state from an [n] initial-value vector,
        on the device of ``init``."""
        init = torch.as_tensor(init)
        dev = init.device
        return cls(
            x=init.to(torch.int32).expand((S, n)).contiguous(),
            decided=torch.zeros((S, n), dtype=torch.bool, device=dev),
            decision=torch.full((S, n), -1, dtype=torch.int32, device=dev),
        )


class FloodMinRound(Round):
    def __init__(self, f: int):
        self.f = f

    def send(self, ctx: RoundCtx, state: FloodMinState):
        return broadcast(ctx, state.x)

    def update(self, ctx: RoundCtx, state: FloodMinState, mbox: Mailbox):
        # x = mailbox.foldLeft(x)(min)   (FloodMin.scala:26)
        x = mbox.fold_min(state.x)
        deciding = ctx.r > self.f
        ctx.exit_at_end_of_round(deciding)
        return ghost_decide(state.replace(x=x), deciding, x)


class FloodMin(Algorithm):
    """f-crash-tolerant min-flooding (decide after round f)."""

    def __init__(self, f: int = 2):
        self.f = f
        self.rounds = (FloodMinRound(f),)

    def make_init_state(self, ctx: RoundCtx, io) -> FloodMinState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        zero = torch.zeros_like(x)
        return FloodMinState(x=x, decided=zero != 0, decision=zero - 1)

    def decided(self, state: FloodMinState):
        return state.decided

    def decision(self, state: FloodMinState):
        return state.decision
