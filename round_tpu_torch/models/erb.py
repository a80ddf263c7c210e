"""Eager reliable broadcast (one instance = one broadcast).

Port of round_tpu/models/erb.py.  Protocol (example/
EagerReliableBroadcast.scala:13-47): the originator starts with Some(v);
every process that knows the value rebroadcasts it once, delivers, and
exits; processes that receive it adopt it (``head`` of a non-empty
mailbox); a process that hears nothing for 10 rounds gives up (the
originator crashed before anyone got it).
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import struct

# a process that hears nothing for this many rounds gives up (the
# originator crashed before anyone got the value) — ONE constant shared
# with the fused path (engine.fast.ErbHist) so the engines cannot drift
GIVE_UP_ROUND = 10


@struct
class ErbState:
    x_val: torch.Tensor      # int32 (the broadcast value, if known)
    x_def: torch.Tensor      # bool — x.isDefined
    delivered: torch.Tensor  # bool ghost (deliver callback fired)
    delivery: torch.Tensor   # int32 ghost

    @classmethod
    def fresh(cls, io: dict, S: int, n: int) -> "ErbState":
        """[S, n]-batched undelivered state from a broadcast_io dict — the
        one constructor every fused and sharded call site shares
        (round_tpu/models/erb.py::ErbState.fresh).  On the device of the
        io's tensors."""
        value = torch.as_tensor(io["value"])
        dev = value.device
        return cls(
            x_val=value.to(torch.int32).expand((S, n)).contiguous(),
            x_def=(torch.as_tensor(io["is_origin"], device=dev) != 0).expand(
                (S, n)).contiguous(),
            delivered=torch.zeros((S, n), dtype=torch.bool, device=dev),
            delivery=torch.full((S, n), -1, dtype=torch.int32, device=dev),
        )


class ErbRound(Round):
    def send(self, ctx: RoundCtx, state: ErbState):
        return broadcast(ctx, state.x_val, guard=state.x_def)

    def update(self, ctx: RoundCtx, state: ErbState, mbox: Mailbox):
        got_any = mbox.size() > 0
        adopted = mbox.any_value()

        delivering = state.x_def
        give_up = ~state.x_def & ~got_any & (ctx.r > GIVE_UP_ROUND)
        ctx.exit_at_end_of_round(delivering | give_up)
        newly = delivering & ~state.delivered
        return state.replace(
            x_val=torch.where(~state.x_def & got_any, adopted, state.x_val),
            x_def=state.x_def | got_any,
            delivered=state.delivered | delivering,
            delivery=torch.where(newly, state.x_val, state.delivery),
        )


class EagerReliableBroadcast(Algorithm):
    """Uniform reliable broadcast: if any correct process delivers v, every
    correct process delivers v."""

    def __init__(self):
        self.rounds = (ErbRound(),)

    def make_init_state(self, ctx: RoundCtx, io) -> ErbState:
        value = torch.as_tensor(io["value"]).to(torch.int32)
        return ErbState(
            x_val=value,
            x_def=torch.as_tensor(io["is_origin"]) != 0,
            delivered=torch.zeros_like(value, dtype=torch.bool),
            delivery=torch.full_like(value, -1),
        )

    def decided(self, state: ErbState):
        return state.delivered

    def decision(self, state: ErbState):
        return state.delivery


def broadcast_io(origin: int, value: int, n: int, device=None) -> dict:
    """io: process ``origin`` broadcasts ``value`` (BroadcastIO semantics:
    Some(v) at the origin, None elsewhere)."""
    ids = torch.arange(n, device=device)
    return {
        "value": torch.where(ids == origin, value, 0).to(torch.int32),
        "is_origin": ids == origin,
    }
