"""Dijkstra's self-stabilizing token-ring mutual exclusion.

Port of round_tpu/models/mutex.py.  Protocol
(example/SelfStabilizingMutualExclusion.scala:10-46, after MIT 6.852 lec.
24): processes form a ring; each sends x to its right neighbour (so each
receives from its left).  Process 0 holds the token when its value equals
its left neighbour's and then increments mod n+1; everyone else holds the
token when its value differs and then copies.  From ANY initial state the
ring converges to exactly one token.

Implemented over the port's EventRound (the reference uses EventRound with
Progress.goAhead on the single expected message) — each lane receives at
most one message, from its left neighbour.  Its fused form is
engine.fast.run_mutex_fast.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import EventRound, RoundCtx, unicast
from round_tpu_torch.models.common import consensus_io
from round_tpu_torch.utils.tree import struct


@struct
class MutexState:
    x: torch.Tensor          # int32 in [0, n]
    has_token: torch.Tensor  # bool ghost: held the token this round

    @classmethod
    def fresh(cls, init, S: int, n: int) -> "MutexState":
        """[S, n]-batched state from an [n] vector of initial values, on
        the device of ``init``."""
        init = torch.as_tensor(init)
        return cls(x=init.to(torch.int32).expand((S, n)).contiguous(),
                   has_token=torch.zeros((S, n), dtype=torch.bool,
                                         device=init.device))


class MutexRound(EventRound):
    """round_tpu/models/mutex.py::MutexRound."""

    def pre(self, ctx: RoundCtx, state: MutexState):
        return state.replace(has_token=torch.zeros_like(state.has_token))

    def send(self, ctx: RoundCtx, state: MutexState):
        right = (ctx.id + 1) % ctx.n
        return unicast(ctx, right, state.x)

    def receive(self, ctx: RoundCtx, state: MutexState, sender, payload):
        x_left = payload
        is_zero = ctx.id == 0
        token = torch.where(is_zero, state.x == x_left, state.x != x_left)
        new_x = torch.where(
            is_zero,
            torch.where(token, (state.x + 1) % (ctx.n + 1), state.x),
            torch.where(token, x_left, state.x),
        )
        return (state.replace(x=new_x, has_token=token),
                torch.ones_like(token))


class SelfStabilizingMutualExclusion(Algorithm):
    """Converges to exactly one token holder per round from any state
    (round_tpu/models/mutex.py::SelfStabilizingMutualExclusion)."""

    def __init__(self):
        self.rounds = (MutexRound(),)

    def make_init_state(self, ctx: RoundCtx, io) -> MutexState:
        x = torch.as_tensor(io["initial_value"]).to(torch.int32)
        return MutexState(x=x, has_token=torch.zeros_like(x, dtype=torch.bool))


def mutex_io(initial_values, device=None) -> dict:
    """io: one initial ring value per process
    (round_tpu/models/mutex.py::mutex_io)."""
    return consensus_io(initial_values, device=device)
