"""Θ-model round synchronizer (Widder & Schmid clock sync).

Port of round_tpu/models/theta.py.  Reference: example/ThetaModel.scala:
34-105 — Θ bounds the ratio of longest to shortest end-to-end delays; the
algorithm builds synchronized logical rounds on top: a process fires
logical round ``round`` when the physical round counter hits
``nextRoundAt`` (3Θ(round+1)+1 for known Θ, the triangular schedule for
unknown Θ), sending Some(payload) then; otherwise it broadcasts None.

Payload here is the sender's logical round; deliveries are recorded as the
highest logical round heard per peer.  Its fused form is
engine.fast.run_theta_fast.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.device import resolve_device
from round_tpu_torch.utils.tree import struct


@struct
class ThetaState:
    round: torch.Tensor          # int32 logical round
    next_round_at: torch.Tensor  # int32 physical round of the next fire
    heard: torch.Tensor          # [n] int32 — highest logical round heard per peer

    @classmethod
    def fresh(cls, theta: float, S: int, n: int, device=None) -> "ThetaState":
        """The [S, n]-batched state ThetaModel's init gives every lane, on
        ``device`` (the card unless the caller says otherwise)."""
        dev = resolve_device(device)
        r0 = torch.zeros((S, n), dtype=torch.int32, device=dev)
        return cls(round=r0, next_round_at=_next_round_at(theta, r0),
                   heard=torch.full((S, n, n), -1, dtype=torch.int32,
                                    device=dev))


def _next_round_at(theta: float, round_: torch.Tensor) -> torch.Tensor:
    """The physical round of the next fire after logical round ``round_``
    (int32; round_tpu/models/theta.py::_next_round_at).  Known Θ: the
    float32 product 3Θ·(round+1), truncated, plus one — a Python float
    times an int32 tensor is float32 in torch as it is (a weak float32) in
    JAX.  Unknown Θ: the triangular schedule in int32 arithmetic, wrapping
    as round_tpu's does (ThetaModel.scala:49-51)."""
    if theta >= 1:
        return (3 * theta * (round_ + 1)).to(torch.int32) + 1
    return ((round_ + 1) * (round_ + 2) // 2).to(torch.int32)


class ThetaRound(Round):
    """round_tpu/models/theta.py::ThetaRound."""

    def __init__(self, f: int, theta: float):
        self.f = f
        self.theta = float(theta)

    def send(self, ctx: RoundCtx, state: ThetaState):
        firing = ctx.r == state.next_round_at
        return broadcast(ctx, {"defined": firing, "round": state.round})

    def update(self, ctx: RoundCtx, state: ThetaState, mbox: Mailbox):
        defined = mbox.mask & mbox.values["defined"]
        heard = torch.where(
            defined, torch.maximum(state.heard, mbox.values["round"]),
            state.heard)
        firing = ctx.r == state.next_round_at
        new_round = torch.where(firing, state.round + 1, state.round)
        nra = torch.where(firing, _next_round_at(self.theta, new_round),
                          state.next_round_at)
        return state.replace(round=new_round, next_round_at=nra, heard=heard)


class ThetaModel(Algorithm):
    """Logical rounds synchronized by the Θ delay-ratio assumption
    (round_tpu/models/theta.py::ThetaModel)."""

    def __init__(self, f: int = 1, theta: float = 2.0):
        self.f = f
        self.theta = theta
        self.rounds = (ThetaRound(f, theta),)

    def make_init_state(self, ctx: RoundCtx, io) -> ThetaState:
        dev = torch.as_tensor(ctx.id).device
        r0 = torch.zeros((), dtype=torch.int32, device=dev)
        return ThetaState(
            round=r0,
            next_round_at=_next_round_at(self.theta, r0),
            heard=torch.full((ctx.n,), -1, dtype=torch.int32, device=dev),
        )
