"""◇S eventually-strong failure detector (heartbeat + hysteresis).

Port of round_tpu/models/failure_detector.py.  Protocol
(example/EventuallyStrongFailureDetector.scala:10-58): every period each
process bumps a per-peer ``lastSeen`` counter (capped at hysteresis+1),
broadcasts its suspected set {p : lastSeen(p) > hysteresis}, zeroes the
counter of every sender it hears, and adopts others' suspicions (a
suspected peer it did not hear this round jumps straight past the
hysteresis threshold).

The reference's per-message EventRound receive loop is order-insensitive in
aggregate (a present sender always ends unsuspected; an absent peer
suspected by any present sender trips the threshold), so the update
vectorizes to three masked writes.  Its fused form is
engine.fast.run_esfd_fast.
"""

from __future__ import annotations

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import struct


@struct
class EsfdState:
    last_seen: torch.Tensor  # [n] int32, capped at hysteresis+1


class EsfdRound(Round):
    """round_tpu/models/failure_detector.py::EsfdRound."""

    def __init__(self, hysteresis: int):
        self.h = hysteresis

    def suspected(self, state: EsfdState) -> torch.Tensor:
        return state.last_seen > self.h

    def send(self, ctx: RoundCtx, state: EsfdState):
        return broadcast(ctx, self.suspected(state))

    def update(self, ctx: RoundCtx, state: EsfdState, mbox: Mailbox):
        h = self.h
        present = mbox.mask            # [n] senders heard this round
        sus = mbox.values              # [n, n] suspected sets

        # init slot: lastSeen := min(lastSeen + 1, h + 1)
        ls = torch.clamp(state.last_seen + 1, max=h + 1)
        # adopt suspicions of peers we did not hear this round...
        accused = (present[:, None] & sus).any(dim=0)
        ls = torch.where(accused & ~present, h + 1, ls)
        # ...and zero the counter of everyone we heard (wins over adoption)
        ls = torch.where(present, 0, ls)
        return state.replace(last_seen=ls.to(torch.int32))


class Esfd(Algorithm):
    """◇S: eventually every crashed process is suspected by all correct
    processes and some correct process is never suspected
    (round_tpu/models/failure_detector.py::Esfd)."""

    def __init__(self, hysteresis: int = 5):
        self.hysteresis = hysteresis
        self.rounds = (EsfdRound(hysteresis),)

    def make_init_state(self, ctx: RoundCtx, io) -> EsfdState:
        dev = torch.as_tensor(ctx.id).device
        return EsfdState(last_seen=torch.zeros((ctx.n,), dtype=torch.int32,
                                               device=dev))

    def suspected(self, state: EsfdState) -> torch.Tensor:
        """[n_lanes, n] suspicion matrix accessor."""
        return state.last_seen > self.hysteresis
