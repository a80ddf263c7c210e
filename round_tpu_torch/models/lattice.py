"""Lattice agreement over finite set lattices (join = union).

Port of round_tpu/models/lattice.py.  Protocol (example/
LatticeAgreement.scala:32-67): broadcast the proposed set; if more than n/2
received proposals equal yours, decide it; otherwise join (union)
everything received and retry.  Decisions are comparable lattice elements:
any two decided sets are ordered by ⊆.

An element is an [m] bool membership vector over a static universe of m
values, so join is elementwise OR and equality is vector equality.
"""

from __future__ import annotations

import numpy as np
import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import struct


@struct
class LatticeState:
    active: torch.Tensor    # bool
    proposed: torch.Tensor  # [m] bool membership vector
    decided: torch.Tensor   # bool (decision.isDefined ghost)
    decision: torch.Tensor  # [m] bool (meaningless until decided)

    @classmethod
    def fresh(cls, initial, S: int, n: int) -> "LatticeState":
        """[S, n]-batched undecided state from an [n, m] membership matrix,
        on the device of ``initial``."""
        initial = torch.as_tensor(initial) != 0
        dev = initial.device
        m = initial.shape[-1]
        return cls(
            active=torch.ones((S, n), dtype=torch.bool, device=dev),
            proposed=initial.expand((S, n, m)).contiguous(),
            decided=torch.zeros((S, n), dtype=torch.bool, device=dev),
            decision=torch.zeros((S, n, m), dtype=torch.bool, device=dev),
        )


class LatticeRound(Round):
    def send(self, ctx: RoundCtx, state: LatticeState):
        return broadcast(ctx, state.proposed)

    def update(self, ctx: RoundCtx, state: LatticeState, mbox: Mailbox):
        same = mbox.count(
            lambda v: (v == state.proposed[None, :]).all(dim=-1))
        deciding = state.active & (same > ctx.n // 2)
        joined = state.proposed | (
            mbox.values & mbox.mask[:, None]).any(dim=0)

        ctx.exit_at_end_of_round(deciding)
        newly = deciding & ~state.decided
        grow = state.active & ~deciding
        return state.replace(
            active=grow,
            proposed=torch.where(grow[..., None], joined, state.proposed),
            decided=state.decided | deciding,
            decision=torch.where(newly[..., None], state.proposed,
                                 state.decision),
        )


class LatticeAgreement(Algorithm):
    """Lattice agreement: decided values form a chain under ⊆."""

    def __init__(self, universe: int):
        self.universe = universe
        self.rounds = (LatticeRound(),)

    def make_init_state(self, ctx: RoundCtx, io) -> LatticeState:
        proposed = torch.as_tensor(io["initial_value"]) != 0
        flag = torch.zeros(proposed.shape[:-1], dtype=torch.bool,
                           device=proposed.device)
        return LatticeState(
            active=~flag,
            proposed=proposed,
            decided=flag,
            decision=torch.zeros_like(proposed),
        )

    def decided(self, state: LatticeState):
        return state.decided

    def decision(self, state: LatticeState):
        return state.decision


def lattice_io(sets, universe: int, device=None) -> dict:
    """io from per-process collections of ints < universe."""
    mat = np.zeros((len(sets), universe), dtype=bool)
    for i, s in enumerate(sets):
        for v in s:
            mat[i, v] = True
    return {"initial_value": torch.as_tensor(mat, device=device)}
