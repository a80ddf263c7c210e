"""Conway's Game of Life on a torus overlay — synchronous cellular automaton.

Port of round_tpu/models/gameoflife.py.  Reference:
example/ConwayGameOfLife.scala:12-76 — one process per cell, each sends its
aliveness to its 8 torus neighbours (getNeighbours,
ConwayGameOfLife.scala:92-112) and applies the B3/S23 rule on what it
heard.  A deliberately non-consensus example: it exercises
point-to-multipoint dest masks (neither broadcast nor unicast) and overlay
topologies.  Its fused form is engine.fast.run_gol_fast.
"""

from __future__ import annotations

import numpy as np
import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, SendSpec
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import struct


def torus_neighbours(rows: int, cols: int) -> np.ndarray:
    """[n, n] bool: neighbours[i, j] = cell j is one of i's 8 neighbours
    (round_tpu/models/gameoflife.py::torus_neighbours)."""
    n = rows * cols
    out = np.zeros((n, n), dtype=bool)
    for i in range(n):
        r, c = divmod(i, cols)
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                if dr == 0 and dc == 0:
                    continue
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                out[i, j] = True
    return out


@struct
class CgolState:
    alive: torch.Tensor  # bool


class CgolRound(Round):
    """round_tpu/models/gameoflife.py::CgolRound: each cell sends to its
    row of the overlay, a point-to-multipoint SendSpec."""

    def __init__(self, neighbours):
        self.neighbours = torch.as_tensor(np.asarray(neighbours, dtype=bool))
        self._on = {}

    def _table(self, device) -> torch.Tensor:
        """The overlay on `device`, copied there once."""
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = self.neighbours.to(device)
        return t

    def send(self, ctx: RoundCtx, state: CgolState):
        return SendSpec(state.alive, self._table(state.alive.device)[ctx.id])

    def update(self, ctx: RoundCtx, state: CgolState, mbox: Mailbox):
        alive_nbrs = mbox.count(lambda v: v)
        survive = state.alive & ((alive_nbrs == 2) | (alive_nbrs == 3))
        born = ~state.alive & (alive_nbrs == 3)
        return state.replace(alive=survive | born)


class ConwayGameOfLife(Algorithm):
    """round_tpu/models/gameoflife.py::ConwayGameOfLife."""

    def __init__(self, rows: int, cols: int):
        self.rows = rows
        self.cols = cols
        self.rounds = (CgolRound(torus_neighbours(rows, cols)),)

    def make_init_state(self, ctx: RoundCtx, io) -> CgolState:
        return CgolState(alive=torch.as_tensor(io["alive"]) != 0)


def cgol_io(grid, device=None) -> dict:
    """io from a [rows, cols] bool array (round_tpu/models/gameoflife.py::
    cgol_io)."""
    g = torch.as_tensor(grid, device=device) != 0
    return {"alive": g.reshape(-1)}
