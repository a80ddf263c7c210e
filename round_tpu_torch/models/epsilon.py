"""ε-agreement — approximate consensus with f crash faults (order statistics).

Port of round_tpu/models/epsilon.py.  Protocol (example/Epsilon.scala:
16-71, after Lynch ch. 7): every round broadcast (x, halting?).  Round 0
computes the horizon from the initial spread, maxR = ⌈ log(diff(V)/ε) /
log(c(n-3f, 2f)) ⌉ with c(m,k) = (m-1)/k+1, and x := sorted(V).drop(2f).head.
While r ≤ maxR, x := mean of every 2f-th element of sorted(V) with f
trimmed from each end.  After maxR, decide x; halted processes' last
values stay in every V via the ``halted`` map.  Needs n > 5f and f ≥ 1.

The trimmed mean sums through ``ops.detsum.tree_sum``, the horizon's logs
through ``horizon_log``: both pin their floating-point results so that the
general engine and the count-rank engine (engine/epsfast.py) agree bit for
bit on every device.
"""

from __future__ import annotations

import math

import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.models.common import ghost_decide
from round_tpu_torch.ops.detsum import tree_sum
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import struct

_INF = float("inf")
_INT32_MAX = 2**31 - 1


def horizon_log(x: torch.Tensor) -> torch.Tensor:
    """float32 log as the float32 rounding of the float64 log: the same
    bits on the CPU and the card and whatever the tensor's size (torch's
    float32 log takes a vectorised path or a scalar one by position on the
    CPU, and the two can differ in the last place)."""
    return torch.log(x.to(torch.float64)).to(torch.float32)


def horizon(diff: torch.Tensor, epsilon: float, c: int) -> torch.Tensor:
    """maxR from the spread ``diff`` (float32): 0 when diff ≤ ε, else
    ⌈log(diff/ε) / log(c)⌉ in float32 (round_tpu/models/epsilon.py::
    EpsilonRound.update, Epsilon.scala:33-37)."""
    dev = diff.device
    # ε as a float32 tensor, not a Python scalar: CUDA divides by a scalar
    # as a product with its reciprocal, which is not the float32 quotient
    eps = torch.tensor(epsilon, dtype=torch.float32, device=dev)
    log_c = horizon_log(torch.tensor(float(c), dtype=torch.float32,
                                     device=dev))
    r1 = torch.ceil(horizon_log(diff / eps) / log_c)
    # diff/ε past float32's range (a tiny ε) makes r1 +inf, and maxR
    # saturates as XLA converts it; the -inf or NaN of an empty or
    # one-valued V is discarded below, zeroed first so the cast is defined
    r1i = torch.nan_to_num(r1, nan=0.0, posinf=0.0, neginf=0.0).to(
        torch.int32)
    r1i = torch.where(torch.isposinf(r1), _INT32_MAX, r1i)
    return torch.where(diff <= eps, 0, r1i)


@struct
class EpsilonState:
    x: torch.Tensor            # float32 estimate
    max_r: torch.Tensor        # int32 horizon (set in round 0)
    halted_vals: torch.Tensor  # [n] float32 — last value of halted processes
    halted_mask: torch.Tensor  # [n] bool
    decided: torch.Tensor      # bool
    decision: torch.Tensor     # float32, NaN until decided


class EpsilonRound(Round):
    """The one round of ε-agreement (round_tpu/models/epsilon.py::
    EpsilonRound)."""

    def __init__(self, n: int, f: int, epsilon: float):
        assert f >= 1 and n > 5 * f, "ε-agreement needs n > 5f, f >= 1"
        self.n = n
        self.f = f
        self.epsilon = float(epsilon)
        # c(n-3f, 2f) = (n-3f-1)/(2f) + 1, static (Epsilon.scala:33)
        self.c = (n - 3 * f - 1) // (2 * f) + 1

    def send(self, ctx: RoundCtx, state: EpsilonState):
        return broadcast(ctx, {"v": state.x, "halt": ctx.r > state.max_r})

    def update(self, ctx: RoundCtx, state: EpsilonState, mbox: Mailbox):
        f = self.f
        present = mbox.mask
        vals = mbox.values["v"]
        halts = mbox.values["halt"]

        # V = mailbox values ++ halted values (Epsilon.scala:55)
        V_vals = torch.cat([vals, state.halted_vals])
        V_mask = torch.cat([present, state.halted_mask])
        cnt = V_mask.sum(dtype=torch.int32)
        sorted_v = torch.sort(torch.where(V_mask, V_vals, _INF)).values

        # halted ++= mailbox.filter(halting)
        newly_halted = present & halts
        halted_vals = torch.where(newly_halted, vals, state.halted_vals)
        halted_mask = state.halted_mask | newly_halted

        # round 0: horizon from the spread; x = sorted.drop(2f).head
        v_min = torch.where(V_mask, V_vals, _INF).min()
        v_max = torch.where(V_mask, V_vals, -_INF).max()
        max_r0 = horizon(v_max - v_min, self.epsilon, self.c)
        x_r0 = sorted_v[2 * f]

        # r <= maxR: x = mean of sorted[f + 2f*i], i >= 0, index < cnt - f
        idx = f + 2 * f * torch.arange(2 * self.n, device=vals.device)
        valid = idx < (cnt - f)
        idx = torch.clamp(idx, max=2 * self.n - 1)
        sel = torch.where(valid, sorted_v[idx], 0.0)
        # tree_sum, not torch.sum: the trimmed mean is protocol semantics,
        # and the count-rank engine must get the same bits
        x_mid = tree_sum(sel) / torch.clamp(valid.sum(dtype=torch.int32),
                                            min=1)

        is_r0 = ctx.r == 0
        deciding = ~is_r0 & (ctx.r > state.max_r)
        x = torch.where(is_r0, x_r0, torch.where(deciding, state.x, x_mid))
        ctx.exit_at_end_of_round(deciding)
        state = ghost_decide(state, deciding, state.x)
        return state.replace(
            x=x,
            max_r=torch.where(is_r0, max_r0, state.max_r),
            halted_vals=halted_vals,
            halted_mask=halted_mask,
        )


class EpsilonConsensus(Algorithm):
    """Approximate agreement: decisions within ε of each other, inside the
    range of initial values, tolerating f crash faults
    (round_tpu/models/epsilon.py::EpsilonConsensus)."""

    def __init__(self, n: int, f: int = 1, epsilon: float = 0.1):
        self.f = f
        self.epsilon = epsilon
        self.rounds = (EpsilonRound(n, f, epsilon),)

    def make_init_state(self, ctx: RoundCtx, io) -> EpsilonState:
        n = ctx.n
        x = torch.as_tensor(io["initial_value"]).to(torch.float32)
        dev = x.device
        return EpsilonState(
            x=x,
            max_r=torch.full((), _INT32_MAX, dtype=torch.int32, device=dev),
            halted_vals=torch.zeros((n,), dtype=torch.float32, device=dev),
            halted_mask=torch.zeros((n,), dtype=torch.bool, device=dev),
            decided=torch.zeros((), dtype=torch.bool, device=dev),
            decision=torch.full((), math.nan, dtype=torch.float32,
                                device=dev),
        )

    def decided(self, state: EpsilonState):
        return state.decided

    def decision(self, state: EpsilonState):
        return state.decision


def real_consensus_io(initial_values, device=None) -> dict:
    """io for real-valued consensus (round_tpu/models/epsilon.py::
    real_consensus_io, RealConsensusIO, Epsilon.scala:10-13)."""
    return {"initial_value": torch.as_tensor(initial_values,
                                             dtype=torch.float32,
                                             device=device)}
