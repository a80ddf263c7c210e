"""ε-agreement — approximate consensus with f crash faults (order statistics).

Port of round_tpu/models/epsilon.py.  Protocol (example/Epsilon.scala:
16-71, after Lynch ch. 7): every round broadcast (x, halting?).  Round 0
computes the horizon from the initial spread, maxR = ⌈ log(diff(V)/ε) /
log(c(n-3f, 2f)) ⌉ with c(m,k) = (m-1)/k+1, and x := sorted(V).drop(2f).head.
While r ≤ maxR, x := mean of every 2f-th element of sorted(V) with f
trimmed from each end.  After maxR, decide x; halted processes' last
values stay in every V via the ``halted`` map.  Needs n > 5f and f ≥ 1.

The trimmed mean sums through ``ops.detsum.tree_sum``, the horizon's log
through ``horizon_log`` (XLA's float32 log on the CPU, emulated): both pin
their floating-point results so that the general engine and the
count-rank engine (engine/epsfast.py) agree bit for bit with each other on
every device, and with round_tpu.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx, broadcast
from round_tpu_torch.models.common import ghost_decide
from round_tpu_torch.ops.detsum import tree_sum
from round_tpu_torch.ops.mailbox import Mailbox
from round_tpu_torch.utils.tree import struct

_INF = float("inf")
_INT32_MAX = 2**31 - 1


def _f32(word: int) -> float:
    """The float32 whose bit pattern is `word`, as a Python float."""
    return float(np.uint32(word).view(np.float32))


# XLA's float32 log on the CPU (Cephes' logf): the polynomial's nine
# coefficients p0..p8, ln 2 split as q2 + q1, √½, the smallest normal
_LOG_P = tuple(_f32(w) for w in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50,
    0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA))
_LOG_Q1, _LOG_Q2 = _f32(0xB95E8083), _f32(0x3F318000)
_SQRT_HALF, _MIN_NORMAL = _f32(0x3F3504F3), _f32(0x00800000)


def _fma32(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32, as the x86 FMA rounds it.  The
    float32 product is exact in float64; the float64 sum is rounded to
    float32, and where it landed exactly on a float32 midpoint that the
    exact sum is not on, the TwoSum error picks the side."""
    like = a if isinstance(a, torch.Tensor) else b
    a64, b64, c64 = (torch.as_tensor(t, device=like.device).to(torch.float64)
                     for t in (a, b, c))
    p = a64 * b64
    s = p + c64
    z = s - p
    err = (p - (s - z)) + (c64 - z)          # s + err == a·b + c exactly
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    toward = torch.where(s > r64, math.inf, -math.inf).to(torch.float32)
    nb = torch.nextafter(r, toward)          # r's neighbour on s's side
    nb64 = nb.to(torch.float64)
    tie = (s == (r64 + nb64) * 0.5) & (err != 0)
    return torch.where(tie & ((nb64 > r64) == (err > 0)), nb, r)


def horizon_log(x: torch.Tensor) -> torch.Tensor:
    """float32 log, bit for bit XLA's on the CPU — what round_tpu's horizon
    computes (round_tpu/models/epsilon.py::EpsilonRound.update).  The
    algorithm is the one XLA compiles jnp.log to on x86 (its object code):
    clamp to the smallest normal, x = m·2^e with m in [0.5, 1), m < √½
    folded into (m − 1) + m and e − 1; Cephes' polynomial as three
    fused Horner pairs a, b, c joined as ((a·x³ + b)·x³ + c)·x³ + e·q1,
    each step one FMA; then ((x − x²/2) + that) + e·q2, the first and
    the last step FMAs.  Written in elementwise torch ops (each float32
    FMA emulated exactly in float64), so the CPU and the card give the
    same bits.  Zero and subnormal inputs give -inf, negative ones and NaN
    give NaN."""
    x = torch.as_tensor(x).to(torch.float32)
    # XLA's code runs with subnormal inputs read as zero
    x = torch.where(x.abs() < _MIN_NORMAL, 0.0, x)
    m, ex = torch.frexp(torch.clamp(x, min=_MIN_NORMAL))
    small = m < _SQRT_HALF
    y = (m - 1.0) + torch.where(small, m, 0.0)
    e = ex.to(torch.float32) - small.to(torch.float32)
    p = _LOG_P
    y2 = y * y
    y3 = y2 * y
    a = _fma32(y, _fma32(y, p[0], p[1]), p[2])
    b = _fma32(y, _fma32(y, p[3], p[4]), p[5])
    c = _fma32(y, _fma32(y, p[6], p[7]), p[8])
    u = _fma32(y3, _fma32(y3, a, b), c)
    v = _fma32(y3, u, e * _LOG_Q1)
    out = _fma32(e, _LOG_Q2, _fma32(y2, -0.5, y) + v)
    out = torch.where(x == 0, -math.inf, out)
    return torch.where((x < 0) | torch.isnan(x), math.nan, out).where(
        ~torch.isposinf(x), math.inf)


def horizon(diff: torch.Tensor, epsilon: float, c: int) -> torch.Tensor:
    """maxR from the spread ``diff`` (float32): 0 when diff ≤ ε, else
    ⌈log(diff/ε) / log(c)⌉ in float32 as XLA compiles round_tpu's
    expression (round_tpu/models/epsilon.py::EpsilonRound.update,
    Epsilon.scala:33-37).  ε and log(c) are constants there, and XLA
    divides by a constant as a product with its float32 reciprocal; it
    folds log(c) at compile time to the correctly rounded float32 log.
    So: ⌈horizon_log(diff · fl(1/ε)) · fl(1/log c)⌉, the reciprocals
    taken on the host in float32 and multiplied as float32 tensors (a
    product of two tensors rounds alike on the CPU and the card)."""
    dev = diff.device
    eps32 = np.float32(epsilon)
    inv_eps = torch.tensor(np.float32(1.0) / eps32, device=dev)
    inv_log_c = torch.tensor(np.float32(1.0) / np.float32(math.log(c)),
                             device=dev)
    r1 = torch.ceil(horizon_log(diff * inv_eps) * inv_log_c)
    # diff/ε past float32's range (a tiny ε) makes r1 +inf, and maxR
    # saturates as XLA converts it; the -inf or NaN of an empty or
    # one-valued V is discarded below, zeroed first so the cast is defined
    r1i = torch.nan_to_num(r1, nan=0.0, posinf=0.0, neginf=0.0).to(
        torch.int32)
    r1i = torch.where(torch.isposinf(r1), _INT32_MAX, r1i)
    return torch.where(diff <= torch.tensor(eps32, device=dev), 0, r1i)


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
