"""The yardstick of the kernels' roofline shares: the card's peaks, the
least operations a drawn link needs, and the links and bytes a batch
needs.  Frozen here from the port's bring-up smoke (chip_smoke.py), so
that a later change to the program cannot move it.

Published peaks of one H100 SXM at its 700 W limit: HBM bandwidth from
NVIDIA's data sheet; integer issue rates from the Hopper white paper over
132 SMs at the 1.98 GHz boost clock.  LOP3, PRMT and funnel shifts issue
on the ALU pipe, multiplies (IMAD) on the FMA pipe, each 64 lanes per SM
per clock, and the two run alongside; an add, or a right shift by a
constant, can issue on either.
"""

from __future__ import annotations

import torch

from hobench.mixgen import round_colmask

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9  # per pipe
# (ALU only, FMA only, either pipe) operations per hashed link: fmix32's
# xors, shifts and two multiplies, the packed last fold and the keep
# compare, and the link index.  Packing for the tensor-core count is left
# out, so the bound is a floor.
HASH_OPS = (2 + 5 / 4 + 2 / 4, 2, 1 + 2 + 1 / 4)
# One Philox4x32-10 call: 19 three-way xors (ALU), 18 multiplies (FMA),
# the counter's add (either).  A call draws 16 links; each link adds a
# quarter of the keep compare (two LOP3 and a subtract a word).
PHILOX_OPS = (19, 18, 1)
HW_OPS = ((PHILOX_OPS[0] + 4 * 2) / 16, PHILOX_OPS[1] / 16,
          (PHILOX_OPS[2] + 4) / 16)
OPS = {"hash": HASH_OPS, "hw": HW_OPS}


def bound_ms(nbytes: float, links: float, ops) -> float:
    """The least milliseconds of the work: the larger of its bytes over
    the HBM bandwidth and its operations over the integer pipes, the
    either-pipe work placed to even the two pipes out."""
    alu, fma, either = ops
    per_pipe = max(alu, fma, (alu + fma + either) / 2)
    t_ops = links * per_pipe / INT_OPS_PER_S * 1e3
    return max(nbytes / HBM_BYTES_PER_S * 1e3, t_ops)


def _hashed(structure) -> torch.Tensor:
    """[S] float64: 1 where the scenario's links need a draw
    (0 < p8 < 256)."""
    p8 = structure["p8"]
    return ((p8 > 0) & (p8 < 256)).to(torch.float64)


def _last_active(decided_round, rounds: int, linger: int) -> torch.Tensor:
    """[S, n]: the last round in which each process is active.  A process
    that decides in round d exits at the end of round d + linger."""
    return torch.where(decided_round >= 0, decided_round + linger, rounds)


def loop_links(structure, decided_round, rounds: int, linger: int):
    """[rounds] float64: links (i -> j, i != j) the whole-run kernel draws
    in each round: for every scenario that draws, each sending process
    still active times each other receiver still active."""
    last = _last_active(decided_round, rounds, linger)
    h = _hashed(structure)
    out = []
    for r in range(rounds):
        active = r <= last
        senders = (round_colmask(structure, r) & active).sum(1).double()
        receivers = active.sum(1).double()
        out.append(float((h * senders * torch.clamp(receivers - 1,
                                                    min=0)).sum()))
    return out


def exchange_links(structure, decided_round, rounds: int, linger: int):
    """[rounds] float64: links the per-round exchange kernel draws in each
    round: each sending process still active times the n - 1 other
    processes (it counts for every receiver)."""
    last = _last_active(decided_round, rounds, linger)
    h = _hashed(structure)
    n = decided_round.shape[1]
    out = []
    for r in range(rounds):
        senders = (round_colmask(structure, r) & (r <= last)).sum(1).double()
        out.append(float((h * senders * (n - 1)).sum()))
    return out


def loop_bytes(S: int, n: int, outputs: int) -> int:
    """Bytes a whole-run launch must move: the initial values and sides
    (int32) and the crash set (bool) read, `outputs` int32 [S, n] outputs
    written, six [S] int32 scalars read."""
    return S * n * (4 * 2 + 1 + 4 * outputs) + 4 * 6 * S


def exchange_bytes(S: int, n: int, num_values: int) -> int:
    """Bytes one exchange launch must move: values, senders and sides
    (int32) and three [S] int32 scalars read, float32 counts written."""
    return 4 * S * n * 3 + 4 * 3 * S + 4 * S * num_values * n


def loop_bound_ms(cell, kept: dict) -> float:
    """The least milliseconds of one batch's whole-run launch."""
    S, n = kept["decided_round"].shape
    cfg = cell.config
    links = loop_links(kept["structure"], kept["decided_round"],
                       cfg["rounds"], cell.algo.linger(cfg))
    return bound_ms(loop_bytes(S, n, len(cell.algo.FIELDS)), sum(links),
                    OPS[cfg["link_mode"]])


def exchange_bound_ms(cell, kept: dict) -> float:
    """The least milliseconds of one batch's exchange launches, one a
    round."""
    S, n = kept["decided_round"].shape
    cfg = cell.config
    nbytes = exchange_bytes(S, n, cell.algo.message_values(cfg))
    links = exchange_links(kept["structure"], kept["decided_round"],
                           cfg["rounds"], cell.algo.linger(cfg))
    return sum(bound_ms(nbytes, r_links, OPS[cfg["link_mode"]])
               for r_links in links)


def kernel_ms_per_batch(trace, kernel: str):
    """Mean device ms a traced batch spends in kernels whose name holds
    `kernel`, over the batches that launched one; None where none did."""
    ns, batches = 0, set()
    for op in trace.ops:
        if kernel in op.name and op.batch >= 0:
            ns += op.end - op.start
            batches.add(op.batch)
    return ns / 1e6 / len(batches) if batches else None
