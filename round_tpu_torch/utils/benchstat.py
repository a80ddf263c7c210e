"""On-device benchmark summaries (port of round_tpu/utils/benchstat.py).

The bench reduces its [S, n] outputs on the device to an O(1)-size summary
before copying anything to the host, so the copy costs nothing next to the
run it closes."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def decided_summary(
    decided: torch.Tensor,
    dec_round: torch.Tensor,
    max_rounds: int,
    decision: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """(decided count, decided-round histogram[, decision checksum]), all on
    the device of the inputs.

    dec_round is -1 for undecided lanes; they are binned at `max_rounds` and
    sliced off the histogram.  The checksum (when a decision tensor is given)
    makes the summary depend on the decided *values*, not just the flags."""
    cnt = decided.to(torch.int32).sum(dtype=torch.int32)
    binned = torch.where(decided, dec_round, max_rounds).reshape(-1)
    hist = torch.bincount(binned.to(torch.int64),
                          minlength=max_rounds + 1)[:max_rounds]
    if decision is None:
        return cnt, hist
    checksum = torch.where(decided, decision, 0).to(torch.int32).sum(
        dtype=torch.int32)
    return cnt, hist, checksum


def p50_from_hist(hist) -> float:
    """Median bin of a histogram (-1 when empty)."""
    hist = np.asarray(hist)
    total = int(hist.sum())
    if total == 0:
        return -1.0
    return float(np.searchsorted(np.cumsum(hist), (total + 1) // 2))


def speed_extra(
    best: float,
    rounds: int,
    cnt,
    hist,
    lanes: int,
    p50_key: str = "decided_round_p50",
) -> dict:
    """The shared stats block: throughput + decision health from an
    on-device (count, histogram) summary."""
    return {
        "rounds_per_sec": round(rounds / best, 3),
        "wall_s_per_run": round(best, 4),
        "rounds_per_run": rounds,
        "frac_lanes_decided": round(float(cnt) / lanes, 4),
        p50_key: p50_from_hist(hist),
    }
