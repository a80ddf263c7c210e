"""Interleaved A/B measurement: the shared dot-A/B machinery.

The repo keeps growing paired measurements — bench.py's MXU-dtype A/B
(bf16 vs i8), host_perftest's tracing-overhead check (a 9-pair
interleaved run), and now the wire old-vs-new comparison.  The pattern is
always the same and is easy to get wrong ad hoc: run the two
configurations in ALTERNATING pairs (so drift — thermal, page cache,
background load — hits both arms equally instead of biasing whichever ran
last), after a warmup pass that absorbs one-time costs (jit compile,
socket buildup), and report per-arm samples + means + the ratio.

    from round_tpu_torch.apps.perf_ab import interleaved_ab
    res = interleaved_ab(lambda: measure_old(), lambda: measure_new(),
                         pairs=9)
    res["ratio"]   # mean_b / mean_a

Used by apps/host_perftest.py --ab-wire (pickle vs binary wire),
--ab-lanes (per-instance vs lane-batched driver, runtime/lanes.py) and
the tools/soak.py host-perf / host-lanes rungs; bench.py's dtype A/B
keeps its own artifact plumbing but follows the same pair discipline.

Port of round_tpu/apps/perf_ab.py, unchanged (host Python).
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List


def interleaved_ab(run_a: Callable[[], float], run_b: Callable[[], float],
                   pairs: int = 9, warmup: int = 1) -> Dict:
    """Run ``pairs`` alternating A/B pairs (A first in even pairs, B first
    in odd ones — order bias cancels over the run) after ``warmup``
    discarded passes of each arm.  Each callable returns its metric
    sample (higher = better, e.g. decisions/sec).  Returns samples,
    means, medians and ``ratio`` = mean_b / mean_a."""
    if pairs < 1:
        raise ValueError(f"pairs must be >= 1, got {pairs}")
    for _ in range(max(0, warmup)):
        run_a()
        run_b()
    a: List[float] = []
    b: List[float] = []
    for i in range(pairs):
        if i % 2 == 0:
            a.append(float(run_a()))
            b.append(float(run_b()))
        else:
            b.append(float(run_b()))
            a.append(float(run_a()))
    mean_a, mean_b = statistics.fmean(a), statistics.fmean(b)
    return {
        "pairs": pairs,
        "warmup": warmup,
        "a": [round(x, 3) for x in a],
        "b": [round(x, 3) for x in b],
        "mean_a": round(mean_a, 3),
        "mean_b": round(mean_b, 3),
        "median_a": round(statistics.median(a), 3),
        "median_b": round(statistics.median(b), 3),
        "ratio": round(mean_b / mean_a, 3) if mean_a > 0 else 0.0,
    }
