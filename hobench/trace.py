"""The harness's spans and the reduction of a profiler trace to what the
per-layer metrics read.

Every batch of the window runs inside a `batch` span, and its steps inside
`engine` (the program's entry), `summary` (the verdict reduced on the
device, its copy queued, and later the wait for it on the host) and, in
between, `salts` (the next batch's fresh draws and fresh state).  The spans time each step on the host's clock; in a
traced run their ends are also taken on the realtime clock, which the
profiler's host events use, so that the trace places each device
operation in the step and batch whose runtime call launched it.

`reduce_trace` works on plain tuples, so that it can be tested without a
card:

  ("span", name, start_ns, end_ns)           a harness span
  ("launch", correlation, start_ns)          a CUDA runtime call
  ("device", name, start_ns, end_ns, link)   a kernel, copy or fill; link
                                             is its runtime call's
                                             correlation (0: none)
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

STEPS = ("salts", "engine", "summary")
# the breakdown's names are kernels' names cut to this length
NAME_CHARS = 96


class Spans:
    """Host-clock spans of the steps of one batch at a time, and in a
    traced run every span's start and end on the clock of the profiler's
    host events (the realtime clock, in ns) for reduce_trace."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.current: Dict[str, float] = {}
        self.timeline: List[Tuple] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        try:
            yield
        finally:
            self.current[name] = time.perf_counter() - t0
            if self.traced:
                self.timeline.append(("span", name, w0, time.time_ns()))

    def take(self) -> Dict[str, float]:
        got, self.current = self.current, {}
        return got


def profile():
    """A started profiler of the card: its kernels, copies and fills, and
    the host's CUDA runtime calls that launched them.  Host operators are
    not recorded, so that the host's spans keep their length."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    # a CPU-only build records no device, and its host operators stand in
    prof = torch_profile(activities=[
        ProfilerActivity.CUDA if torch.cuda.is_available()
        else ProfilerActivity.CPU])
    prof.__enter__()
    return prof


def events(prof) -> List[Tuple]:
    """The stopped profiler's events as the tuples reduce_trace reads: the
    host's runtime calls by correlation id, and the device's operations
    with the correlation id that links each to its call."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        if str(e.device_type()).endswith("CPU"):
            if e.correlation_id():
                out.append(("launch", e.correlation_id(), start))
        else:
            out.append(("device", e.name(), start, start + e.duration_ns(),
                        e.correlation_id()))
    return out


@dataclass
class Op:
    name: str
    start: int
    end: int
    step: str     # the harness step that launched it ("" where unknown)
    batch: int    # the traced batch that launched it (-1 where unknown)


@dataclass
class Trace:
    window: Tuple[int, int]          # ns: first batch's start, last's end
    batches: List[Tuple[int, int]]   # ns: each batch span, in order
    ops: List[Op] = field(default_factory=list)
    busy_ns: int = 0
    idle_by_step: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def device_ops(self, top: int = 10) -> List[List]:
        """[[name, seconds]] of the device's operations that took most
        time, summed by name."""
        by = defaultdict(int)
        for op in self.ops:
            by[op.name[:NAME_CHARS]] += op.end - op.start
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v / 1e9] for k, v in ranked]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """[[step, seconds]]: the device's idle time in the window, summed
        by the harness step the host was in when each gap began."""
        ranked = sorted(self.idle_by_step.items(), key=lambda kv: -kv[1])
        return [[k, v / 1e9] for k, v in ranked[:top]]


class _Intervals:
    """Sorted, non-overlapping named intervals, looked up by time."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda it: it[1])
        self.starts = [it[1] for it in self.items]

    def find(self, t: int) -> Optional[int]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.items[i][2]:
            return i
        return None


def reduce_trace(evs) -> Optional[Trace]:
    """The traced window, its device operations with the step and batch
    that launched each, the device's busy time and its idle time by step.
    None where the trace holds no batch span."""
    batch_spans = _Intervals([e[1:] for e in evs
                              if e[0] == "span" and e[1] == "batch"])
    if not batch_spans.items:
        return None
    steps = _Intervals([e[1:] for e in evs
                        if e[0] == "span" and e[1] in STEPS])
    launched = {e[1]: e[2] for e in evs if e[0] == "launch"}
    lo, hi = batch_spans.items[0][1], batch_spans.items[-1][2]
    trace = Trace(window=(lo, hi),
                  batches=[(s, t) for _, s, t in batch_spans.items])
    for _, name, start, end, link in (e for e in evs if e[0] == "device"):
        if end <= lo or start >= hi:
            continue
        at = launched.get(link, start) if link else start
        i = steps.find(at)
        b = batch_spans.find(at)
        trace.ops.append(Op(name, max(start, lo), min(end, hi),
                            steps.items[i][0] if i is not None else "",
                            -1 if b is None else b))
    trace.ops.sort(key=lambda op: op.start)
    # the union of the operations' intervals, and the gaps between them
    idle = defaultdict(int)
    cursor = lo
    for op in trace.ops:
        if op.start > cursor:
            _gap(idle, steps, cursor, op.start)
        if op.end > cursor:
            trace.busy_ns += op.end - max(op.start, cursor)
            cursor = op.end
    if hi > cursor:
        _gap(idle, steps, cursor, hi)
    trace.idle_by_step = dict(idle)
    return trace


def _gap(idle, steps: _Intervals, start: int, end: int) -> None:
    i = steps.find(start)
    idle[steps.items[i][0] if i is not None else "between"] += end - start
