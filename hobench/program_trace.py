"""The program's own spans against a run's device trace: which program
step launched each device operation, which step the host was in when the
card went idle, and the per-layer readings those give.

    python3 hobench/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

runs one run of the cell as hobench/run.py does, and prints run.py's
result line, then one more JSON line, {"program_spans": {...}}.  For that
run round_tpu_torch's tracer (`obs.trace.TRACE`) is cleared and enabled
where the window starts and disabled when `batch.run` returns: hooks on
`hobench.trace.Spans` (its timeline's clear marks the window's start),
`hobench.trace.reduce_trace` (its input, the harness's events) and
`hobench.drivers.batch.run` (its record), all within this process.
With --trace 0 the line gives host ms a batch by span and by harness
step, from spans alone, and run.py's line is the end-to-end metrics with
the tracer on; with --trace 1 it also places each device operation under
the program spans open at its runtime call and each idle gap under the
harness step and the innermost program span open where it began.

`reduce_program` works on plain data, as hobench/trace.py's
`reduce_trace` does: the harness's tuples and the tracer's span events

  {"ev": "span", "name", "t0_ns", "t1_ns", "id", "parent", ...}

(round_tpu_torch/docs/OBSERVABILITY.md lists the names).  Its readings
are None where the program opened no such span, and where the tracer
dropped events, since a truncated trace would read low.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hobench import trace  # noqa: E402

K2 = "hist_exchange_kernel"
SYNC = "engine.require_fresh"
ROUND_STEPS = ("round.params", "round.exchange", "round.update",
               "round.freeze")
READINGS = ("engine_sync_ms",) + tuple(
    s.replace(".", "_") + "_ms" for s in ROUND_STEPS)
# events the tracer keeps: a per-round batch opens ~300 spans, and a
# 20-s window runs ~200 such batches
CAPACITY = 1 << 18


class SpanIndex:
    """One thread's program spans, looked up by time: the innermost span
    open at t, and its path from its root."""

    def __init__(self, spans: List[dict]):
        self.by_id = {s["id"]: s for s in spans}
        self.order = sorted(spans, key=lambda s: s["t0_ns"])
        self.starts = [s["t0_ns"] for s in self.order]

    def innermost(self, t: int) -> Optional[dict]:
        # spans nest, so the innermost open at t is the last to start
        # before t or one of its ancestors
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.order[i] if i >= 0 else None
        while s is not None and s["t1_ns"] < t:
            s = self.by_id.get(s["parent"])
        return s

    def path(self, s: Optional[dict]) -> str:
        names = []
        while s is not None:
            names.append(s["name"])
            s = self.by_id.get(s["parent"])
        return "/".join(reversed(names))


@dataclass
class ProgramTrace:
    batches: int
    dropped: int
    # span name -> host ns inside such spans that began in the window
    host_ns: Dict[str, int] = field(default_factory=dict)
    # (span path, op name, device ns) of each op launched in the window;
    # "" where no program span was open at its runtime call
    ops: List[Tuple[str, str, int]] = field(default_factory=list)
    # "<step>" or "<step>:<innermost span>" -> idle ns beginning there
    idle_ns: Dict[str, int] = field(default_factory=dict)

    def readings(self) -> Dict[str, Optional[float]]:
        """engine_sync_ms (host ms a batch inside engine.require_fresh)
        and round_<step>_ms (device ms a batch of the ops launched under
        each round step, K2 left out; only where K2 ran), each where the
        program opened that span; None where it did not (a program
        without the span reads nothing, not 0) and throughout where the
        tracer dropped events."""
        out: Dict[str, Optional[float]] = dict.fromkeys(READINGS)
        if self.dropped or not self.batches:
            return out
        if SYNC in self.host_ns:
            out["engine_sync_ms"] = self.host_ns[SYNC] / 1e6 / self.batches
        if any(K2 in name for _, name, _ in self.ops):
            for step, key in zip(ROUND_STEPS, READINGS[1:]):
                if step not in self.host_ns:
                    continue
                ns = sum(d for path, name, d in self.ops
                         if step in path.split("/") and K2 not in name)
                out[key] = ns / 1e6 / self.batches
        return out

    def device_ms(self) -> Dict[str, float]:
        """Device ms a batch by the span path its ops were launched
        under."""
        by = defaultdict(int)
        for path, _, d in self.ops:
            by[path] += d
        return {k: v / 1e6 / self.batches for k, v in sorted(by.items())}

    def host_ms(self) -> Dict[str, float]:
        return {k: v / 1e6 / self.batches
                for k, v in sorted(self.host_ns.items())}

    def idle_gaps(self, top: int = 12) -> List[List]:
        ranked = sorted(self.idle_ns.items(), key=lambda kv: -kv[1])
        return [[k, v / 1e9] for k, v in ranked[:top]]


def _spans(events) -> List[dict]:
    return [e for e in events if e.get("ev") == "span"]


def host_ns(spans: List[dict], lo: int = 0,
            hi: int = 1 << 63) -> Dict[str, int]:
    """Host ns by span name, of the spans that began in [lo, hi)."""
    by = defaultdict(int)
    for s in spans:
        if lo <= s["t0_ns"] < hi:
            by[s["name"]] += s["t1_ns"] - s["t0_ns"]
    return dict(by)


def reduce_program(evs, events, dropped: int) -> Optional[ProgramTrace]:
    """`evs`: the harness's tuples (reduce_trace's input); `events`: the
    tracer's events.  None where the trace holds no batch span.  The idle
    gaps are those of reduce_trace, each named by its step and the
    innermost program span open at its start, so that each step's
    entries sum to reduce_trace's idle_by_step[step]."""
    tr = trace.reduce_trace(evs)
    if tr is None:
        return None
    lo, hi = tr.window
    spans = _spans(events)
    index = SpanIndex(spans)
    steps = trace._Intervals([e[1:] for e in evs
                              if e[0] == "span" and e[1] in trace.STEPS])
    launched = {e[1]: e[2] for e in evs if e[0] == "launch"}
    ops = []
    for _, name, start, end, link in (e for e in evs if e[0] == "device"):
        if end <= lo or start >= hi:
            continue
        at = launched.get(link, start) if link else start
        ops.append((max(start, lo), min(end, hi), name,
                    index.path(index.innermost(at))))
    ops.sort(key=lambda op: op[0])
    out = ProgramTrace(batches=len(tr.batches), dropped=dropped,
                       host_ns=host_ns(spans, lo, hi),
                       ops=[(path, name, end - start)
                            for start, end, name, path in ops])
    idle = defaultdict(int)

    def gap(start: int, end: int) -> None:
        i = steps.find(start)
        step = steps.items[i][0] if i is not None else "between"
        s = index.innermost(start)
        idle[f"{step}:{s['name']}" if s is not None else step] += end - start

    cursor = lo
    for start, end, _, _ in ops:
        if start > cursor:
            gap(cursor, start)
        cursor = max(cursor, end)
    if hi > cursor:
        gap(cursor, hi)
    out.idle_ns = dict(idle)
    return out


def main(argv=None, root: Path = ROOT, device=None, t0: float = T0) -> int:
    """One run (run.main's arguments), then the program_spans line."""
    from round_tpu_torch.obs.trace import TRACE

    from hobench import run
    from hobench.drivers import batch

    args = run.parse_args(argv)
    seen: dict = {}

    class Timeline(list):
        def clear(self):  # batch.run clears it where the window starts
            super().clear()
            TRACE.clear()
            TRACE.enable(capacity=CAPACITY)

    class Spans(trace.Spans):
        def __init__(self, traced: bool):
            super().__init__(traced)
            self.timeline = Timeline()

    hooked = trace.Spans, trace.reduce_trace, batch.run
    reduce_trace, run_batches = hooked[1:]

    def keep_evs(evs):
        seen["evs"] = list(evs)
        return reduce_trace(evs)

    def keep_record(*a, **k):
        try:
            seen["record"] = rec = run_batches(*a, **k)
        finally:
            TRACE.disable()
        return rec

    trace.Spans, trace.reduce_trace, batch.run = Spans, keep_evs, keep_record
    try:
        rc = run.main(argv, root=root, device=device, t0=t0)
    finally:
        trace.Spans, trace.reduce_trace, batch.run = hooked
    if rc != 0:
        return rc
    rec, events = seen["record"], TRACE.events()
    steps = defaultdict(float)
    for b in rec.window:
        for k in ("batch",) + trace.STEPS:
            steps[k] += b.get(k, 0.0)
    line = {"trace": args.trace, "dropped": TRACE.dropped,
            "step_ms": {k: v * 1e3 / len(rec.window)
                        for k, v in steps.items()}}
    pt = reduce_program(seen["evs"], events, TRACE.dropped) \
        if "evs" in seen else None
    if pt is None:  # untraced: the spans of the window alone
        pt = ProgramTrace(batches=len(rec.window), dropped=TRACE.dropped,
                          host_ns=host_ns(_spans(events)))
    line.update(batches=pt.batches, readings=pt.readings(),
                host_ms=pt.host_ms())
    if pt.ops:
        line.update(device_ms=pt.device_ms(), idle_gaps=pt.idle_gaps())
    print(json.dumps({"program_spans": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
