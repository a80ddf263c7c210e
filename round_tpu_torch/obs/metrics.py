"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

Port of round_tpu/obs/metrics.py, unchanged in behaviour: one
counters/timers surface for the port.

* ``Counter`` / ``Gauge`` / ``Histogram`` — typed instruments, created
  get-or-create through a ``MetricsRegistry``;
* ``MetricsRegistry.snapshot()`` / ``to_json()`` — machine-readable
  snapshots;
* ``MetricsRegistry.to_prometheus()`` — Prometheus text exposition (the
  metric names carry round_tpu's ``round_tpu_`` prefix, so one scrape
  config reads either package);
* ``Stats`` — the legacy counters/timers API (psync.utils.Stats,
  utils/Stats.scala:7-98, + the --stat shutdown report,
  utils/Options.scala:16-25) on top of the registry.

``METRICS`` is the process-wide registry; instrumented modules reach it
directly.  The port's engines count ``engine.hist_runs``
(engine.fast.run_hist) and ``engine.loop_runs`` (engine.fast.run_otr_loop)
at Python entry, as round_tpu's do.  Instruments are always-on (a
lock-guarded int add per event); the legacy ``Stats`` surface keeps its
opt-in ``enabled`` gate.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# timer histograms (seconds) — compile/run/save latencies from sub-ms to
# minutes
TIME_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 300.0)
# round/deadline latencies (milliseconds) on the host path
MS_BUCKETS: Tuple[float, ...] = (
    1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000)


class Counter:
    """Monotonic event count."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, delta: int = 1) -> None:
        with self._lock:
            self._v += delta

    def reset(self) -> None:
        with self._lock:
            self._v = 0

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    """Last-written value (deadline in force, density, rounds/sec).

    Tracks whether it was ever written: a gauge legitimately reading 0.0
    (a mailbox floor of zero is the most alarming value such a gauge
    exists to report) must stay distinguishable from one never set —
    compact snapshots drop only the never-written."""

    __slots__ = ("name", "_v", "_touched", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._touched = False
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)
            self._touched = True

    def inc(self, delta: float = 1.0) -> None:
        with self._lock:
            self._v += delta
            self._touched = True

    def reset(self) -> None:
        with self._lock:
            self._v = 0.0
            self._touched = False

    @property
    def touched(self) -> bool:
        return self._touched

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Fixed-bucket histogram (cumulative le-buckets + count + sum —
    the Prometheus shape).  ``unit`` documents what ``observe`` receives
    ("s" for timers, "ms" for round latencies); the --stat report prints
    unit=="s" histograms in the reference's timer line format."""

    __slots__ = ("name", "unit", "buckets", "_counts", "_count", "_sum",
                 "_lock")

    def __init__(self, name: str, buckets: Sequence[float] = TIME_BUCKETS_S,
                 unit: str = "s"):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"buckets must be ascending, got {buckets!r}")
        self.name = name
        self.unit = unit
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * len(self.buckets)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    break

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self.buckets)
            self._count = 0
            self._sum = 0.0

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ..., (inf, count)] — Prometheus-style."""
        out, acc = [], 0
        with self._lock:
            for b, c in zip(self.buckets, self._counts):
                acc += c
                out.append((b, acc))
            out.append((float("inf"), self._count))
        return out


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return "round_tpu_" + _PROM_BAD.sub("_", name)


class MetricsRegistry:
    """Get-or-create instrument store with JSON / Prometheus snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # -- instrument creation (get-or-create; type clashes are bugs) -------

    def counter(self, name: str) -> Counter:
        with self._lock:
            self._check_free(name, self._counters)
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            self._check_free(name, self._gauges)
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,
                  buckets: Sequence[float] = TIME_BUCKETS_S,
                  unit: str = "s") -> Histogram:
        with self._lock:
            self._check_free(name, self._hists)
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, buckets, unit)
            elif (h.buckets != tuple(float(b) for b in buckets)
                  or h.unit != unit):
                # same contract as _check_free: a shape clash is a bug —
                # silently returning the existing histogram would file
                # (say) seconds observations into millisecond buckets
                raise ValueError(
                    f"histogram {name!r} already registered with "
                    f"buckets={h.buckets} unit={h.unit!r}; got "
                    f"buckets={tuple(buckets)} unit={unit!r}")
            return h

    def _check_free(self, name: str, own: Dict) -> None:
        for d in (self._counters, self._gauges, self._hists):
            if d is not own and name in d:
                raise ValueError(
                    f"metric {name!r} already registered as a different "
                    f"type")

    # -- timers (sugar over seconds histograms) ---------------------------

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        h = self.histogram(name, TIME_BUCKETS_S, unit="s")
        t0 = time.monotonic()
        try:
            yield
        finally:
            h.observe(time.monotonic() - t0)

    # -- snapshots ---------------------------------------------------------

    def snapshot(self, compact: bool = False) -> Dict:
        """Plain-dict view.  ``compact`` drops zero counters/empty
        histograms — the shape soak/bench records embed."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        out: Dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, c in sorted(counters.items()):
            if compact and c.value == 0:
                continue
            out["counters"][name] = c.value
        for name, g in sorted(gauges.items()):
            if compact and not g.touched:
                continue
            out["gauges"][name] = g.value
        for name, h in sorted(hists.items()):
            if compact and h.count == 0:
                continue
            out["histograms"][name] = {
                "unit": h.unit,
                "count": h.count,
                "sum": round(h.sum, 6),
                "buckets": [[le if le != float("inf") else "+Inf", n]
                            for le, n in h.cumulative()],
            }
        return out

    def to_json(self, compact: bool = False) -> str:
        return json.dumps(self.snapshot(compact=compact))

    def dump_json(self, path: str, compact: bool = False) -> None:
        """Atomic snapshot file (the --metrics-json artifact)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(self.to_json(compact=compact))
        os.replace(tmp, path)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        lines: List[str] = []
        for name, c in sorted(counters.items()):
            p = _prom_name(name)
            lines += [f"# TYPE {p} counter", f"{p} {c.value}"]
        for name, g in sorted(gauges.items()):
            p = _prom_name(name)
            lines += [f"# TYPE {p} gauge", f"{p} {g.value}"]
        for name, h in sorted(hists.items()):
            p = _prom_name(name)
            lines.append(f"# TYPE {p} histogram")
            for le, n in h.cumulative():
                le_s = "+Inf" if le == float("inf") else repr(le)
                lines.append(f'{p}_bucket{{le="{le_s}"}} {n}')
            lines.append(f"{p}_sum {h.sum}")
            lines.append(f"{p}_count {h.count}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every instrument IN PLACE.  Deliberately not a dict
        clear: instrumented modules may cache instrument objects at
        import, and clearing would orphan
        those — they would keep counting into objects no snapshot ever
        reads while fresh lookups returned different zeros."""
        with self._lock:
            for c in self._counters.values():
                c.reset()
            for g in self._gauges.values():
                g.reset()
            for h in self._hists.values():
                h.reset()


# The process-wide registry.
METRICS = MetricsRegistry()


class Stats:
    """Named counters and phase timers with a shutdown report — the
    legacy surface (utils/Stats.scala:7-98 + the --stat shutdown-hook
    report, utils/Options.scala:16-25), now a facade over a
    MetricsRegistry so counters/timers live in the one unified store.

    A fresh ``Stats()`` owns a private registry (test isolation); the
    module singleton ``stats`` shares the process-wide ``METRICS``, so
    --stat reports and --metrics-json snapshots read the same numbers."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.enabled = False

    def counter(self, name: str, delta: int = 1) -> None:
        if not self.enabled:
            return
        self.registry.counter(name).inc(delta)

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        with self.registry.timer(name):
            yield

    def report(self) -> str:
        """The reference's report format: counters then timers, sorted.
        Timers are every seconds-unit histogram in the registry — the
        unified surface means registry timers recorded elsewhere (engine
        compile/run, checkpoint save) appear here too.  Compact snapshot:
        zeroed/never-touched instruments stay out of the report, which is
        both the reference's behavior and what makes reset() (zero in
        place, see MetricsRegistry.reset) read as a clean slate."""
        snap = self.registry.snapshot(compact=True)
        lines = ["# stats"]
        for name, v in snap["counters"].items():
            lines.append(f"counter {name}: {v}")
        for name, h in snap["histograms"].items():
            if h["unit"] != "s":
                continue
            calls, total = h["count"], h["sum"]
            lines.append(
                f"timer {name}: {total:.3f}s over {calls} calls "
                f"({1000 * total / max(calls, 1):.2f} ms/call)"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.registry.reset()

    def enable(self, report_at_exit: bool = True) -> None:
        """--stat: start collecting; print the report at interpreter exit
        (the reference's shutdown hook, utils/Options.scala:16-25)."""
        self.enabled = True
        if report_at_exit and not getattr(self, "_hooked", False):
            atexit.register(lambda: print(self.report()))
            self._hooked = True


# module-level singleton, like the reference's Stats object — backed by
# the process-wide registry (the "exactly one counters/timers surface")
stats = Stats(registry=METRICS)
