"""Structured round-level event tracing: ring buffer + JSONL export.

Port of round_tpu/obs/trace.py, unchanged in behaviour.  Emitters record
TYPED events (round start/end, the senders heard, send/recv, timeout
fired, decision, ...) into a fixed-capacity ring buffer (a bounded deque:
old events age out instead of growing the process).

Zero-cost-when-disabled contract: every instrumentation site guards with

    if TRACE.enabled:
        TRACE.emit("round_end", inst=i, round=r, heard=k)

so a disabled tracer costs ONE attribute load per site — no kwargs dict,
no event object, no lock.  ``emit`` itself also early-returns on
``enabled`` so an unguarded call site is merely slower, never wrong.

Event record shape (one JSON object per line in the export):

    {"t": <unix seconds>, "ev": "<type>", "node": <replica id>, ...}

``t`` is wall-clock (time.time) so traces from different OS processes
merge into one timeline without a shared monotonic epoch (``merge``).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional

SCHEMA_VERSION = 1


class Tracer:
    """Bounded structured-event recorder.

    Thread-safe by construction: the ring is a ``deque(maxlen=capacity)``
    and CPython's deque.append is atomic, so emitters on the InstanceMux
    router thread, replica worker threads and the main loop share one
    tracer without a lock on the hot path."""

    __slots__ = ("enabled", "node", "capacity", "_buf")

    def __init__(self, capacity: int = 65536, node: Optional[int] = None,
                 enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.node = node
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)

    # -- control -----------------------------------------------------------

    def enable(self, node: Optional[int] = None,
               capacity: Optional[int] = None) -> "Tracer":
        """Start recording.  ``node`` stamps a default replica id onto
        events that do not carry their own; ``capacity`` resizes the ring
        (dropping nothing already recorded unless it shrinks)."""
        if node is not None:
            self.node = node
        if capacity is not None and capacity != self.capacity:
            if capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
            self.capacity = capacity
            self._buf = collections.deque(self._buf, maxlen=capacity)
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._buf.clear()

    # -- recording ---------------------------------------------------------

    def emit(self, ev: str, **fields: Any) -> None:
        """Record one event.  Call sites on hot paths must guard with
        ``if TRACE.enabled:`` (see module docstring); the early return
        here only protects unguarded cold-path callers."""
        if not self.enabled:
            return
        rec: Dict[str, Any] = {"t": time.time(), "ev": ev}
        if self.node is not None and "node" not in fields:
            rec["node"] = self.node
        rec.update(fields)
        self._buf.append(rec)

    # -- reading / export --------------------------------------------------

    def __len__(self) -> int:
        return len(self._buf)

    def events(self) -> List[Dict[str, Any]]:
        """The recorded events, oldest first (a copy; emitters may keep
        appending)."""
        return list(self._buf)

    def dump_jsonl(self, path: str) -> int:
        """Write the buffer as JSONL (write-then-rename, the repo's
        durability discipline — a killed process never leaves a torn
        trace that breaks the merge tooling).  Returns the event count."""
        evs = self.events()
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            for rec in evs:
                fh.write(json.dumps(rec, default=_jsonable) + "\n")
        os.replace(tmp, path)
        return len(evs)


def _jsonable(x):
    """numpy scalars and arrays and torch tensors ride into traces;
    coerce rather than crash the dump."""
    if hasattr(x, "item") and getattr(x, "ndim", None) == 0:
        return x.item()
    if hasattr(x, "tolist"):
        return x.tolist()
    return str(x)


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    """Read one trace file back.  Tolerates a trailing half-written line
    (a crashed replica's last event) — every parseable record is kept."""
    out: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn tail
    return out


def merge(traces: Iterable[List[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    """Merge multiple replicas' event lists into one timeline ordered by
    wall-clock ``t`` (ties keep per-replica order — sort is stable)."""
    allev: List[Dict[str, Any]] = []
    for tr in traces:
        allev.extend(tr)
    allev.sort(key=lambda e: e.get("t", 0.0))
    return allev


# The process-wide tracer: instrumented modules import this singleton and
# guard emits on its `enabled` flag; CLIs enable it from --trace.
TRACE = Tracer()
