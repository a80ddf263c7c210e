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

Spans time a step of the program on the same ring:

    with TRACE.span("round.update", round=r) if TRACE.enabled else NOSPAN:
        ...

records, when the step ends, one event

    {"t": <start, unix seconds>, "ev": "span", "name": ..., "t0_ns": ...,
     "t1_ns": ..., "id": <int>, "parent": <id or None>, ...fields}

``t0_ns``/``t1_ns`` are ``time.time_ns()``, the realtime clock that
torch.profiler's host events use, so spans and a device trace share one
timeline.  ``parent`` is the innermost span open on the same thread when
this one opened (None for a root), so every span of one engine call hangs
off that call's span.  A disabled site enters ``NOSPAN``, one reusable
null context: no span object, no fields dict, no clock read.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, ContextManager, Dict, Iterable, List, Optional

SCHEMA_VERSION = 1


class Tracer:
    """Bounded structured-event recorder.

    Thread-safe by construction: the ring is a ``deque(maxlen=capacity)``
    and CPython's deque.append is atomic, so emitters on the InstanceMux
    router thread, replica worker threads and the main loop share one
    tracer without a lock on the hot path."""

    __slots__ = ("enabled", "node", "capacity", "dropped", "_buf", "_local")

    def __init__(self, capacity: int = 65536, node: Optional[int] = None,
                 enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.node = node
        self.capacity = capacity
        #: events the ring overwrote since the last clear(): a reader that
        #: needs the whole trace refuses one where this is above 0 (exact
        #: with one emitting thread, as on the engine path; emitters on
        #: several threads can lose an increment to each other)
        self.dropped = 0
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._local = threading.local()  # .stack: this thread's open spans

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
            self.dropped += max(0, len(self._buf) - capacity)
            self._buf = collections.deque(self._buf, maxlen=capacity)
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

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
        self._append(rec)

    def span(self, name: str, **fields: Any) -> ContextManager:
        """A context manager that records one ``span`` event when it exits
        (see the module docstring).  Call sites guard with
        ``if TRACE.enabled else NOSPAN``; an unguarded call on a disabled
        tracer returns NOSPAN."""
        if not self.enabled:
            return NOSPAN
        return _Span(self, name, fields)

    def _append(self, rec: Dict[str, Any]) -> None:
        if len(self._buf) == self.capacity:
            self.dropped += 1
        self._buf.append(rec)

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

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


_SPAN_IDS = itertools.count(1)


class _Span:
    """One open span of a Tracer (Tracer.span)."""

    __slots__ = ("tracer", "name", "fields", "id", "parent", "t0_ns")

    def __init__(self, tracer: Tracer, name: str, fields: Dict[str, Any]):
        self.tracer = tracer
        self.name = name
        self.fields = fields

    def __enter__(self) -> "_Span":
        stack = self.tracer._stack()
        self.id = next(_SPAN_IDS)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1_ns = time.time_ns()
        self.tracer._stack().pop()
        rec: Dict[str, Any] = {
            "t": self.t0_ns / 1e9, "ev": "span", "name": self.name,
            "t0_ns": self.t0_ns, "t1_ns": t1_ns, "id": self.id,
            "parent": self.parent}
        if self.tracer.node is not None and "node" not in self.fields:
            rec["node"] = self.tracer.node
        rec.update(self.fields)
        self.tracer._append(rec)
        return False


#: the null context a disabled span site enters: reusable, and entering it
#: allocates nothing
NOSPAN = contextlib.nullcontext()


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
