"""Decision log: per-instance decisions with TSV dump and replay.

Port of round_tpu/runtime/decisions.py, unchanged (pure Python): the same
decisions give byte-equal ``values_tsv`` and the same ``digest`` in both
packages.

Reference parity: the PerfTest harness's per-decision TSV logs
(example/PerfTest.scala:69-80: "instance\tround\tvalue" lines per replica)
and the batching example's DecisionLog + recovery replay
(example/batching/).  Differential testing against the reference uses the
same column layout.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


class DecisionLog:
    """Ordered per-instance decision records."""

    def __init__(self):
        self._lock = threading.Lock()
        # instance -> (round, value)
        self._log: Dict[int, Tuple[int, int]] = {}

    def record(self, instance: int, round_: int, value: int) -> bool:
        """Record a decision; returns False if the instance already decided
        differently (an agreement violation — callers assert on it)."""
        with self._lock:
            prev = self._log.get(instance)
            if prev is not None:
                return prev[1] == value
            self._log[instance] = (int(round_), int(value))
            return True

    def get(self, instance: int) -> Optional[Tuple[int, int]]:
        with self._lock:
            return self._log.get(instance)

    def __len__(self) -> int:
        return len(self._log)

    def instances(self) -> List[int]:
        with self._lock:
            return sorted(self._log)

    def missing(self, upto: int) -> List[int]:
        """Gaps below `upto` — what a recovering replica must fetch
        (example/batching/Recovery.scala semantics)."""
        with self._lock:
            return [i for i in range(upto) if i not in self._log]

    # -- TSV (PerfTest.scala log format) ------------------------------------

    def dump_tsv(self, path: str) -> None:
        with self._lock, open(path, "w") as fh:
            for inst in sorted(self._log):
                rnd, val = self._log[inst]
                fh.write(f"{inst}\t{rnd}\t{val}\n")

    @classmethod
    def load_tsv(cls, path: str) -> "DecisionLog":
        log = cls()
        with open(path) as fh:
            for line in fh:
                parts = line.strip().split("\t")
                if len(parts) == 3:
                    log.record(int(parts[0]), int(parts[1]), int(parts[2]))
        return log

    def replay(self, apply_fn, state):
        """Fold decisions in instance order into a state machine."""
        for inst in self.instances():
            _rnd, val = self._log[inst]
            state = apply_fn(state, inst, val)
        return state

    # -- canonical value log (chaos-diff artifact) --------------------------

    @classmethod
    def from_values(cls, values: Sequence[Optional[int]],
                    start: int = 1) -> "DecisionLog":
        """Log from an ordered per-instance decision list (the host
        loops' return shape, runtime/host.py): instance ids start at
        `start`, None entries (undecided) are simply absent — a diff of
        two value logs then catches a missing decision as a byte
        mismatch, not a silent gap."""
        log = cls()
        for k, v in enumerate(values):
            if v is not None:
                log.record(start + k, 0, int(v))
        return log

    def values_tsv(self) -> bytes:
        """The canonical ``instance\\tvalue`` byte form, WITHOUT the round
        column: the round an instance decided in is schedule-dependent
        (timeouts, catch-up), the value is not — so this is the artifact
        two runs of one workload must match byte-for-byte (the chaos
        harness's agreement check, tools/soak.py host-chaos slot)."""
        with self._lock:
            return "".join(
                f"{inst}\t{self._log[inst][1]}\n" for inst in sorted(self._log)
            ).encode()

    def dump_values_tsv(self, path: str) -> None:
        """Atomically write values_tsv (write-then-rename, the checkpoint
        durability discipline — a crash mid-dump must not leave a torn
        log that diffs clean against nothing)."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(self.values_tsv())
        os.replace(tmp, path)

    def digest(self) -> str:
        """sha256 of the canonical value log — the log-hash a recovered
        replica must reproduce bit-for-bit against a never-crashed run."""
        return hashlib.sha256(self.values_tsv()).hexdigest()
