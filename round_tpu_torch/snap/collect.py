"""Cut assembly: round-aligning per-replica samples into global states.

Port of round_tpu/snap/collect.py: cut assembly, the divergence checks
and the ``.snapcut`` bank are round_tpu's; a banked cut (the codec
encoding, kind ``round_tpu.snap.cut``) loads in either package.

A CUT is the global state of one consensus instance at one round
boundary of one view epoch: the n replicas' sampled state rows stacked
into ``[n, ...]`` leaves.  Round-consistency is free (snap/sample.py
module docstring); what this module adds is the bookkeeping that keeps
it sound on a real wire:

  * ROUND ALIGNMENT — samples join a cut only on an exact
    ``(epoch, instance, round)`` match.  There is no "close enough":
    a sample from round r+1 is a different global state.
  * EPOCH FENCING — the collector tracks the CURRENT view epoch (wired
    to ``ViewManager.add_observer``): samples stamped another epoch are
    refused (``snap.stale_epoch``) and every pending partial cut is
    flushed on a membership change (``snap.epoch_flushes``) — renames
    and resizes must never mis-join rows from two different groups.
  * MISSING-CONTRIBUTOR TOLERANCE — a cut whose deadline passes with at
    least ``n - f`` contributors (f from the protocol's declared fault
    envelope, the rv/license.py parser) is kept as a PARTIAL cut: its
    digests are banked and its divergence checks run, but the
    full-state formula audit is SKIPPED (``snap.partial_unaudited``) —
    a quantified threshold formula over n processes is not evaluable
    from n-1 rows, and a weaker substitute would false-positive or
    false-negative.  Below n - f the cut is dropped
    (``snap.incomplete_cuts``).
  * DIVERGENCE FORENSICS — every sample's digest is re-verified against
    its decoded state (in-flight corruption) and against any duplicate
    claim for the same (epoch, inst, round, node) coordinate
    (equivocation: one node, two states, one round).  Assembled cuts
    bank their digest vector, and a bounded per-instance digest history
    feeds the violation artifacts — the round a replica's state started
    diverging is in the dump, before the decision plane ever disagrees.

Cuts can also be BANKED to disk (``bank_dir``) as codec-encoded
``.snapcut`` files for offline audit (apps/snap_cli.py).
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime import codec
from round_tpu_torch.runtime.log import get_logger
from round_tpu_torch.snap.sample import blob_digest, decode_sample

log = get_logger("snap")

_C_CUTS = METRICS.counter("snap.cuts")
_C_PARTIAL = METRICS.counter("snap.partial_cuts")
_C_PARTIAL_UNAUDITED = METRICS.counter("snap.partial_unaudited")
_C_INCOMPLETE = METRICS.counter("snap.incomplete_cuts")
_C_STALE_EPOCH = METRICS.counter("snap.stale_epoch")
_C_EPOCH_FLUSH = METRICS.counter("snap.epoch_flushes")
_C_DIVERGENCE = METRICS.counter("snap.divergences")
_C_BANKED = METRICS.counter("snap.cuts_banked")

# bounded per-(inst) digest-history depth for forensics: enough rounds
# to see where a divergence started, small enough to never matter
_HISTORY_ROUNDS = 32
# and bounded ACROSS instances (oldest-first): a serve shard processes
# an unbounded instance stream — per-instance forensics state must not
# accumulate for the lifetime of the collector
_HISTORY_INSTANCES = 256
# pending part-cut cap: a hostile peer spraying novel (inst, round)
# coordinates must exhaust a counter, not the collector's memory
_PENDING_CAP = 4096


@dataclasses.dataclass
class Cut:
    """One assembled global state: ``state`` leaves are [n, ...] stacked
    in pid order; ``present`` marks contributors (a partial cut's absent
    rows are zero-filled and MUST NOT be audited); ``digests`` is the
    per-replica digest vector (None where absent)."""

    epoch: int
    inst: int
    round: int
    n: int
    state: List[np.ndarray]
    present: np.ndarray               # [n] bool
    digests: List[Optional[bytes]]
    values: np.ndarray                # [n] int64 proposal row
    wall: float

    @property
    def full(self) -> bool:
        return bool(self.present.all())

    @property
    def missing(self) -> int:
        return int(self.n - self.present.sum())


class SnapCollector:
    """Assemble samples into cuts; the audit side drains ``take()``.

    ``envelope_f`` is the missing-contributor tolerance (derive it from
    the protocol's fault envelope via ``envelope_f_max``); ``epoch`` is
    the CURRENT view epoch, advanced by ``on_view_change`` (registered
    on ViewManager.add_observer by the drivers)."""

    def __init__(self, n: int, *, envelope_f: int = 0,
                 deadline_ms: int = 3000, epoch: int = 0,
                 bank_dir: Optional[str] = None,
                 protocol: Optional[str] = None):
        self.n = n
        self.envelope_f = envelope_f
        self.deadline_ms = deadline_ms
        self.epoch = epoch
        self.bank_dir = bank_dir
        self.protocol = protocol
        # (inst, round) -> {node: (leaves, digest, values)} + first-seen
        self._pending: Dict[Tuple[int, int], Dict[int, Any]] = {}
        self._first_seen: Dict[Tuple[int, int], float] = {}
        self._ready: List[Cut] = []
        # divergence forensics: inst -> {round: {node: digest}}, bounded
        self._history: Dict[int, Dict[int, Dict[int, bytes]]] = {}
        self.divergences: List[Dict[str, Any]] = []
        self.cuts = 0
        self.partial = 0

    # -- ingest ------------------------------------------------------------

    def on_frame(self, sender: int, tag, raw) -> bool:
        """One FLAG_SNAP wire frame: decode, verify, join.  Returns True
        when the sample joined a cut slot."""
        s = decode_sample(raw)
        if s is None:
            return False
        if s["node"] != sender:
            # a sample must speak for its own sender — a forged node id
            # would let one peer fabricate another's state row
            _C_DIVERGENCE.inc()
            self._note_divergence(tag.instance, tag.round, sender,
                                  "sender-mismatch",
                                  claimed=s["node"])
            return False
        # in-flight integrity: the digest was computed over the blob
        # bytes at the emitter; re-digest the blob that ACTUALLY arrived
        # (no re-encode — the check covers exactly the wire bytes)
        got = blob_digest(s["blob"])
        if got != s["digest"]:
            _C_DIVERGENCE.inc()
            self._note_divergence(tag.instance, tag.round, sender,
                                  "digest-mismatch")
            return False
        return self.add_sample(sender, tag.instance, tag.round,
                               tag.call_stack & 0xFF, s["state"],
                               s["values"], s["digest"])

    def add_sample(self, node: int, inst: int, r: int, epoch_byte: int,
                   leaves: List[np.ndarray], values: np.ndarray,
                   digest: bytes, local: bool = False) -> bool:
        """Join one verified sample.  ``local`` marks the collector
        replica's own contribution (already canonical — no re-verify)."""
        if epoch_byte != (self.epoch & 0xFF):
            # cross-epoch fencing: this sample belongs to another group
            _C_STALE_EPOCH.inc()
            return False
        if not 0 <= node < self.n:
            return False
        # duplicate-claim check against the HISTORY, not just the
        # pending slot: a conflicting re-send arriving AFTER the cut
        # assembled (slot popped) is still equivocation — checking only
        # pending state would let it open a fresh part-cut and quietly
        # expire as "incomplete" (forensics keeps the first claim; the
        # conflict is the finding)
        seen = self._history.get(int(inst), {}).get(int(r), {}).get(node)
        if seen is not None:
            if seen != digest:
                _C_DIVERGENCE.inc()
                self._note_divergence(inst, r, node, "equivocation")
            return False
        key = (int(inst), int(r))
        slot = self._pending.get(key)
        if slot is None:
            if len(self._pending) >= _PENDING_CAP:
                self._expire_oldest()
            slot = self._pending[key] = {}
            self._first_seen[key] = _time.monotonic()
        slot[node] = (leaves, digest, np.asarray(values, dtype=np.int64))
        self._bank_history(int(inst), int(r), node, digest)
        if TRACE.enabled:
            TRACE.emit("snap_sample", node=node, inst=int(inst),
                       round=int(r), epoch=self.epoch, local=local)
        if len(slot) == self.n:
            self._assemble(key, partial=False)
        return True

    # -- lifecycle ---------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> None:
        """Expire pending part-cuts past the deadline: enough
        contributors (>= n - f) becomes a PARTIAL cut, fewer is dropped."""
        now = _time.monotonic() if now is None else now
        expired = [k for k, t0 in self._first_seen.items()
                   if (now - t0) * 1000.0 >= self.deadline_ms]
        for key in expired:
            self._expire(key)

    def on_view_change(self, renames: Dict[int, Optional[int]], n: int,
                       *, epoch: Optional[int] = None,
                       envelope_f: Optional[int] = None) -> None:
        """ViewManager observer: a membership change fences the epoch —
        every pending part-cut is flushed (its group no longer exists as
        sampled) and the expected contributor count re-derives.

        ``epoch`` is the MANAGER'S epoch after the move (SnapDriver
        passes it): an adopt_wire catch-up can jump the view by more
        than one epoch in a single notification, so a bare increment
        would permanently desync this fence from the emitters' stamps
        and refuse every sample thereafter.  Without a manager
        (driver-less callers) the increment is exact — one call, one
        move.  ``envelope_f`` re-derives the missing-contributor
        tolerance at the new n (SnapDriver recomputes it from the
        protocol's declared envelope)."""
        flushed = len(self._pending)
        if flushed:
            _C_EPOCH_FLUSH.inc(flushed)
            log.info("snap: view change flushed %d pending part-cut(s)",
                     flushed)
        self._pending.clear()
        self._first_seen.clear()
        self._history.clear()
        self.n = n
        if envelope_f is not None:
            self.envelope_f = envelope_f
        self.epoch = self.epoch + 1 if epoch is None else int(epoch)

    def take(self) -> List[Cut]:
        """Drain assembled cuts (the auditor's intake)."""
        out, self._ready = self._ready, []
        return out

    def pending_count(self) -> int:
        return len(self._pending)

    # -- internals ---------------------------------------------------------

    def _bank_history(self, inst: int, r: int, node: int,
                      digest: bytes) -> None:
        hist = self._history.setdefault(inst, {})
        # first claim wins, forever: a later overwrite would let an
        # equivocator scrub its honest digest out of the forensics
        # trajectory after the cut assembled
        hist.setdefault(r, {}).setdefault(node, digest)
        while len(hist) > _HISTORY_ROUNDS:
            del hist[min(hist)]
        while len(self._history) > _HISTORY_INSTANCES:
            # oldest-first across instances (dict insertion order) —
            # bounded forensics on an unbounded serve stream
            del self._history[next(iter(self._history))]

    def digest_history(self, inst: int) -> List[Dict[str, Any]]:
        """The bounded digest trajectory of one instance — the forensics
        block violation artifacts carry: per sampled round, each
        contributor's digest hex."""
        hist = self._history.get(int(inst), {})
        return [{"round": r,
                 "digests": {str(n): d.hex()
                             for n, d in sorted(hist[r].items())}}
                for r in sorted(hist)]

    def _note_divergence(self, inst, r, node, kind, **extra) -> None:
        rec = {"inst": int(inst), "round": int(r), "node": int(node),
               "kind": kind, **extra}
        self.divergences.append(rec)
        if TRACE.enabled:
            TRACE.emit("snap_divergence", node=int(node), inst=int(inst),
                       round=int(r), kind=kind)
        log.warning("snap: DIVERGENCE %s at inst=%s round=%s node=%s",
                    kind, inst, r, node)

    def _expire_oldest(self) -> None:
        key = min(self._first_seen, key=self._first_seen.get)
        self._expire(key)

    def _expire(self, key) -> None:
        slot = self._pending.get(key)
        if slot is None:
            return
        if len(slot) >= self.n - self.envelope_f and len(slot) > 0:
            self._assemble(key, partial=True)
        else:
            del self._pending[key]
            del self._first_seen[key]
            _C_INCOMPLETE.inc()
            log.debug("snap: dropped incomplete cut %s (%d/%d rows)",
                      key, len(slot), self.n)

    def _assemble(self, key, partial: bool) -> None:
        inst, r = key
        slot = self._pending.pop(key)
        self._first_seen.pop(key, None)
        # the proposal row is deterministic cluster-wide (the schedule /
        # the uniform client value), so contributors must agree on it —
        # but the BASELINE must be the majority row, never whichever
        # sample arrived first: a liar controls its own send timing, so
        # first-wins would let it win the race and have every honest
        # contributor recorded as the "mismatching" node
        by_row: Dict[bytes, List[int]] = {}
        for node, (_leaves, _digest, vals) in slot.items():
            by_row.setdefault(
                np.asarray(vals, dtype=np.int64).tobytes(), []
            ).append(node)
        majority = max(by_row.values(), key=len)
        if 2 * len(majority) <= len(slot):
            # no strict majority: attribution is impossible — drop the
            # cut as one unattributed divergence, never audit it
            _C_DIVERGENCE.inc()
            self._note_divergence(inst, r, -1, "values-split",
                                  rows=len(by_row))
            _C_INCOMPLETE.inc()
            return
        values = slot[majority[0]][2]
        some_node = majority[0]
        like = slot[some_node][0]
        present = np.zeros((self.n,), dtype=bool)
        digests: List[Optional[bytes]] = [None] * self.n
        state = [np.zeros((self.n,) + x.shape, dtype=x.dtype)
                 for x in like]
        ok = True
        for node, (leaves, digest, vals) in slot.items():
            if len(leaves) != len(like) or any(
                    a.shape != b.shape or a.dtype != b.dtype
                    for a, b in zip(leaves, like)):
                # a structurally alien row cannot stack — count it as a
                # divergence (same coordinate, incompatible state) and
                # drop the whole cut rather than audit garbage
                _C_DIVERGENCE.inc()
                self._note_divergence(inst, r, node, "shape-mismatch")
                ok = False
                break
            present[node] = True
            digests[node] = digest
            for dst, src in zip(state, leaves):
                dst[node] = src
            if not np.array_equal(vals, values):
                _C_DIVERGENCE.inc()
                self._note_divergence(inst, r, node, "values-mismatch")
                ok = False
                break
        if not ok:
            _C_INCOMPLETE.inc()
            return
        cut = Cut(epoch=self.epoch, inst=int(inst), round=int(r),
                  n=self.n, state=state, present=present,
                  digests=digests, values=values,
                  wall=_time.time())
        self.cuts += 1
        _C_CUTS.inc()
        if partial:
            self.partial += 1
            _C_PARTIAL.inc()
        if TRACE.enabled:
            TRACE.emit("snap_cut", node=-1, inst=int(inst),
                       round=int(r), epoch=self.epoch,
                       missing=cut.missing, partial=partial)
        if self.bank_dir is not None:
            try:
                bank_cut(self.bank_dir, cut, protocol=self.protocol)
                _C_BANKED.inc()
            except Exception as e:  # noqa: BLE001 — banking is forensics,
                log.warning("snap: cut bank failed: %s", e)  # not serving
        self._ready.append(cut)


# ---------------------------------------------------------------------------
# banked cut files (apps/snap_cli.py offline audit)
# ---------------------------------------------------------------------------


def bank_cut(bank_dir: str, cut: Cut, protocol: Optional[str] = None
             ) -> str:
    """Write one cut as a ``.snapcut`` file — the codec encoding itself
    (dogfooding the wire format: the offline reader IS codec.decode),
    write-then-rename like every artifact in this tree."""
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(
        bank_dir, f"cut-e{cut.epoch}-i{cut.inst}-r{cut.round}.snapcut")
    doc = codec.encode({
        "kind": "round_tpu.snap.cut",
        "protocol": protocol or "",
        "epoch": cut.epoch, "inst": cut.inst, "round": cut.round,
        "n": cut.n,
        "present": np.asarray(cut.present),
        "digests": [d if d is not None else b"" for d in cut.digests],
        "values": cut.values,
        "state": cut.state,
        "wall": float(cut.wall),
    })
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(doc)
    os.replace(tmp, path)
    return path


def load_cut(path: str) -> Tuple[Cut, str]:
    """Read one banked ``.snapcut`` back; returns (cut, protocol)."""
    with open(path, "rb") as fh:
        doc = codec.decode(fh.read())
    if doc.get("kind") != "round_tpu.snap.cut":
        raise ValueError(f"{path}: not a snapcut file")
    cut = Cut(
        epoch=int(doc["epoch"]), inst=int(doc["inst"]),
        round=int(doc["round"]), n=int(doc["n"]),
        state=[np.array(x) for x in doc["state"]],
        present=np.array(doc["present"], dtype=bool),
        digests=[bytes(d) if len(d) else None for d in doc["digests"]],
        values=np.array(doc["values"], dtype=np.int64),
        wall=float(doc["wall"]),
    )
    if cut.present.shape != (cut.n,) or len(cut.digests) != cut.n:
        raise ValueError(f"{path}: inconsistent cut geometry")
    return cut, str(doc.get("protocol", ""))


def envelope_f_max(algo, n: int) -> int:
    """The missing-contributor tolerance from the protocol's DECLARED
    fault envelope (core/algorithm.py fault_envelope, parsed by the
    rv/license.py grammar): f_max = (n-1)//K for ``n > K·f``.  No
    declared envelope = zero tolerance (refuse to guess)."""
    env = getattr(algo, "fault_envelope", None)
    if not env:
        return 0
    try:
        from round_tpu_torch.rv.license import parse_envelope

        return max(0, (n - 1) // parse_envelope(env))
    except ValueError:
        return 0
