"""Progress policies: how a round decides it can move on.

A plain copy of round_tpu/core/progress.py (the port imports nothing of the
JAX package, so it keeps its own copy of this framework-neutral module).

In the reference runtime a Progress value tells the InstanceHandler whether to
wait on its inbox, for how long, and whether catch-up (jumping ahead when f+1
processes are at a higher round) is allowed (psync Progress.scala:4-21).  In
the batched TPU simulator rounds are lockstep, so Progress does not gate a
blocking receive loop; instead it parameterizes the *HO mask family* a round is
executed against (a timeout round may miss messages; a strict-wait round hears
everything; sync(k) imposes a quantile constraint).  We keep the full value
semantics — including the lattice — for API parity and for the host-side
event-round engine.

Encoding: a single int64.  Top 3 bits = header (2 bits kind, 1 bit strict),
low 61 bits = signed payload (timeout millis, or k for sync).
"""

from __future__ import annotations

import dataclasses

_NMASK = 3
_SHIFT = 64 - _NMASK
_VALUE_MASK = (1 << _SHIFT) - 1
_U64 = (1 << 64) - 1

_TIMEOUT = 0
_TIMEOUT_STRICT = 1
_WAIT = 2
_WAIT_STRICT = 3
_GO_AHEAD = 4
_SYNC = 5
_UNCHANGED = 6


def _pack(header: int, payload: int = 0) -> int:
    v = ((header << _SHIFT) | (payload & _VALUE_MASK)) & _U64
    # wrap to signed two's complement so the value is a real int64 (usable in
    # device arrays; matches the reference's JVM Long representation)
    return v - (1 << 64) if v >= (1 << 63) else v


def _header(v: int) -> int:
    return ((v & _U64) >> _SHIFT) & 0b111


def _payload(v: int) -> int:
    p = v & _VALUE_MASK  # & on the two's-complement int recovers the low bits
    # sign-extend the 61-bit payload
    if p >= (1 << (_SHIFT - 1)):
        p -= 1 << _SHIFT
    return p


@dataclasses.dataclass(frozen=True)
class Progress:
    """Immutable progress policy, packed into one int64-compatible value."""

    value: int

    # -- constructors ------------------------------------------------------

    @staticmethod
    def timeout(millis: int) -> "Progress":
        return Progress(_pack(_TIMEOUT, millis))

    @staticmethod
    def strict_timeout(millis: int) -> "Progress":
        return Progress(_pack(_TIMEOUT_STRICT, millis))

    @staticmethod
    def sync(k: int) -> "Progress":
        """Wait until k correct processes reached this round (byzantine sync)."""
        return Progress(_pack(_SYNC, k))

    # -- predicates --------------------------------------------------------

    @property
    def is_timeout(self) -> bool:
        return _header(self.value) in (_TIMEOUT, _TIMEOUT_STRICT)

    @property
    def is_wait_message(self) -> bool:
        return _header(self.value) in (_WAIT, _WAIT_STRICT)

    @property
    def is_go_ahead(self) -> bool:
        return _header(self.value) == _GO_AHEAD

    @property
    def is_unchanged(self) -> bool:
        return _header(self.value) == _UNCHANGED

    @property
    def is_sync(self) -> bool:
        return _header(self.value) == _SYNC

    @property
    def is_strict(self) -> bool:
        # strict bit is the low bit of the header for timeout/wait kinds;
        # sync is always strict by definition.
        h = _header(self.value)
        return h in (_TIMEOUT_STRICT, _WAIT_STRICT, _SYNC)

    @property
    def timeout_millis(self) -> int:
        return _payload(self.value)

    @property
    def k(self) -> int:
        return _payload(self.value)

    # -- lattice -----------------------------------------------------------

    def or_else(self, other: "Progress") -> "Progress":
        """Left-biased choice: self unless self is Unchanged."""
        return self if not self.is_unchanged else other

    def lub(self, other: "Progress") -> "Progress":
        """Least upper bound: the *more patient* policy (max timeout; wait
        dominates timeout; sync dominates everything; goAhead is bottom)."""
        p1, p2 = self, other
        assert not p1.is_unchanged and not p2.is_unchanged
        strict = p1.is_strict or p2.is_strict
        if p1.is_sync and p2.is_sync:
            return Progress.sync(max(p1.k, p2.k))
        if p1.is_sync or p2.is_sync:
            return p1 if p1.is_sync else p2
        if p1.is_wait_message or p2.is_wait_message:
            return Progress.STRICT_WAIT_MESSAGE if strict else Progress.WAIT_MESSAGE
        if p1.is_go_ahead:
            return p2
        if p2.is_go_ahead:
            return p1
        to = max(p1.timeout_millis, p2.timeout_millis)
        return Progress.strict_timeout(to) if strict else Progress.timeout(to)

    def glb(self, other: "Progress") -> "Progress":
        """Greatest lower bound: the *more eager* policy (min timeout; goAhead
        dominates; timeout beats wait beats sync)."""
        p1, p2 = self, other
        assert not p1.is_unchanged and not p2.is_unchanged
        strict = p1.is_strict and p2.is_strict
        if p1.is_go_ahead or p2.is_go_ahead:
            return Progress.GO_AHEAD
        if p1.is_timeout and p2.is_timeout:
            to = min(p1.timeout_millis, p2.timeout_millis)
            return Progress.strict_timeout(to) if strict else Progress.timeout(to)
        if p1.is_timeout or p2.is_timeout:
            t = p1 if p1.is_timeout else p2
            to = t.timeout_millis
            return Progress.strict_timeout(to) if strict else Progress.timeout(to)
        if p1.is_wait_message and p2.is_wait_message:
            return Progress.STRICT_WAIT_MESSAGE if strict else Progress.WAIT_MESSAGE
        if p1.is_wait_message or p2.is_wait_message:
            return p1 if p1.is_wait_message else p2
        if p1.is_sync and p2.is_sync:
            return Progress.sync(min(p1.k, p2.k))
        return p1 if p1.is_sync else p2

    def __repr__(self) -> str:
        if self.is_wait_message:
            return "StrictWaitForMessage" if self.is_strict else "WaitForMessage"
        if self.is_timeout:
            kind = "StrictTimeout" if self.is_strict else "Timeout"
            return f"{kind}({self.timeout_millis})"
        if self.is_go_ahead:
            return "GoAhead"
        if self.is_unchanged:
            return "Unchanged"
        if self.is_sync:
            return f"Sync({self.k})"
        return f"Progress(invalid: {self.value})"


Progress.WAIT_MESSAGE = Progress(_pack(_WAIT))
Progress.STRICT_WAIT_MESSAGE = Progress(_pack(_WAIT_STRICT))
Progress.GO_AHEAD = Progress(_pack(_GO_AHEAD))
Progress.UNCHANGED = Progress(_pack(_UNCHANGED))


def timeout_in_bounds(millis: int) -> bool:
    """True iff the timeout survives the 61-bit payload round-trip."""
    return _payload(_pack(_TIMEOUT, millis)) == millis
