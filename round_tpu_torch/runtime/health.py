"""Peer health scoring and quarantine: hostile/slow peers out of the
round-progress threshold.

Port of round_tpu/runtime/health.py, unchanged (pure Python over the
port's obs/).

The serving tier's progress discipline waits for ``expected_nbr_messages``
peers per round and burns a full deadline whenever one of them is slow,
dead, or hostile.  Communication closure makes that overload decidable PER
ROUND WAVE: at every round boundary the driver knows exactly which peers
contributed and which did not, so a peer that repeatedly costs deadlines
(or repeatedly ships malformed frames, or churns its connection) can be
scored, QUARANTINED out of the progress threshold, and probed back in —
without ever touching the protocol's own quorum math.

What quarantine changes — and what it must never change:

  * it LOWERS the round-progress threshold (``effective_threshold``): a
    round may end as soon as every *healthy* peer is heard, instead of
    waiting out the deadline for the quarantined one.  Ending a round
    with a partial HO set is something every protocol in this repo
    already tolerates by construction (it is exactly what a timeout
    produces), so agreement/validity are untouched — the quarantined
    peer's frames, when they DO arrive, still land in the mailbox and
    still count;
  * it is NOT a membership change (runtime/view.py): the peer stays in
    the group, keeps receiving our sends, and catches up through the
    existing decision-reply path.  A view change recomputes the world;
    quarantine just stops one replica's slowness from pacing everyone
    else's rounds;
  * it is bounded: at most ``max_quarantined`` peers (default (n-1)//3,
    the classic fault envelope) may be quarantined at once, so a
    partitioned MINORITY can never quarantine the healthy majority into
    deciding alone below quorum.

State machine (per peer):

    healthy --score >= quarantine_after--> quarantined
    quarantined --backoff elapses--> probing   (counted healthy again)
    probing --heard a frame--> healthy         (probe succeeded: score
                                                reset, rejoin; backoff
                                                kept, so a flapping peer
                                                pays escalating re-probe
                                                cost)
    probing --cost another expiry--> quarantined (backoff doubled)
    quarantined --sustained frames decay score below rejoin_below-->
                                     healthy   (liveness evidence beats
                                                the score even before
                                                the probe fires)

Scoring signals (all per completed round wave, so one slow peer under L
lanes accrues evidence L× faster — more rounds, more proof):

  * +1.0  per expired deadline the peer sat out (timeout contribution);
  * +0.5  per structurally-malformed frame from the peer (hostile rate);
  * +0.5  per reconnect-churn event (the auto-reconnect loop re-dialed);
  * ×decay per round the peer WAS heard (good behavior clears history).

Obs vocabulary (docs/OBSERVABILITY.md): ``quarantine.events`` /
``quarantine.probes`` / ``quarantine.rejoins`` counters, the
``quarantine.active`` gauge, and ``quarantine`` / ``quarantine_probe`` /
``quarantine_rejoin`` trace events carrying peer + score + backoff.
"""

from __future__ import annotations

import time as _time
from typing import Dict, FrozenSet, Iterable, List, Optional

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE

_C_EVENTS = METRICS.counter("quarantine.events")
_C_PROBES = METRICS.counter("quarantine.probes")
_C_REJOINS = METRICS.counter("quarantine.rejoins")
_G_ACTIVE = METRICS.gauge("quarantine.active")

_HEALTHY, _QUARANTINED, _PROBING = 0, 1, 2


class PeerHealth:
    """Per-peer health scores + the quarantine state machine (module
    docstring).  One instance per DRIVER (HostRunner loop or LaneDriver);
    share it across consecutive instances like AdaptiveTimeout — the
    peer's health, like the wire, does not reset between instances.

    ``max_quarantined=None`` derives the (n-1)//3 envelope; pass 0 to
    observe scores without ever quarantining (dry-run mode)."""

    def __init__(self, n: int, my_id: int, *,
                 quarantine_after: float = 3.0,
                 rejoin_below: float = 1.0,
                 decay: float = 0.5,
                 malformed_weight: float = 0.5,
                 churn_weight: float = 0.5,
                 probe_backoff_ms: int = 1000,
                 probe_backoff_factor: float = 2.0,
                 probe_backoff_max_ms: int = 60_000,
                 max_quarantined: Optional[int] = None):
        if not 0 <= my_id < n:
            raise ValueError(f"my_id={my_id} outside group n={n}")
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        if rejoin_below > quarantine_after:
            raise ValueError("rejoin_below must be <= quarantine_after "
                             "(hysteresis, not oscillation)")
        self.n = n
        self.id = my_id
        self.quarantine_after = quarantine_after
        self.rejoin_below = rejoin_below
        self.decay = decay
        self.malformed_weight = malformed_weight
        self.churn_weight = churn_weight
        self.probe_backoff_ms = probe_backoff_ms
        self.probe_backoff_factor = probe_backoff_factor
        self.probe_backoff_max_ms = probe_backoff_max_ms
        self._envelope_auto = max_quarantined is None
        self.max_quarantined = ((n - 1) // 3 if max_quarantined is None
                                else max_quarantined)
        self.score: Dict[int, float] = {p: 0.0 for p in range(n)}
        self._state: Dict[int, int] = {p: _HEALTHY for p in range(n)}
        self._backoff: Dict[int, float] = {}    # current backoff (ms)
        self._probe_at: Dict[int, float] = {}   # monotonic deadline
        # cumulative event counts for summaries/tests
        self.quarantines = 0
        self.probes = 0
        self.rejoins = 0

    # -- state queries ------------------------------------------------------

    def is_quarantined(self, peer: int) -> bool:
        return self._state.get(peer) == _QUARANTINED

    def active(self) -> FrozenSet[int]:
        """Peers currently quarantined OUT of the progress threshold
        (probing peers are counted healthy again — the probe IS waiting
        for them one more round)."""
        return frozenset(p for p, s in self._state.items()
                         if s == _QUARANTINED)

    def effective_threshold(self, goal: int) -> int:
        """The round-progress threshold with quarantined peers excused:
        a round may end once ``goal - |active|`` peers are heard (floored
        at 1 for positive goals — a round that needs evidence always
        needs SOME evidence or the driver would spin).  ``goal <= 0`` is
        an already-satisfied quorum (the drivers' instant-end path) and
        is returned unchanged — excusing peers must never turn an
        instant round into a deadline wait.  The protocol's own decision
        quorums are computed inside the jitted update over the full
        mailbox and are untouched."""
        if goal <= 0:
            return goal
        return max(1, goal - len(self.active()))

    # -- scoring signals ----------------------------------------------------

    def note_round(self, heard: Iterable[int], expired: bool,
                   now: Optional[float] = None,
                   goal: Optional[int] = None) -> None:
        """One completed round wave: ``heard`` = senders in the mailbox
        (self included or not — self is ignored), ``expired`` = the round
        ended by deadline expiry, ``goal`` = the round's RAW progress
        threshold (pre-``effective_threshold``), when the driver knows
        it.  Unheard peers contribute timeout score only on EXPIRED
        rounds (a goAhead round that simply didn't need peer p teaches
        nothing about p), and — when ``goal`` is given — only when the
        attribution is UNAMBIGUOUS: the shortfall ``goal - |heard|``
        covers the whole unheard set, so every silent peer's frame was
        individually required (the all-to-all case).  A dest-masked
        round (LastVoting coord→all: goal 1 with n-1 peers silent BY
        DESIGN) says nothing about WHICH silent peer was the expected
        sender, so it scores nobody — otherwise a hung coordinator
        would quarantine innocents and fill the envelope before the
        culprit.  Heard peers decay their score and — when
        quarantined/probing — rejoin."""
        now = _time.monotonic() if now is None else now
        hs = set(int(p) for p in heard)
        blame = expired
        if blame and goal is not None:
            unheard = sum(1 for p in range(self.n)
                          if p != self.id and p not in hs)
            blame = unheard > 0 and (int(goal) - len(hs)) >= unheard
        for p in range(self.n):
            if p == self.id:
                continue
            if p in hs:
                self.score[p] *= self.decay
                st = self._state[p]
                if st == _PROBING:
                    # the probe round HEARD the peer: rejoin immediately
                    # (the probe succeeded — that was its whole question)
                    self._rejoin(p)
                elif st == _QUARANTINED \
                        and self.score[p] < self.rejoin_below:
                    # frames arriving while excused decay the score; a
                    # SUSTAINED stream rejoins even before the probe
                    self._rejoin(p)
            elif blame:
                if self._state[p] == _PROBING:
                    # the probe round cost another expiry: back off harder
                    self._requarantine(p)
                else:
                    self.score[p] += 1.0
                    self._maybe_quarantine(p, now)
        self.tick(now)

    def note_malformed(self, peer: int) -> None:
        if not 0 <= peer < self.n or peer == self.id:
            return
        self.score[peer] += self.malformed_weight
        self._maybe_quarantine(peer, _time.monotonic())

    def note_reconnect(self, peer: int) -> None:
        if not 0 <= peer < self.n or peer == self.id:
            return
        self.score[peer] += self.churn_weight
        self._maybe_quarantine(peer, _time.monotonic())

    def tick(self, now: Optional[float] = None) -> None:
        """Advance probe state: quarantined peers whose backoff elapsed
        become PROBING (counted in the threshold again for the next
        round wave)."""
        now = _time.monotonic() if now is None else now
        for p, st in self._state.items():
            if st == _QUARANTINED and now >= self._probe_at.get(p, 0.0):
                self._state[p] = _PROBING
                self.probes += 1
                _C_PROBES.inc()
                if TRACE.enabled:
                    TRACE.emit("quarantine_probe", node=self.id, peer=p,
                               backoff_ms=int(self._backoff.get(p, 0)))
        _G_ACTIVE.set(len(self.active()))

    # -- view composition ---------------------------------------------------

    def resize(self, n: int, renames: Optional[Dict[int, Optional[int]]]
               = None) -> None:
        """A view change moved the group (runtime/view.py): remap scores
        through ``renames`` ({old_pid: new_pid}; ``None`` = that member
        was REMOVED and its state is dropped — without the explicit None
        an identity fallback would leak a removed peer's backoff onto
        whichever survivor inherits its pid; identity when a pid is
        absent from the dict — an ADD never renames existing members).
        Quarantine state survives for peers whose identity survives — a
        membership change is NOT an amnesty, the backoff clock keeps
        running — but the envelope is re-derived for the new n."""
        renames = renames or {}

        def target(old):
            new = renames.get(old, old)
            return new if new is not None and 0 <= new < n else None

        def remap(d, default):
            out = {p: default for p in range(n)}
            for old, v in d.items():
                new = target(old)
                if new is not None:
                    out[new] = v
            return out

        new_id = renames.get(self.id, self.id)
        self.id = self.id if new_id is None else new_id
        self.score = remap(self.score, 0.0)
        self._state = remap(self._state, _HEALTHY)
        self._backoff = {target(p): v for p, v in self._backoff.items()
                         if target(p) is not None}
        self._probe_at = {target(p): v for p, v in self._probe_at.items()
                          if target(p) is not None}
        self.n = n
        if self._envelope_auto:
            # re-derive the default envelope for the new n; an EXPLICIT
            # constructor value (incl. the max_quarantined=0 dry-run
            # mode) survives view changes — a resize must not silently
            # turn an observe-only scorer into a quarantining one
            self.max_quarantined = (n - 1) // 3
        # the envelope may have shrunk: release the newest quarantines
        # beyond it (release, not keep — a too-large quarantined set is
        # the unsafe direction)
        active = sorted(self.active(),
                        key=lambda p: self._probe_at.get(p, 0.0))
        for p in active[self.max_quarantined:]:
            self._rejoin(p)
        _G_ACTIVE.set(len(self.active()))

    def resize_from_view(self, renames: Optional[Dict[int, int]],
                         n: int) -> None:
        """ViewManager.on_change adapter — its observer passes
        (renames, new_n)."""
        self.resize(n, renames)

    # -- transitions --------------------------------------------------------

    def _maybe_quarantine(self, p: int, now: float) -> None:
        if self._state[p] != _HEALTHY:
            return
        if self.score[p] < self.quarantine_after:
            return
        if len(self.active()) >= self.max_quarantined:
            return  # envelope full: keep scoring, never over-quarantine
        self._state[p] = _QUARANTINED
        back = self._backoff.get(p, 0.0)
        back = (self.probe_backoff_ms if back <= 0
                else min(back * self.probe_backoff_factor,
                         self.probe_backoff_max_ms))
        self._backoff[p] = back
        self._probe_at[p] = now + back / 1000.0
        self.quarantines += 1
        _C_EVENTS.inc()
        _G_ACTIVE.set(len(self.active()))
        if TRACE.enabled:
            TRACE.emit("quarantine", node=self.id, peer=p,
                       score=round(self.score[p], 2),
                       backoff_ms=int(back))

    def _requarantine(self, p: int) -> None:
        self._state[p] = _HEALTHY  # so _maybe_quarantine transitions
        self.score[p] = max(self.score[p], self.quarantine_after)
        self._maybe_quarantine(p, _time.monotonic())

    def _rejoin(self, p: int) -> None:
        self._state[p] = _HEALTHY
        self.score[p] = 0.0
        # backoff is NOT reset: a peer that flaps back into quarantine
        # pays escalating probe intervals (the exponential-backoff
        # contract); it decays only through sustained health
        self.rejoins += 1
        _C_REJOINS.inc()
        _G_ACTIVE.set(len(self.active()))
        if TRACE.enabled:
            TRACE.emit("quarantine_rejoin", node=self.id, peer=p)

    # -- summary ------------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        states = {0: "healthy", 1: "quarantined", 2: "probing"}
        out: List[Dict[str, object]] = []
        for p in range(self.n):
            if p == self.id:
                continue
            if self.score[p] > 0 or self._state[p] != _HEALTHY:
                out.append({"peer": p,
                            "score": round(self.score[p], 2),
                            "state": states[self._state[p]],
                            "backoff_ms": int(self._backoff.get(p, 0))})
        return {"quarantines": self.quarantines, "probes": self.probes,
                "rejoins": self.rejoins, "peers": out}
