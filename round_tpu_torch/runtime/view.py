"""Live cluster reconfiguration: versioned views, consensus-decided
membership ops, and the rewiring of a RUNNING host cluster.

Reference parity: example/DynamicMembership.scala:231-245 — the group runs
consensus on a MembershipOp; once decided, the Directory is mutated, ids
are renamed to stay contiguous (Replicas.scala:136-142) and the TCP
channels are rewired (TcpRuntime.scala:75-110).  The earlier reproduction
ran this flow at simulation level only (apps/dynamic_membership.py — "no
sockets to rewire"); this module is the missing runtime half:

  * ``View`` — a VERSIONED group: ``epoch`` (bumped once per applied op)
    + the immutable ``Group`` of runtime/membership.py.  The epoch rides
    every NORMAL frame in the Tag's otherwise-unused callStack byte
    (runtime/oob.py), so a replica still wired for an old view is detected
    from its first packet.

  * ``ViewManager`` — per-replica: (a) runs one consensus instance on the
    encoded op over the CURRENT view's wire (the same HostRunner +
    Algorithm machinery as the data plane, under a reserved high instance
    id), (b) applies the decided op ATOMICALLY — new Group with contiguous
    ids, ``HostTransport.rewire`` swaps the live peer table (unrelated
    channels untouched), epoch += 1 — and (c) answers old-epoch traffic
    with a FLAG_VIEW catch-up carrying the serialized view, which the
    stale replica adopts (rewire + epoch jump) without re-running the
    membership consensus it missed.

  * Op encoding — ``kind * 2^24 + arg`` with ADD(port) / REMOVE(pid),
    shared with the simulation path (apps/dynamic_membership.py imports
    these).  An ADD's address is ``(add_host, port)`` — localhost by
    default, the deployment shape of the multi-process harness.

A replica that discovers it was REMOVED (its address is absent from the
new group) sets ``removed`` and stops touching the wire; the host loop
exits it cleanly.  An ADDED replica is started against the post-add view
and joins via the existing decision-replay catch-up path
(apps/host_replica.py --join-wait holds it silent until the add actually
decides, so its future-epoch traffic cannot leak the view early).

Transport churn-tolerance underneath this lives in runtime/transport.py
(``rewire``, ``start_reconnect``) and native/transport.cpp; chaos faults
compose — runtime/chaos.py's FaultyTransport schedules are pure functions
of (seed, src, dst, round) and survive any number of reconnects.

Port of round_tpu/runtime/view.py: the op encoding, ``View`` (its wire form
pickles to round_tpu's bytes: plain builtins) and ``ViewManager`` over any
object with round_tpu's transport methods (``send``, ``rewire``).
``propose`` runs the membership consensus over the port's host runner
(runtime/host.py::HostRunner) on ``device`` (the card unless the caller
passes another).
"""

from __future__ import annotations

import dataclasses
import pickle
import time as _time
from typing import Any, Dict, List, Optional, Tuple

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime.log import get_logger
from round_tpu_torch.runtime.membership import Group, Replica
from round_tpu_torch.runtime.oob import FLAG_VIEW, Tag

log = get_logger("view")

_C_CHANGES = METRICS.counter("view.changes")
_C_ADOPTS = METRICS.counter("view.adopts")
_C_STALE = METRICS.counter("view.stale_peers")
_C_REPLIES = METRICS.counter("view.replies")
# proof-licensed reconfiguration (round_tpu/rv/license.py,
# docs/MEMBERSHIP.md "proof-licensed resizing"): ops refused because no
# all-n proof licenses the target size, and ops that proceeded anyway
# (the --view-unlicensed-ok escape hatch, or decided elsewhere and
# adopted) leaving the replica flagged degraded
_C_REFUSED = METRICS.counter("view.refused")
_C_DEGRADED = METRICS.counter("view.degraded")

# -- the MembershipOp encoding (DynamicMembership.scala:217-229), shared
# with the simulation path: apps/dynamic_membership.py imports these -----
ADD, REMOVE = 1, 2


def encode(kind: int, arg: int) -> int:
    if not 0 <= arg < (1 << 24):
        raise ValueError(f"op arg must fit 24 bits, got {arg}")
    return kind * (1 << 24) + arg


def decode(op: int) -> Tuple[int, int]:
    return op // (1 << 24), op % (1 << 24)


# the view-change consensus runs under reserved HIGH instance ids so it can
# never collide with the data plane's 1..N sequence (tag.instance is 16
# bits; epoch e's change instance is 0xFF00 | (e+1 mod 256))
def view_instance(epoch: int) -> int:
    return 0xFF00 | ((epoch + 1) & 0xFF)


@dataclasses.dataclass(frozen=True)
class View:
    """A versioned membership: ``epoch`` counts applied ops, ``group``
    maps contiguous pids 0..n-1 to addresses (Replicas.scala:20-131)."""

    epoch: int
    group: Group

    @property
    def n(self) -> int:
        return self.group.size

    @property
    def epoch_byte(self) -> int:
        """The 8-bit stamp every NORMAL frame carries (Tag.call_stack).
        Mod-256 wrap is resolved by modular distance — see
        ``epoch_behind``."""
        return self.epoch & 0xFF

    def peers(self) -> Dict[int, Tuple[str, int]]:
        """The pid -> (host, port) table the transport and HostRunner
        consume."""
        return {r.id: (r.address, r.port) for r in self.group.replicas}

    def apply(self, kind: int, arg: int, add_host: str = "127.0.0.1"
              ) -> "View":
        """The next view under one decided op: ADD appends at the next id,
        REMOVE compacts ids to 0..n-2 (Replicas.scala:136-142)."""
        if kind == ADD:
            g = self.group.add(add_host, arg)
        elif kind == REMOVE:
            g = self.group.remove(arg)
        else:
            raise ValueError(f"unknown membership op kind {kind}")
        return View(self.epoch + 1, g)

    # -- wire form (FLAG_VIEW payload) -----------------------------------
    # plain builtins only: the restricted wire unpickler
    # (transport.wire_loads) refuses everything class-shaped

    def wire(self) -> Tuple[int, Tuple[Tuple[str, int], ...]]:
        return (self.epoch,
                tuple((r.address, r.port) for r in self.group.replicas))

    @classmethod
    def from_wire(cls, payload: Any) -> Optional["View"]:
        """Parse a FLAG_VIEW payload; None on anything malformed (the
        socket is unauthenticated — garbage must never raise)."""
        try:
            epoch, addrs = payload
            epoch = int(epoch)
            if epoch < 0 or not 0 < len(addrs) <= 0xFFFF:
                return None
            reps = [Replica(i, str(h), int(p))
                    for i, (h, p) in enumerate(addrs)]
            return cls(epoch, Group(reps))
        except Exception:  # noqa: BLE001 — malformed payloads are dropped
            return None


def epoch_behind(theirs: int, mine: int) -> bool:
    """True when the 8-bit epoch stamp ``theirs`` is BEHIND ``mine`` under
    mod-256 wraparound (modular distance < 128 ⇒ behind; epochs advance a
    handful of times per deployment, so 128 of headroom is vast)."""
    return 0 < ((mine - theirs) & 0xFF) < 128


class ViewManager:
    """One replica's live view state + the machinery that moves it.

    Three jobs (the DynamicMembership.scala flow on a real wire):
      * ``propose(kind, arg)``: run consensus on the op over the current
        view (every member proposes the same scripted op, so by validity
        the decision IS the op — the uniform schedule of the chaos
        harness) and apply it;
      * ``apply_op``: the atomic switch — new Group (contiguous renames),
        ``transport.rewire`` (live peer-table swap, unrelated channels
        kept), epoch += 1.  A replica whose own address vanished flags
        ``removed`` and leaves the wire alone;
      * the epoch guard HostRunner calls per NORMAL frame
        (``check_epoch``): stale peers get a rate-limited FLAG_VIEW reply
        with the serialized view; a peer AHEAD of us flags ``stale`` so
        the runner exits the instance and the host loop re-enters under
        whatever view the FLAG_VIEW catch-up delivers (``adopt_wire``).
    """

    def __init__(self, my_id: int, view: View, transport,
                 add_host: str = "127.0.0.1", license=None,
                 license_model: Optional[str] = None,
                 unlicensed_ok: bool = False):
        if not view.group.contains(my_id):
            raise ValueError(f"my_id={my_id} not in view of n={view.n}")
        self.my_id: Optional[int] = my_id
        self.view = view
        self.transport = transport
        self.add_host = add_host
        self.removed = False
        self.stale = False       # a peer was observed AHEAD of our epoch
        self.history: List[Tuple[int, int, int]] = []  # (epoch, kind, arg)
        # proof-licensed reconfiguration (rv/license.py
        # ProofLicenseRegistry + the serving protocol's name): with a
        # ``license``, propose() consults the parameterized-proof
        # registry BEFORE running the membership consensus — a resize
        # the all-n proofs do not cover is REFUSED (no op proposed), or,
        # under ``unlicensed_ok``, proceeds with this replica flagged
        # DEGRADED.  Ops decided elsewhere and adopted can only be
        # flagged, never refused (the group already moved).  None = the
        # pre-license world, zero behavior change.
        self.license = license
        self.license_model = license_model
        self.unlicensed_ok = unlicensed_ok
        self.degraded = False
        self.refusals: List[Dict[str, Any]] = []
        self._replied: Dict[int, float] = {}  # FLAG_VIEW rate limiter
        # encoded current view, cached per epoch: reply_view used to
        # re-serialize the SAME view for every stale peer it answered
        # (the per-peer re-encode audit of runtime/host.py)
        self._wire_cache: Optional[Tuple[int, bytes]] = None
        # optional observer (renames: {old_pid: new_pid | None}, new_n;
        # None = that member was removed) called
        # after every SURVIVING view move — apply_op and adopt_wire —
        # so per-peer state keyed by pid (runtime/health.py PeerHealth)
        # remaps through membership changes instead of silently scoring
        # the wrong peers.  Exceptions are swallowed: an observer must
        # never wedge a view change.  ``on_change`` is the original
        # single-slot hook (kept: host_replica assigns it directly);
        # ``add_observer`` registers any number of additional watchers —
        # the fleet router's shard-map rebalance (runtime/fleet.py)
        # composes with PeerHealth.resize on the same view move.
        self.on_change = None
        self._observers: List[Any] = []

    def add_observer(self, cb) -> None:
        """Register an additional (renames, n) observer beside
        ``on_change`` — every registered callback fires on every
        surviving view move, each isolated from the others' failures."""
        self._observers.append(cb)

    def _notify_change(self, renames: Dict[int, int], n: int) -> None:
        cbs = ([self.on_change] if self.on_change is not None else []) \
            + list(self._observers)
        for cb in cbs:
            try:
                cb(renames, n)
            except Exception:  # noqa: BLE001 — an observer must not kill
                log.warning("view on_change observer failed",
                            exc_info=True)  # the move (or its siblings)

    @property
    def epoch(self) -> int:
        return self.view.epoch

    @property
    def epoch_byte(self) -> int:
        return self.view.epoch_byte

    # -- the consensus-on-op path ----------------------------------------

    def propose(self, algo, kind: int, arg: int, *, seed: int = 0,
                timeout_ms: int = 300, max_rounds: int = 48,
                adaptive=None, foreign=None, prefill=None, device=None,
                ) -> Optional[Tuple[int, int]]:
        """Run ONE consensus instance on ``encode(kind, arg)`` over the
        current view's wire and apply the decision.  All members of the
        view must call this at the same point of their instance sequence
        (the --view-change script of apps/host_replica.py).  Returns the
        decided (kind, arg), or None when the instance timed out
        undecided — the view is then unchanged and the caller may retry
        or rely on the FLAG_VIEW catch-up if peers did decide.  The
        instance's rounds run on ``device`` (the card when None)."""
        import numpy as np

        from round_tpu_torch.runtime.host import HostRunner

        if self.removed:
            return None
        if not self._license_gate(kind, arg):
            return None
        inst = view_instance(self.epoch)
        runner = HostRunner(
            algo, self.my_id, self.view.peers(), self.transport,
            instance_id=inst, timeout_ms=timeout_ms,
            seed=seed ^ (0x51E << 8) ^ self.epoch, adaptive=adaptive,
            foreign=foreign, prefill=prefill, view=self, device=device,
        )
        res = runner.run({"initial_value": np.int32(encode(kind, arg))},
                         max_rounds=max_rounds)
        if res.stale_view:
            # a FLAG_VIEW catch-up already moved us past this epoch —
            # the op (ours or another) was applied by adopt_wire
            return None
        if not res.decided:
            return None
        kind_d, arg_d = decode(int(np.asarray(res.decision)))
        self.apply_op(kind_d, arg_d)
        return kind_d, arg_d

    def _license_gate(self, kind: int, arg: int) -> bool:
        """The proof gate of propose(): True = proceed.  A non-licensed
        resize is refused (obs event ``view_refused`` + counter), or —
        under the explicit escape hatch — proceeds with the replica
        flagged degraded (``view_degraded``)."""
        if self.license is None:
            return True
        new_n = self.view.apply(kind, arg, add_host=self.add_host).n
        lic = self.license.check(self.license_model, new_n)
        if lic.ok:
            return True
        if not self.unlicensed_ok:
            _C_REFUSED.inc()
            self.refusals.append({
                "epoch": self.epoch, "kind": kind, "arg": arg,
                "n": new_n, "license": lic.to_json()})
            if TRACE.enabled:
                TRACE.emit("view_refused", node=self.my_id,
                           epoch=self.epoch,
                           op=("add" if kind == ADD else "remove"),
                           arg=arg, n=new_n, status=lic.status,
                           reason=lic.reason)
            log.warning("node %s: membership op REFUSED (n=%d %s): %s",
                        self.my_id, new_n, lic.status, lic.reason)
            return False
        self._flag_degraded(new_n, lic)
        return True

    def _flag_degraded(self, new_n: int, lic) -> None:
        self.degraded = True
        _C_DEGRADED.inc()
        if TRACE.enabled:
            TRACE.emit("view_degraded", node=self.my_id,
                       epoch=self.epoch, n=new_n, status=lic.status,
                       reason=lic.reason)
        log.warning("node %s: view move to n=%d is UNLICENSED (%s) — "
                    "proceeding degraded: %s", self.my_id, new_n,
                    lic.status, lic.reason)

    def _license_observe(self, new_n: int) -> None:
        """The adopt/apply-path check: an op already decided can only be
        FLAGGED (cache-only — never stall a committed move on a cold
        solver run)."""
        if self.license is None or self.degraded:
            return
        lic = self.license.check(self.license_model, new_n, solve=False)
        if not lic.ok:
            self._flag_degraded(new_n, lic)

    def apply_op(self, kind: int, arg: int) -> None:
        """Apply one DECIDED op atomically: group + ids + wire + epoch."""
        old = self.view
        new = old.apply(kind, arg, add_host=self.add_host)
        renaming = new.group.renaming_from(old.group)
        new_id = renaming.get(self.my_id)
        self.history.append((new.epoch, kind, arg))
        _C_CHANGES.inc()
        if TRACE.enabled:
            TRACE.emit("view_change", node=self.my_id, epoch=new.epoch,
                       op=("add" if kind == ADD else "remove"), arg=arg,
                       n=new.n, new_id=new_id)
        if new_id is None:
            # we were voted out: QUIESCE the wire — sever every channel
            # and empty the peer table so neither a late send nor the
            # reconnect loop dials back in (a removed replica redialing
            # with its stale id is exactly the channel-hijack the
            # handshake's listen-port check rejects; don't even try).
            # The host loop then exits this replica cleanly.
            self.removed = True
            self.view = new
            self.transport.rewire({})
            log.info("node %s: removed from the group at epoch %d",
                     self.my_id, new.epoch)
            self.my_id = None
            return
        # FAREWELL before the sever: pids this op removed get one
        # FLAG_VIEW with the new view while their channels still exist —
        # a removed replica that missed the remove decision (it was the
        # drop victim) learns of its exile immediately instead of
        # depending on the slower fallback (its redial reaching the
        # member that inherited its id).  Best-effort: the frame can
        # drop; the fallback remains.
        wire_view = pickle.dumps(new.wire())
        for old_pid, mapped in renaming.items():
            if mapped is None and old_pid != self.my_id:
                self.transport.send(
                    old_pid, Tag(instance=0, flag=FLAG_VIEW,
                                 call_stack=new.epoch_byte), wire_view)
        self.transport.rewire(new.peers(), my_id=new_id)
        self.my_id = new_id
        self.view = new
        self._replied.clear()
        self._notify_change(dict(renaming), new.n)

    # -- the epoch guard (HostRunner per-frame hook) ---------------------

    def check_epoch(self, sender: int, tag: Tag) -> bool:
        """True when the NORMAL frame's epoch stamp matches our view.  On
        mismatch the frame must be dropped: a stale peer's traffic is
        answered with a FLAG_VIEW catch-up; a peer AHEAD of us flags
        ``stale`` (the runner exits, the catch-up reply to OUR next stamped
        send completes the adoption)."""
        theirs = tag.call_stack & 0xFF
        mine = self.epoch_byte
        if theirs == mine:
            return True
        if epoch_behind(theirs, mine):
            _C_STALE.inc()
            self.reply_view(sender)
        else:
            if not self.stale and TRACE.enabled:
                TRACE.emit("view_stale", node=self.my_id,
                           epoch=self.epoch, observed=theirs)
            self.stale = True
        return False

    def reply_view(self, sender: int) -> bool:
        """Send the serialized current view to a stale peer, rate-limited
        per sender (the reply can drop; the peer's next stamped frame
        re-arms it — the trySendDecision discipline)."""
        now = _time.monotonic()
        if now - self._replied.get(sender, -1.0) <= 0.25:
            return False
        self._replied[sender] = now
        if self._wire_cache is None or self._wire_cache[0] != self.epoch:
            self._wire_cache = (self.epoch, pickle.dumps(self.view.wire()))
        self.transport.send(
            sender, Tag(instance=0, flag=FLAG_VIEW,
                        call_stack=self.epoch_byte),
            self._wire_cache[1],
        )
        _C_REPLIES.inc()
        if TRACE.enabled:
            TRACE.emit("view_reply", node=self.my_id, dst=sender,
                       epoch=self.epoch)
        return True

    def adopt_wire(self, payload: Any) -> bool:
        """Adopt a FLAG_VIEW catch-up: jump to the carried view (strictly
        newer epochs only), find our own pid by our address, rewire.  The
        membership consensus we missed is NOT re-run — the view is the
        state, exactly like a decision reply replaces re-running the
        instance.  Returns True when the view moved."""
        v = View.from_wire(payload)
        if v is None or v.epoch <= self.view.epoch or self.removed:
            return False
        my_addr = (None if self.my_id is None
                   else self.view.group.get(self.my_id))
        new_id = (None if my_addr is None
                  else v.group.inet_to_id(my_addr.address, my_addr.port))
        _C_ADOPTS.inc()
        if TRACE.enabled:
            TRACE.emit("view_adopt", node=self.my_id, epoch=v.epoch,
                       n=v.n, new_id=new_id)
        if new_id is None:
            self.removed = True
            self.view = v
            self.transport.rewire({})  # quiesce (see apply_op)
            self.my_id = None
            log.info("view catch-up: removed from the group at epoch %d",
                     v.epoch)
            return True
        # an adopted op is already committed group-wide: the license
        # check can only FLAG here (cache-only, never a solver stall)
        self._license_observe(v.n)
        old_view = self.view
        self.transport.rewire(v.peers(), my_id=new_id)
        self.my_id = new_id
        self.view = v
        self.stale = False
        self._replied.clear()
        # identity is ADDRESS here (the consensus we missed renamed pids):
        # remap per-peer state by looking each old member up in the new
        # group, exactly how our own new_id was found
        renames = {}
        for rep in old_view.group.replicas:
            # None = the member left the group: the observer must DROP
            # its state, not let an identity fallback leak it onto
            # whichever survivor inherits the pid
            renames[rep.id] = v.group.inet_to_id(rep.address, rep.port)
        self._notify_change(renames, v.n)
        return True


def parse_view_schedule(spec: str) -> Dict[int, Tuple[int, int]]:
    """Parse the --view-change script: ``INST:add=PORT`` / ``INST:remove=PID``
    entries, comma-separated — after data instance INST completes, the
    replica proposes that op (all replicas must carry the same script, the
    deployment-config analogue of the reference's scripted
    DynamicMembership driver).  Example: ``2:add=7005,4:remove=1``."""
    out: Dict[int, Tuple[int, int]] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            inst_s, op_s = part.split(":", 1)
            op_name, arg_s = op_s.split("=", 1)
            kind = {"add": ADD, "remove": REMOVE}[op_name.strip()]
            inst, arg = int(inst_s), int(arg_s)
        except (ValueError, KeyError):
            raise ValueError(
                f"bad --view-change entry {part!r}; want INST:add=PORT "
                f"or INST:remove=PID") from None
        if inst in out:
            raise ValueError(f"duplicate view change at instance {inst}")
        out[inst] = (kind, arg)
    return out
