"""Out-of-band messaging: Tag flags, the default handler, message recovery.

Port of round_tpu/runtime/oob.py, unchanged over the port's InstancePool:
``Tag.pack`` gives round_tpu's 64-bit words and the ``FLAG_*`` values are
round_tpu's.

Reference parity: every packet carries an 8-byte Tag
``flag:1B | callStack:1B | instance:2B | round:4B`` (Tag.scala:22-25) whose
flag routes it — Normal/Dummy to the instance dispatcher, Error reserved,
anything else user-definable and routed to the Runtime's *defaultHandler*
(Runtime.scala:99-101, 151-155).  The PerfTest harness builds its decision
replay on exactly this: a normal message for an already-decided instance
makes the peer answer with a ``Decision``-flagged message (or ``TooLate`` if
evicted), and the laggard's defaultHandler records/stops accordingly
(PerfTest.scala:40-60, trySendDecision :86-100); a message for an unknown
*future* instance lazily starts it (PerfTest2.scala:72-110).

In the TPU build the hot path has no packets (the round exchange is the
fused kernel), but the *control plane* between pools keeps the reference's
message shape: ``Message = Tag + payload`` over a host-side ``LocalBus``.
``PoolNode`` wires an InstancePool to the bus with the reference's handler
semantics: beside the direct-call ``InstancePool.recover_from``, a
message-driven flow a real transport could carry unchanged (the Tag packs
to the same 8-byte layout).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from round_tpu_torch.core.time import Instance
from round_tpu_torch.runtime.instances import InstancePool, MAX_INSTANCE

# Flag space (Tag.scala:5-12): 0..2 reserved, >= 3 user-definable.
FLAG_NORMAL = 0
FLAG_DUMMY = 1
FLAG_ERROR = 2
# the PerfTest recovery protocol's user flags (PerfTest.scala:30-38)
FLAG_DECISION = 4
FLAG_TOO_LATE = 5
FLAG_RECOVERY = 6
# transport-internal frame coalescing (runtime/transport.py): the payload
# is a sequence of `u64 tag | u32 len | payload` sub-frames accumulated
# for one destination and flushed as ONE wire frame (the Netty
# write-coalescing role).  Split back into logical frames by header peek
# inside HostTransport.recv — this flag never reaches a HostRunner.
# 0xB7, far from the user-flag range apps allocate from (lock_manager
# already took 8/9; a collision here would make the transport shred an
# app's frames as containers).
FLAG_BATCH = 0xB7
# view-change catch-up (runtime/view.py): the reply a current-view replica
# sends to traffic stamped with an OLD epoch — payload is the serialized
# View (epoch + address list), the receiver adopts it and rewires
FLAG_VIEW = 7
# admission NACK (overload hardening, docs/HOST_FAULT_MODEL.md): the reply
# an overloaded replica sends instead of stashing a future-instance frame
# it cannot afford to hold — "your frame was SHED, not lost to the wire".
# Empty payload; the instance id in the Tag names what was refused.  The
# retry contract is the protocol's own retransmission: every live round
# re-sends, and a shed replica catches up via the decision-reply path once
# pressure clears, so a NACK never needs (or gets) an explicit client
# retry loop — it exists so shedding is ACCOUNTED (overload.* counters,
# trace_view classification) instead of indistinguishable from loss.
# 10: clear of lock_manager's 8/9 and the reserved 0..2 range.
FLAG_NACK = 10
# the fleet client protocol (runtime/fleet.py, docs/SERVING.md): frames
# from CLIENT peers — transport senders OUTSIDE the consensus group
# (LaneDriver(clients=...)), the front-door router's id space.
#   PROPOSE: "start instance tag.instance with this payload as the
#   initial value" — payload is a codec-encoded scalar (int32) or byte
#   vector (uint8[B], the LastVotingBytes workload).  Idempotent by
#   design, which is what makes it the retry AND the catch-up: re-sent
#   for a live instance it is ignored, for a completed one it is
#   answered with the FLAG_DECISION (or FLAG_TOO_LATE if undecided)
#   the client may have missed, and under admission shedding it gets
#   the accounted FLAG_NACK — the client backs off and retries
#   (FleetRouter's capped-backoff state machine).
#   SUBSCRIBE: "stream me every decision this driver completes from
#   now on" (empty payload; the sender id is the subscription).
# 11/12: clear of lock_manager's 8/9, FLAG_NACK 10, and FLAG_BATCH.
FLAG_PROPOSE = 11
FLAG_SUBSCRIBE = 12
# round-consistent snapshot samples (round_tpu/snap, docs/SNAPSHOTS.md):
# a replica's own per-lane state sampled at a ROUND BOUNDARY — the HO
# model's communication-closed rounds make a round-aligned cut a
# consistent global state BY CONSTRUCTION, so no Chandy-Lamport marker
# protocol rides the wire, only the samples themselves.  Payload is a
# codec-typed dict (runtime/codec.py — zero pickle, template-parseable
# like every hot frame): the state leaves, the instance's proposal row,
# and a blake2b digest of the canonical state encoding (divergence
# forensics).  Tag carries the coordinate: instance, round, and the view
# epoch in the callStack byte (a cut must never join samples across a
# membership change).  13: clear of lock_manager's 8/9, FLAG_NACK 10,
# the fleet pair 11/12, and FLAG_BATCH.
FLAG_SNAP = 13
# the KV serving verbs (round_tpu/kv, docs/KV.md): client frames beside
# the fleet pair, same untrusted-boundary discipline.
#   READ: "answer this key at this consistency grade" — payload is a
#   codec dict {r: read id, k: key bytes, g: grade} and the reply rides
#   the SAME flag back with {r, st, seq, v}.  Reads never occupy the
#   consensus instance-id space: Tag.instance carries the 16-bit read id
#   only so shedding can refuse one with the accounted FLAG_NACK
#   (linearizable reads queue a round-wave barrier, so under admission
#   pressure they are shed and NACK-accounted exactly like proposals;
#   lease/stale grades answer from applied state and stay cheap enough
#   to serve while shedding).
#   TXN: "propose this transaction-control record" — PROPOSE's exact
#   state machine (idempotent retry/catch-up, FLAG_DECISION stream,
#   accounted NACK under shedding) but the payload MUST decode as a KV
#   transaction record (kv/store.py: TXN/PREPARE/COMMIT/ABORT), so a
#   shard can refuse transaction verbs when KV serving is off and
#   account them separately (kv.txn_frames).
# 14/15: clear of lock_manager's 8/9, FLAG_NACK 10, the fleet pair
# 11/12, FLAG_SNAP 13 and FLAG_BATCH.
FLAG_READ = 14
FLAG_TXN = 15
# the serveable instance-id range for fleet clients: 0 is the lane
# driver's free-slot marker and 0xFF00.. is reserved for view-change
# consensus (runtime/view.py view_instance) — BOTH the trusted router
# (FleetRouter.propose) and the untrusted shard boundary
# (LaneDriver._client_frame) enforce it, so a hostile front-door peer
# cannot run data-plane rounds on a membership-consensus id.
FLEET_MIN_INSTANCE = 1
FLEET_MAX_INSTANCE = 0xFEFF


@dataclasses.dataclass(frozen=True)
class Tag:
    """8-byte packet header (Tag.scala:22-62).

    The ``call_stack`` byte — unused by this runtime's protocols, like the
    reference's — is REUSED by the view subsystem (runtime/view.py) to
    stamp the sender's view epoch (mod 256) onto every NORMAL frame, so a
    replica still running an old view is detected from its very first
    packet and answered with a FLAG_VIEW catch-up.  On the CLIENT verbs
    (FLAG_PROPOSE / FLAG_TXN / FLAG_READ / FLAG_NACK) the byte is free —
    no epoch rides there — and carries the TENANT id (0-255) for
    per-tenant weighted-fair admission (runtime/instances.py
    TenantAdmission, docs/SERVING.md): zero wire-format change."""

    instance: int
    round: int = 0
    flag: int = FLAG_NORMAL
    call_stack: int = 0

    def pack(self) -> int:
        """The reference's wire layout: flag byte 0, callStack byte 1,
        instance bytes 2-3, round bytes 4-7."""
        return (
            (self.flag & 0xFF)
            | (self.call_stack & 0xFF) << 8
            | (self.instance & 0xFFFF) << 16
            | (self.round & 0xFFFFFFFF) << 32
        )

    @classmethod
    def unpack(cls, word: int) -> "Tag":
        return cls(
            flag=word & 0xFF,
            call_stack=(word >> 8) & 0xFF,
            instance=(word >> 16) & 0xFFFF,
            round=(word >> 32) & 0xFFFFFFFF,
        )


@dataclasses.dataclass
class Message:
    """An out-of-band message: routed by tag.flag (Message.scala:15-80)."""

    sender: int
    tag: Tag
    payload: Any = None


class LocalBus:
    """Host-side point-to-point wire between nodes (the control-plane
    analogue of Runtime.sendMessage, Runtime.scala:138-143).  Delivery is
    explicit (``deliver``/``deliver_all``) so tests can reorder/drop —
    faults on the control plane, like the data plane's HO masks."""

    def __init__(self):
        self._nodes: Dict[int, "PoolNode"] = {}
        self._queues: Dict[int, List[Message]] = {}

    def register(self, node: "PoolNode") -> None:
        self._nodes[node.node_id] = node
        self._queues.setdefault(node.node_id, [])

    def send(self, to: int, msg: Message) -> None:
        if to in self._queues:  # unknown peers: dropped, like UDP
            self._queues[to].append(msg)

    def deliver(self, node_id: int, limit: Optional[int] = None) -> int:
        """Hand queued messages to the node's default handler; returns the
        number delivered.  A handler error (e.g. a reserved/unknown flag)
        must not discard the rest of the popped batch — the remaining
        messages are still delivered and the first error re-raised after."""
        q = self._queues.get(node_id, [])
        k = len(q) if limit is None else min(limit, len(q))
        batch, self._queues[node_id] = q[:k], q[k:]
        node = self._nodes[node_id]
        first_err: Optional[Exception] = None
        for m in batch:
            try:
                node.default_handler(m)
            except Exception as e:  # noqa: BLE001 - per-message isolation
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return k

    def deliver_all(self) -> int:
        total = 0
        while any(self._queues.values()):
            for nid in list(self._queues):
                total += self.deliver(nid)
        return total


class PoolNode:
    """An InstancePool attached to the bus with the reference's
    defaultHandler semantics (PerfTest.scala:40-60, PerfTest2.scala:72-110).

    - normal-flag message for an instance we already decided → reply
      FLAG_DECISION with the value (trySendDecision);
    - normal-flag for an instance past our window that we no longer have →
      reply FLAG_TOO_LATE;
    - normal-flag for an unknown *future* instance → lazy join: start it
      via ``on_unknown_instance`` (PerfTest2's startInstance path);
    - FLAG_DECISION → record the decision, stop any local run of it;
    - FLAG_TOO_LATE → stop the local run (the value is unrecoverable here);
    - FLAG_RECOVERY → explicit ask: same answer path as a normal probe.
    """

    def __init__(
        self,
        node_id: int,
        pool: InstancePool,
        bus: LocalBus,
        on_unknown_instance: Optional[Callable[[int], None]] = None,
        on_decision: Optional[Callable[[int, Any], None]] = None,
    ):
        self.node_id = node_id
        self.pool = pool
        self.bus = bus
        self.on_unknown_instance = on_unknown_instance
        self.on_decision = on_decision
        self.version = 0  # highest instance id this node has opened
        bus.register(self)

    # -- outgoing ----------------------------------------------------------

    def note_opened(self, instance_id: int) -> None:
        iid = instance_id % MAX_INSTANCE
        if Instance.lt(self.version, iid):
            self.version = iid

    def ask_decision(self, peer: int, instance_id: int) -> None:
        """Ask a peer for an old instance's outcome (Recovery flag)."""
        self.bus.send(
            peer,
            Message(self.node_id, Tag(instance_id % MAX_INSTANCE,
                                      flag=FLAG_RECOVERY)),
        )

    def probe(self, peer: int, instance_id: int, round_: int = 0) -> None:
        """A normal protocol message that leaks to a peer's default handler
        (the implicit recovery trigger: the laggard's old traffic)."""
        self.bus.send(
            peer,
            Message(self.node_id, Tag(instance_id % MAX_INSTANCE, round_)),
        )

    # -- incoming ----------------------------------------------------------

    def default_handler(self, msg: Message) -> None:
        tag = msg.tag
        iid = tag.instance
        if tag.flag in (FLAG_NORMAL, FLAG_DUMMY, FLAG_RECOVERY):
            res = self.pool.get_decision(iid)
            if res is not None and res.value is not None:
                # only an actual decision is replayable (trySendDecision's
                # getDec match, PerfTest.scala:86-100); an instance that
                # *finished* undecided falls through to TooLate below
                self.bus.send(
                    msg.sender,
                    Message(self.node_id, Tag(iid, flag=FLAG_DECISION),
                            payload=res.value),
                )
            elif self.pool.is_running(iid):
                pass  # live instance: the data plane handles it
            elif res is not None or Instance.lt(iid, self.version):
                # finished-undecided here, or older than anything we kept:
                # unrecoverable from us
                self.bus.send(
                    msg.sender,
                    Message(self.node_id, Tag(iid, flag=FLAG_TOO_LATE)),
                )
            elif tag.flag != FLAG_RECOVERY and self.on_unknown_instance:
                # future instance: lazy join (PerfTest2.scala:72-83)
                self.on_unknown_instance(iid)
                self.note_opened(iid)
        elif tag.flag == FLAG_DECISION:
            self.pool.adopt_decision(iid, msg.payload)
            if self.on_decision:
                self.on_decision(iid, msg.payload)
        elif tag.flag == FLAG_TOO_LATE:
            self.pool.stop(iid)
        else:
            raise ValueError(f"unknown or error flag: {tag.flag}")
