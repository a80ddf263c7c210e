"""Sharded serving fabric: a consistent-hash front door over a fleet of
lane drivers (docs/SERVING.md).

One LaneDriver process saturates around L=64 lanes on a small box
(PERF_MODEL.md "lane amortization"); serving more concurrent instances
than one driver can hold means a FLEET.  "Reducing asynchrony to
synchronized rounds" licenses the batching at fleet grain exactly as it
did at lane grain: a round wave per shard is one batched exchange, so
the front door coalesces client traffic ACROSS shards per wave the same
way `runtime/lanes.py` coalesces sends across lanes.

Three pieces:

  * ``ShardMap`` — a consistent-hash ring over STABLE shard names
    (vnode-replicated, blake2b-keyed so placement is identical across
    processes and runs).  Stable names — not pids — because live
    membership changes RENAME pids (runtime/view.py REMOVE compacts
    ids); a ring keyed by pid would reshuffle every key on every
    rename, which defeats the point of consistent hashing.

  * ``DriverServer`` — ONE shard: an n-replica consensus group served
    in-process (one thread per replica, the apps/host_perftest measure()
    shape), every replica's LaneDriver in client-serving mode
    (``LaneDriver.serve``: FLAG_PROPOSE intake, FLAG_DECISION streams,
    accounted FLAG_NACK under admission shedding).  The fleet CLI
    (apps/fleet.py) runs one DriverServer per OS process.

  * ``FleetRouter`` — the client tier, promoted out of the ad-hoc
    HostBus/host_replica entry points into a real protocol:

      propose   — route the instance to its ring owner and ship the
                  client value to EVERY replica of that shard (uniform
                  proposals: by validity the decision is the value, so
                  any quorum of the shard decides identically) over the
                  FLAG_BATCH wire, coalesced per wave;
      subscribe — ask a shard to stream every decision it completes;
      decisions — FLAG_DECISION frames stream back as instances decide
                  (first replica to answer wins; duplicates counted);
      NACK-retry — a FLAG_NACK reply (the shard is shedding,
                  docs/HOST_FAULT_MODEL.md) schedules a capped-backoff
                  re-propose; ``give_up`` retries exhausts into a
                  ``FleetGiveUp`` entry instead of silent loss.  The
                  same re-propose is the DECISION catch-up: PROPOSE is
                  idempotent, and a completed instance answers it with
                  the decision the client may have missed — so one
                  timer covers lost proposals, lost decisions, and
                  shed frames.

Rebalance (the migration story): shard membership changes arrive via a
``ViewManager`` observer (``FleetRouter.view_observer``, the same
on_change surface PeerHealth.resize rides) or directly through
``add_shard``/``remove_shard``.  The ring moves only the departed
shard's arc; in-flight instances are STICKY to the shard that already
holds them (their decision stream is live) unless that shard LEFT — a
removed shard's unresolved instances are re-proposed to their new
owners, and the idempotent-PROPOSE catch-up path makes that migration
exact: a new owner that never saw the instance runs it (uniform value
⇒ same decision), one that did answers from its decision bank.  No
decision is lost either way (pinned by tests/test_fleet.py against an
unrebalanced control, byte-identical logs).

Port of round_tpu/runtime/fleet.py.  The ring, the router's protocol and
its accounting are round_tpu's, placement byte for byte (blake2b).  A
``DriverServer``'s replicas run their lane state on ``device`` (the card
unless the caller passes another; where the card is asked for and absent
the server raises).  ``DriverServer(rv=, snap=, kv=)`` serves every
replica under runtime verification, snapshot audits and the replicated
key-value store (kv/), whose reads ride ``FleetRouter.send_read``.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time as _time
from hashlib import blake2b
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime import codec
from round_tpu_torch.runtime.log import get_logger
from round_tpu_torch.runtime.oob import (
    FLAG_DECISION, FLAG_NACK, FLAG_PROPOSE, FLAG_READ, FLAG_SUBSCRIBE,
    FLAG_TOO_LATE, FLAG_TXN, FLEET_MAX_INSTANCE, FLEET_MIN_INSTANCE, Tag,
)

log = get_logger("fleet")

# fleet.* vocabulary (docs/OBSERVABILITY.md)
_C_PROPOSALS = METRICS.counter("fleet.proposals")
_C_DECISIONS = METRICS.counter("fleet.decisions")
_C_UNDECIDED = METRICS.counter("fleet.undecided")
_C_DUPS = METRICS.counter("fleet.dup_decisions")
_C_NACKS = METRICS.counter("fleet.nacks")
_C_RETRIES = METRICS.counter("fleet.nack_retries")
_C_REPROPOSE = METRICS.counter("fleet.reproposals")
_C_GIVE_UPS = METRICS.counter("fleet.give_ups")
_C_REBALANCES = METRICS.counter("fleet.rebalances")
_C_MIGRATIONS = METRICS.counter("fleet.migrations")
_G_INFLIGHT = METRICS.gauge("fleet.inflight")
_G_SHARDS = METRICS.gauge("fleet.shards")
_H_DECIDE_MS = METRICS.histogram(
    "fleet.decide_ms", (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000,
                        5000), unit="ms")

# the data-plane instance id space (shared with the shard boundary's
# own enforcement in LaneDriver._client_frame — see runtime/oob.py)
MIN_INSTANCE = FLEET_MIN_INSTANCE
MAX_FLEET_INSTANCE = FLEET_MAX_INSTANCE


class FleetGiveUp(RuntimeError):
    """The router exhausted its capped-backoff retries for an instance
    (every attempt was NACKed or went unanswered) — the client-visible
    overload error, never silent loss."""


def _h64(data: bytes) -> int:
    return int.from_bytes(blake2b(data, digest_size=8).digest(), "big")


class ShardMap:
    """Consistent-hash ring over stable shard names.

    ``vnodes`` replicas per shard smooth the arc sizes (64 keeps the
    max/min key-share spread under ~2x at 4 shards; the balance test
    pins it).  Hashing is blake2b — deterministic across processes, so
    every router and every test computes the same placement
    (PYTHONHASHSEED never participates)."""

    def __init__(self, shards=(), vnodes: int = 64):
        self.vnodes = vnodes
        self._shards: List[str] = []
        self._ring: List[Tuple[int, str]] = []
        for s in shards:
            self.add(s)

    @property
    def shards(self) -> List[str]:
        return sorted(self._shards)

    def __len__(self) -> int:
        return len(self._shards)

    def add(self, shard: str) -> None:
        if shard in self._shards:
            raise ValueError(f"shard {shard!r} already in the ring")
        self._shards.append(shard)
        for v in range(self.vnodes):
            self._ring.append((_h64(f"{shard}#{v}".encode()), shard))
        self._ring.sort()

    def remove(self, shard: str) -> None:
        self._shards.remove(shard)
        self._ring = [(h, s) for h, s in self._ring if s != shard]

    def owner(self, instance_id: int) -> str:
        """The shard owning this instance id: first vnode clockwise of
        the key's hash (wrapping)."""
        if not self._ring:
            raise ValueError("empty shard ring")
        h = _h64(int(instance_id).to_bytes(8, "big"))
        i = bisect.bisect_right(self._ring, (h, "￿"))
        if i == len(self._ring):
            i = 0
        return self._ring[i][1]

    def owner_key(self, key: bytes) -> str:
        """The shard owning this BYTE key (the kv data plane routes by
        key, not instance id, so every write of a key lands in one
        shard's decision stream — docs/KV.md)."""
        if not self._ring:
            raise ValueError("empty shard ring")
        h = _h64(bytes(key))
        i = bisect.bisect_right(self._ring, (h, "￿"))
        if i == len(self._ring):
            i = 0
        return self._ring[i][1]


class TwoLevelRing:
    """Region → shard two-level consistent-hash ring (docs/SERVING.md
    "planet-scale control plane").

    The outer ring consistent-hashes over REGION names (a supervisor-
    owned shard group each); every region owns an inner ShardMap over
    its shards.  Routing is two cheap hash hops — outer pick, inner
    pick — and rebalance motion is LOCAL BY CONSTRUCTION: adding or
    removing a shard changes one region's inner ring only, so keys in
    every other region cannot move (the reshuffle a flat ring pays on
    every membership change is confined to one region's arc).  With a
    single region the outer hop is a constant and the inner ShardMap
    hashes exactly like the flat ring did — placement is byte-identical
    to the pre-region fleet, which is what keeps every existing test
    and banked artifact valid.

    Same interface as ShardMap (``shards``/``owner``/``owner_key``/
    ``add``/``remove``/``__len__``) plus the region surface
    (``regions``/``region_of``); ``add`` grows a ``region=`` keyword
    that defaults to one flat region."""

    def __init__(self, vnodes: int = 64, region_vnodes: int = 64):
        self.vnodes = vnodes
        self.region_vnodes = region_vnodes
        self._outer: List[Tuple[int, str]] = []
        self._inner: Dict[str, ShardMap] = {}
        self._region_of: Dict[str, str] = {}

    @property
    def shards(self) -> List[str]:
        return sorted(self._region_of)

    @property
    def regions(self) -> List[str]:
        return sorted(self._inner)

    def region_of(self, shard: str) -> str:
        return self._region_of[shard]

    def __len__(self) -> int:
        return len(self._region_of)

    def add(self, shard: str, region: str = "r0") -> None:
        if shard in self._region_of:
            raise ValueError(f"shard {shard!r} already in the ring")
        if region not in self._inner:
            self._inner[region] = ShardMap(vnodes=self.vnodes)
            for v in range(self.region_vnodes):
                self._outer.append(
                    (_h64(f"region:{region}#{v}".encode()), region))
            self._outer.sort()
        self._inner[region].add(shard)
        self._region_of[shard] = region

    def remove(self, shard: str) -> None:
        region = self._region_of.pop(shard)
        self._inner[region].remove(shard)
        if not len(self._inner[region]):
            # an empty region must leave the outer ring too, or its arc
            # would route keys into a ring with no owner
            del self._inner[region]
            self._outer = [(h, r) for h, r in self._outer if r != region]

    def _region_for(self, h: int) -> str:
        i = bisect.bisect_right(self._outer, (h, "￿"))
        if i == len(self._outer):
            i = 0
        return self._outer[i][1]

    def owner(self, instance_id: int) -> str:
        """Two hash hops: the key's outer arc names the region, the
        region's inner ring names the shard."""
        if not self._outer:
            raise ValueError("empty shard ring")
        h = _h64(int(instance_id).to_bytes(8, "big"))
        return self._inner[self._region_for(h)].owner(instance_id)

    def owner_key(self, key: bytes) -> str:
        if not self._outer:
            raise ValueError("empty shard ring")
        h = _h64(bytes(key))
        return self._inner[self._region_for(h)].owner_key(key)


@dataclasses.dataclass
class _InFlight:
    """One proposed-but-unresolved instance in the router."""

    inst: int
    payload: bytes              # encoded client value (re-sent verbatim)
    shard: str
    t_first: float              # latency is measured from the FIRST send
    t_last: float               # last (re)propose — paces the catch-up
    retries: int = 0            # NACK-scheduled re-proposes so far
    reproposals: int = 0        # timer-scheduled catch-up re-sends
    next_retry: float = 0.0     # 0 = not in backoff
    txn: bool = False           # ship under FLAG_TXN (kv transactions)
    tenant: int = 0             # rides Tag.call_stack on the client verbs
    # DISTINCT (shard, replica) pairs that answered FLAG_TOO_LATE: the
    # instance resolves undecided only when every replica of its
    # CURRENT shard said so — a single undecided replica re-answering
    # successive re-proposes must not outvote a sibling that decides
    # (and a migration implicitly resets the tally: old-shard entries
    # no longer match)
    too_late_from: set = dataclasses.field(default_factory=set)


class FleetRouter:
    """The fleet front door: one client-side transport link per shard,
    a consistent-hash ring over the shard names, and the
    propose/subscribe/NACK-retry state machine (module docstring).

    Single-threaded by design — the caller (loadgen, apps/fleet.py)
    drives ``pump()`` as its event loop, exactly as the lane driver's
    tick loop drives its transport.  ``transport_factory(client_id)``
    exists for tests; the default builds a real HostTransport per
    shard."""

    def __init__(self, *, proto: str = "tcp",
                 nack_backoff_ms: float = 25.0,
                 nack_backoff_cap_ms: float = 1000.0,
                 give_up: int = 12,
                 repropose_ms: float = 2000.0,
                 repropose_cap_ms: float = 30_000.0,
                 max_reproposals: int = 30,
                 transport_factory: Optional[Callable] = None):
        self.proto = proto
        self.nack_backoff_ms = nack_backoff_ms
        self.nack_backoff_cap_ms = nack_backoff_cap_ms
        self.give_up = give_up
        self.repropose_ms = repropose_ms
        self.repropose_cap_ms = repropose_cap_ms
        self.max_reproposals = max_reproposals
        self._transport_factory = transport_factory
        # region → shard two-level ring: one flat region unless
        # ``add_shard(..., region=)`` says otherwise (placement is then
        # byte-identical to the old flat ShardMap)
        self.ring = TwoLevelRing()
        self._links: Dict[str, Any] = {}       # shard -> transport
        self._link_n: Dict[str, int] = {}      # shard -> group size
        self._inflight: Dict[int, _InFlight] = {}
        self.results: Dict[int, Optional[int]] = {}
        self.errors: Dict[int, str] = {}
        self.latency_ms: Dict[int, float] = {}
        self.decide_t: Dict[int, float] = {}
        self.proposals = 0       # lifetime count (the supervisor's
        self.nack_retries = 0    # offered-rate signal reads its deltas)
        self.give_ups = 0
        self.dup_decisions = 0
        self.migrations = 0
        self.reproposals = 0
        # per-tenant attribution (docs/SERVING.md "per-tenant
        # admission"): which tenant proposed each instance, and the
        # NACK/give-up tallies the isolation pin + loadgen report read
        self.tenant_of: Dict[int, int] = {}
        self.tenant_nacks: Dict[int, int] = {}
        self.tenant_give_ups: Dict[int, int] = {}
        # per-shard health counters (docs/SERVING.md "shard rv status"):
        # an rv-halted shard drains as a TOO_LATE burst + undecided
        # resolutions, which is how the router — which never sees the
        # shard's process — observes runtime-verification trouble
        self.shard_health: Dict[str, Dict[str, int]] = {}
        # the kv read verb (round_tpu/kv): FLAG_READ frames and the
        # NACKs of shed reads route to whoever registered here (the
        # KVClient); the router stays kv-agnostic otherwise
        self.on_read_reply: Optional[Callable] = None
        self.on_read_nack: Optional[Callable] = None

    # -- shard membership --------------------------------------------------

    def _make_link(self, replicas: List[Tuple[str, int]]):
        n = len(replicas)
        if self._transport_factory is not None:
            tr = self._transport_factory(n)
        else:
            from round_tpu_torch.runtime.transport import HostTransport

            tr = HostTransport(n, 0, proto=self.proto)
        for j, (host, port) in enumerate(replicas):
            tr.add_peer(j, host, port)
        return tr

    def add_shard(self, name: str, replicas: List[Tuple[str, int]],
                  region: str = "r0") -> None:
        """Join one shard (a DriverServer's replica address list) under a
        STABLE name and claim its arc of ``region``'s inner ring.
        In-flight instances stay with their current shard (their
        decision stream is live) — only NEW proposals land on the new
        arcs, and only keys inside ``region`` can move at all (the
        two-level ring's locality guarantee)."""
        self.ring.add(name, region=region)
        self._links[name] = self._make_link(replicas)
        self._link_n[name] = len(replicas)
        _G_SHARDS.set(len(self.ring))
        _C_REBALANCES.inc()
        if TRACE.enabled:
            TRACE.emit("fleet_rebalance", node=None, op="add", shard=name,
                       region=region, shards=len(self.ring))

    def remove_shard(self, name: str) -> int:
        """Drop one shard from the ring and MIGRATE its unresolved
        instances: each is re-proposed to its new ring owner — the
        idempotent-PROPOSE catch-up makes the move exact (a new owner
        that already served the instance answers from its decision
        bank; one that never saw it runs it).  Returns the number of
        migrated instances."""
        self.ring.remove(name)
        link = self._links.pop(name, None)
        self._link_n.pop(name, None)
        if link is not None:
            link.close()
        _G_SHARDS.set(len(self.ring))
        _C_REBALANCES.inc()
        moved = 0
        for f in list(self._inflight.values()):
            if f.shard != name:
                continue
            if not len(self.ring):
                # the LAST shard left: nowhere to migrate — resolve the
                # instance as an explicit give-up (client-visible),
                # never a half-torn router or silent loss
                self._give_up(f, "last shard removed from the ring")
                continue
            f.shard = self.ring.owner(f.inst)
            f.next_retry = 0.0
            self._send_propose(f)
            moved += 1
        if moved:
            self.migrations += moved
            _C_MIGRATIONS.inc(moved)
        if TRACE.enabled:
            TRACE.emit("fleet_rebalance", node=None, op="remove",
                       shard=name, shards=len(self.ring), migrated=moved)
        self._flush()
        return moved

    def view_observer(self, names_by_pid: Dict[int, str]):
        """Adapt this router to a ViewManager ``add_observer`` slot: the
        fleet's own membership runs through the SAME consensus-decided
        view moves as everything else (runtime/view.py).  ``names_by_pid``
        maps the view's member pids to stable shard names; a member that
        maps to None in the view's renames LEFT the fleet — its shard is
        removed and its in-flight instances migrate.  JOINS are NOT
        inferred here: a renames dict names old pids only, so a freshly
        ADDed member carries no name/address the observer could resolve
        — bringing a new shard up is an operator action (deploy the
        DriverServer, then ``add_shard(name, addrs)``), and only then
        does the ring hand it keys."""
        def on_change(renames: Dict[int, Optional[int]], n: int) -> None:
            next_names: Dict[int, str] = {}
            for old_pid, new_pid in renames.items():
                name = names_by_pid.get(old_pid)
                if name is None:
                    continue
                if new_pid is None:
                    if name in self._links:
                        self.remove_shard(name)
                else:
                    next_names[new_pid] = name
            names_by_pid.clear()
            names_by_pid.update(next_names)

        return on_change

    # -- the client protocol ----------------------------------------------

    def _encode_value(self, value) -> bytes:
        arr = np.asarray(value)
        if arr.ndim == 0 and arr.dtype.kind in "iu":
            arr = arr.astype(np.int32)
        return codec.encode(arr)

    def propose(self, instance_id: int, value, *,
                shard: Optional[str] = None, txn: bool = False,
                tenant: int = 0) -> None:
        """Route one instance to its ring owner and ship the proposal to
        every replica of that shard (coalesced; ``pump``/``flush`` ships
        the wave).  ``value`` is the client's initial value — a scalar
        for the int-domain protocols, a uint8[B] vector for the byte-
        payload workload.  ``shard`` overrides the ring placement (the
        kv data plane routes by KEY via ``ring.owner_key``, so every
        write of a key shares one decision stream); ``txn`` ships the
        proposal under FLAG_TXN — same state machine, but the shard
        validates the payload as a kv transaction record; ``tenant``
        (0-255) namespaces the instance under per-tenant weighted-fair
        admission — it rides the otherwise-free Tag.call_stack byte on
        every (re)propose, zero wire-format change."""
        inst = int(instance_id)
        if not MIN_INSTANCE <= inst <= MAX_FLEET_INSTANCE:
            raise ValueError(
                f"instance id {inst} outside the serveable range "
                f"[{MIN_INSTANCE}, {MAX_FLEET_INSTANCE}]")
        if not 0 <= int(tenant) <= 0xFF:
            raise ValueError(f"tenant id {tenant} outside [0, 255]")
        if inst in self._inflight or inst in self.results:
            raise ValueError(f"instance {inst} already proposed")
        if shard is not None and shard not in self._links:
            raise ValueError(f"unknown shard {shard!r}")
        now = _time.monotonic()
        f = _InFlight(inst=inst, payload=self._encode_value(value),
                      shard=shard if shard is not None
                      else self.ring.owner(inst),
                      t_first=now, t_last=now, txn=txn,
                      tenant=int(tenant))
        self._inflight[inst] = f
        self.proposals += 1
        if f.tenant:
            self.tenant_of[inst] = f.tenant
        _C_PROPOSALS.inc()
        _G_INFLIGHT.set(len(self._inflight))
        self._send_propose(f)
        if TRACE.enabled:
            TRACE.emit("fleet_propose", node=None, inst=inst,
                       shard=f.shard)

    def _send_propose(self, f: _InFlight) -> None:
        link = self._links.get(f.shard)
        if link is None:
            return  # shard gone mid-flight; rebalance re-routes it
        tag = Tag(instance=f.inst & 0xFFFF,
                  flag=FLAG_TXN if f.txn else FLAG_PROPOSE,
                  call_stack=f.tenant)
        sendb = getattr(link, "send_buffered", None)
        for j in range(self._link_n[f.shard]):
            if sendb is not None:
                sendb(j, tag, f.payload)
            else:
                link.send(j, tag, f.payload)
        f.t_last = _time.monotonic()

    def shard_n(self, shard: str) -> int:
        """Replica count of one shard (the kv client's majority rule)."""
        return self._link_n[shard]

    def send_read(self, shard: str, replica: int, rid: int,
                  payload: bytes, tenant: int = 0) -> bool:
        """Ship one FLAG_READ frame to a single replica of ``shard``
        (round_tpu/kv three-grade reads) and flush immediately — read
        latency is the product here, so reads never wait for the next
        proposal wave's coalesce.  ``tenant`` rides Tag.call_stack so
        linearizable reads meter against the tenant's share too."""
        from round_tpu_torch.kv.reads import read_tag

        link = self._links.get(shard)
        if link is None:
            return False
        tag = dataclasses.replace(read_tag(rid),
                                  call_stack=int(tenant) & 0xFF)
        sendb = getattr(link, "send_buffered", None)
        if sendb is not None:
            sendb(replica, tag, payload)
            fl = getattr(link, "flush", None)
            if fl is not None:
                fl()
        else:
            link.send(replica, tag, payload)
        return True

    def subscribe(self, shard: Optional[str] = None) -> None:
        """Ask ``shard`` (default: all) to stream EVERY decision it
        completes to this router, not just the ones it proposed."""
        for name in ([shard] if shard else list(self._links)):
            link = self._links[name]
            for j in range(self._link_n[name]):
                link.send(j, Tag(instance=0, flag=FLAG_SUBSCRIBE))

    def _flush(self) -> None:
        for link in self._links.values():
            fl = getattr(link, "flush", None)
            if fl is not None:
                fl()

    def _resolve(self, inst: int, value: Optional[int],
                 latency_anchor: Optional[float]) -> None:
        f = self._inflight.pop(inst, None)
        if f is None:
            return
        self.results[inst] = value
        now = _time.monotonic()
        self.decide_t[inst] = now
        if latency_anchor is not None:
            ms = (now - latency_anchor) * 1000.0
            self.latency_ms[inst] = ms
            _H_DECIDE_MS.observe(ms)
        _G_INFLIGHT.set(len(self._inflight))

    def _on_frame(self, shard: str, got) -> None:
        sender, tag, raw = got
        inst = tag.instance
        if tag.flag == FLAG_READ:
            # a kv read reply (the payload carries the full read id);
            # routed whole to the registered client, never resolved here
            if self.on_read_reply is not None:
                self.on_read_reply(shard, sender, tag, raw)
            return
        if tag.flag == FLAG_DECISION:
            if inst not in self._inflight:
                if inst in self.results:
                    self.dup_decisions += 1
                    _C_DUPS.inc()
                return
            try:
                value = codec.loads(bytes(raw))
            except Exception:  # noqa: BLE001 — a garbled decision frame
                return         # is dropped; the catch-up re-asks
            from round_tpu_torch.runtime.host import decision_scalar

            f = self._inflight[inst]
            self._resolve(inst, decision_scalar(value), f.t_first)
            _C_DECISIONS.inc()
            if TRACE.enabled:
                TRACE.emit("fleet_decision", node=None, inst=inst,
                           shard=shard, src=sender)
            return
        if tag.flag == FLAG_NACK:
            f = self._inflight.get(inst)
            if f is None:
                # not a write of ours: a SHED READ NACKs back with the
                # 16-bit read id in Tag.instance (kv/reads.py read_tag) —
                # hand it to the kv client's retry machinery.  The id
                # spaces can collide in their low 16 bits; an in-flight
                # write always wins the ambiguity (reads self-heal on
                # their own retry timer regardless)
                if self.on_read_nack is not None:
                    self.on_read_nack(shard, inst)
                return
            _C_NACKS.inc()
            if f.tenant:
                self.tenant_nacks[f.tenant] = \
                    self.tenant_nacks.get(f.tenant, 0) + 1
            if TRACE.enabled:
                TRACE.emit("fleet_nack", node=None, inst=inst,
                           shard=shard, src=sender)
            self.shard_health.setdefault(
                shard, {"too_late": 0, "nacks": 0, "undecided": 0}
            )["nacks"] += 1
            if f.next_retry > 0:
                return  # already backing off; one NACK per window counts
            if f.retries >= self.give_up:
                self._give_up(f, "NACKed past the retry cap")
                return
            backoff = min(self.nack_backoff_ms * (2.0 ** f.retries),
                          self.nack_backoff_cap_ms)
            f.retries += 1
            self.nack_retries += 1
            _C_RETRIES.inc()
            f.next_retry = _time.monotonic() + backoff / 1000.0
            return
        if tag.flag == FLAG_TOO_LATE:
            # this replica finished the instance UNDECIDED (or shed it
            # past recovery): keep asking — a sibling replica may still
            # decide — and record the undecided outcome honestly only
            # once EVERY replica of the current shard has said so
            h = self.shard_health.setdefault(
                shard, {"too_late": 0, "nacks": 0, "undecided": 0})
            h["too_late"] += 1
            f = self._inflight.get(inst)
            if f is None:
                return
            f.too_late_from.add((shard, sender))
            n_shard = self._link_n.get(f.shard, 1)
            if sum(1 for s, _r in f.too_late_from
                   if s == f.shard) >= n_shard:
                self._resolve(inst, None, None)
                _C_UNDECIDED.inc()
                h["undecided"] += 1
            return

    def _give_up(self, f: _InFlight, why: str) -> None:
        log.warning("fleet: giving up on instance %d (shard %s): %s "
                    "(%d retries, %d reproposals)", f.inst, f.shard, why,
                    f.retries, f.reproposals)
        self._inflight.pop(f.inst, None)
        self.results[f.inst] = None
        self.errors[f.inst] = why
        self.give_ups += 1
        if f.tenant:
            self.tenant_give_ups[f.tenant] = \
                self.tenant_give_ups.get(f.tenant, 0) + 1
        _C_GIVE_UPS.inc()
        _G_INFLIGHT.set(len(self._inflight))
        if TRACE.enabled:
            TRACE.emit("fleet_give_up", node=None, inst=f.inst,
                       shard=f.shard, retries=f.retries,
                       reproposals=f.reproposals)

    def pump(self, timeout_ms: int = 50) -> int:
        """ONE router wave: drain every shard link, fire due NACK-retries
        and re-propose timers, flush the coalesced proposals.  Returns
        the number of frames handled — the caller's idle signal."""
        handled = 0
        now = _time.monotonic()
        per_link = max(0, timeout_ms) // max(1, len(self._links)) \
            if self._links else 0
        for name, link in list(self._links.items()):
            rm = getattr(link, "recv_many", None)
            if rm is not None:
                got_list = rm(int(per_link))
            else:
                got = link.recv(int(per_link))
                got_list = [got] if got is not None else []
            for got in got_list:
                self._on_frame(name, got)
            handled += len(got_list)
        # timers: NACK backoff expiries re-propose; silent instances past
        # repropose_ms re-ask (the decision catch-up — a lost PROPOSE,
        # a lost DECISION and a shed frame all heal through this)
        for f in list(self._inflight.values()):
            if f.next_retry > 0 and now >= f.next_retry:
                f.next_retry = 0.0
                self._send_propose(f)
            elif f.next_retry == 0 \
                    and (now - f.t_last) * 1000.0 >= min(
                        self.repropose_ms * (1.5 ** f.reproposals),
                        self.repropose_cap_ms):
                # EXPONENTIAL catch-up pacing: under a deep backlog (a
                # saturation blast queues thousands behind lanes), a
                # fixed-period re-ask floods the shards with wire noise
                # proportional to queue depth — and worse, exhausts the
                # give-up budget on instances that are QUEUED, not
                # lost.  Backed-off re-asks make the budget span ~10+
                # minutes while a genuinely lost frame still heals in
                # one repropose_ms
                if f.reproposals >= self.max_reproposals:
                    self._give_up(f, "unanswered past the re-propose cap")
                    continue
                f.reproposals += 1
                self.reproposals += 1
                _C_REPROPOSE.inc()
                self._send_propose(f)
        self._flush()
        return handled

    def status(self) -> Dict[str, Any]:
        """The router's shard-status surface (docs/SERVING.md "shard rv
        status"): per-shard health counters beside the fleet totals.  A
        shard whose driver rv-halted shows as a too_late burst with
        undecided resolutions — the router's view of a runtime-
        verification stop it cannot observe directly."""
        return {
            "shards": {name: dict(self.shard_health.get(
                name, {"too_late": 0, "nacks": 0, "undecided": 0}))
                for name in self.ring.shards},
            "inflight": len(self._inflight),
            "decided": sum(1 for v in self.results.values()
                           if v is not None),
            "undecided": sum(1 for v in self.results.values()
                             if v is None),
            "give_ups": self.give_ups,
            "nack_retries": self.nack_retries,
            "reproposals": self.reproposals,
            "migrations": self.migrations,
            "regions": {r: [s for s in self.ring.shards
                            if self.ring.region_of(s) == r]
                        for r in self.ring.regions},
            "tenant_nacks": dict(self.tenant_nacks),
            "tenant_give_ups": dict(self.tenant_give_ups),
        }

    def raise_if_gave_up(self) -> None:
        """Surface give-ups as the client-visible error (docs/SERVING.md
        NACK-retry contract): silent loss is never an outcome."""
        if self.give_ups:
            worst = sorted(self.errors.items())[:5]
            raise FleetGiveUp(
                f"{self.give_ups} instance(s) exhausted their retry "
                f"budget; first failures: {worst}")

    def drain(self, deadline_s: float, idle_ms: float = 0.0,
              stop: Optional[Callable[[], bool]] = None) -> bool:
        """Pump until every in-flight instance resolves (True), the
        deadline passes, or — with ``idle_ms`` > 0 — nothing has been
        heard from any shard for that long.  The loadgen interleaves
        its own arrivals with pump() instead of using this."""
        t_end = _time.monotonic() + deadline_s
        last_heard = _time.monotonic()
        while self._inflight and _time.monotonic() < t_end:
            if stop is not None and stop():
                return False
            if self.pump(50) > 0:
                last_heard = _time.monotonic()
            elif idle_ms > 0 and (_time.monotonic() - last_heard) \
                    * 1000.0 >= idle_ms:
                return False
        return not self._inflight

    def close(self) -> None:
        for link in self._links.values():
            try:
                link.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._links.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class DriverServer:
    """One fleet shard: n replica threads, each a client-serving
    LaneDriver over its own HostTransport (the in-process consensus
    group of host_perftest.measure, grown the fleet client surface),
    every replica's lane state on ``device``.  The client id every
    replica accepts is ``n`` — the id space right above the group, where
    the router's transports live (round_tpu/runtime/fleet.py::
    DriverServer).  ``rv`` (an rv.dump.RvConfig) is the runtime
    verification and ``snap`` (a snap.audit.SnapConfig) the snapshot
    audit every replica serves under, and ``kv`` (a kv.store.KvConfig)
    makes every replica a member of a replicated key-value shard."""

    def __init__(self, algo, n: int = 3, lanes: int = 16,
                 timeout_ms: int = 300, seed: int = 0,
                 max_rounds: int = 32, proto: str = "tcp",
                 idle_ms: int = 8000, max_ms: int = 600_000,
                 use_pump: bool = True,
                 admission_bytes_per_lane: int = 0,
                 shed_deadline_ms: int = 250,
                 adaptive_cap_ms: int = 0,
                 ports: Optional[List[int]] = None,
                 rv=None, snap=None, kv=None,
                 tenants: Optional[Dict[int, float]] = None,
                 tenant_bytes_per_lane: int = 64 << 10,
                 device=None):
        from round_tpu_torch.runtime.chaos import alloc_ports
        from round_tpu_torch.runtime.transport import HostTransport
        from round_tpu_torch.utils.device import resolve_device

        self.device = resolve_device(device)
        # runtime verification: the RvConfig the shard's lane drivers
        # serve under; a 'halt' surfaces through errors/join() and the
        # router's too_late drain
        self.rv = rv
        # snapshots: ONE shared config, so cfg.collector names the
        # replica that assembles and audits the shard's cuts
        self.snap = snap
        # replicated key-value serving (kv/): a kv.store.KvConfig turns
        # every replica into a KV shard member — decisions apply to a
        # per-replica KVState, FLAG_READ serves the three grades,
        # FLAG_TXN validates transaction records (docs/KV.md)
        self.kv = kv
        self.algo = algo
        self.n = n
        self.lanes = lanes
        self.timeout_ms = timeout_ms
        self.seed = seed
        self.max_rounds = max_rounds
        self.idle_ms = idle_ms
        self.max_ms = max_ms
        self.use_pump = use_pump
        self.admission_bytes_per_lane = admission_bytes_per_lane
        self.shed_deadline_ms = shed_deadline_ms
        self.adaptive_cap_ms = adaptive_cap_ms
        # per-tenant weighted-fair admission (runtime/instances.py
        # TenantAdmission, docs/SERVING.md): tenant id -> weight; every
        # replica meters its client intake per tenant so a hot tenant
        # sheds against its own share.  None = the tenant-blind shard.
        self.tenants = dict(tenants) if tenants else None
        self.tenant_bytes_per_lane = tenant_bytes_per_lane
        if ports is None:
            ports = alloc_ports(n)
        elif len(ports) != n:
            raise ValueError(f"{len(ports)} ports for n={n} replicas")
        self.replicas = [("127.0.0.1", p) for p in ports]
        self._transports = [HostTransport(i, ports[i], proto=proto)
                            for i in range(n)]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.results: List[Dict[int, Optional[int]]] = [{} for _ in
                                                        range(n)]
        self.stats: List[Dict[str, Any]] = [{} for _ in range(n)]
        self.errors: Dict[int, BaseException] = {}
        # each replica's kv.store.KVShard once it serves (the port keeps
        # them: a caller can read every replica's store after the run)
        self.kv_shards: List[Any] = [None] * n

    def _run_replica(self, i: int) -> None:
        from round_tpu_torch.runtime.instances import (AdmissionControl,
                                                       TenantAdmission)
        from round_tpu_torch.runtime.lanes import LaneDriver

        peers = {j: self.replicas[j] for j in range(self.n)}
        admission = None
        if self.admission_bytes_per_lane > 0:
            admission = AdmissionControl(
                high_bytes_per_lane=self.admission_bytes_per_lane,
                shed_deadline_ms=self.shed_deadline_ms)
        tenant_admission = None
        if self.tenants is not None:
            tenant_admission = TenantAdmission(
                bytes_per_lane=self.tenant_bytes_per_lane,
                weights=self.tenants,
                shed_deadline_ms=self.shed_deadline_ms)
        adaptive = None
        if self.adaptive_cap_ms > 0:
            # the deployed serving posture: EWMA
            # deadlines track the box's real round latency, so a loaded
            # fleet stretches its deadlines instead of failing phases
            from round_tpu_torch.runtime.host import AdaptiveTimeout

            adaptive = AdaptiveTimeout(cap_ms=self.adaptive_cap_ms,
                                       seed=self.seed * 31 + i)
        kv_shard = None
        if self.kv is not None:
            from round_tpu_torch.kv.store import KVShard

            kv_shard = self.kv_shards[i] = KVShard(
                self.kv, node=i, n=self.n, timeout_ms=self.timeout_ms)
        try:
            driver = LaneDriver(
                self.algo, i, peers, self._transports[i],
                lanes=self.lanes, timeout_ms=self.timeout_ms,
                seed=self.seed, max_rounds=self.max_rounds,
                value_schedule="uniform", use_pump=self.use_pump,
                admission=admission, adaptive=adaptive,
                clients={self.n}, rv=self.rv, snap=self.snap,
                kv=kv_shard, tenants=tenant_admission,
                device=self.device,
            )
            self.results[i] = driver.serve(
                idle_ms=self.idle_ms, max_ms=self.max_ms,
                stop=self._stop.is_set, stats_out=self.stats[i])
        except Exception as e:  # noqa: BLE001 — surfaced by join()
            self.errors[i] = e
            raise

    def rv_summary(self) -> Dict[str, Any]:
        """Aggregate rv status across this shard's replicas
        (round_tpu/runtime/fleet.py::DriverServer.rv_summary)."""
        viols = [v for st in self.stats
                 for v in st.get("rv_violations", [])]
        return {
            "enabled": self.rv is not None,
            "checks": sum(st.get("rv_checks", 0) for st in self.stats),
            "violations": viols,
            "artifacts": sorted({a for st in self.stats
                                 for a in st.get("rv_artifacts", [])}),
            "halted": sorted(
                i for i, e in self.errors.items()
                if type(e).__name__ == "RvViolation"),
        }

    def kv_summary(self) -> Dict[str, Any]:
        """Aggregate kv status across this shard's replicas
        (round_tpu/runtime/fleet.py::DriverServer.kv_summary)."""
        out: Dict[str, Any] = {"enabled": self.kv is not None}
        for k in ("applied", "reads_lin", "reads_lease", "reads_stale",
                  "lease_refused", "lease_barrier", "lease_grants",
                  "txn_frames", "txn_commits", "txn_aborts"):
            out[k] = sum(st.get("kv_" + k, 0) for st in self.stats)
        return out

    def snap_summary(self) -> Dict[str, Any]:
        """Aggregate snapshot status across this shard's replicas
        (round_tpu/runtime/fleet.py::DriverServer.snap_summary)."""
        return {
            "enabled": self.snap is not None,
            "samples": sum(st.get("snap_samples", 0)
                           for st in self.stats),
            "cuts": sum(st.get("snap_cuts", 0) for st in self.stats),
            "cuts_audited": sum(st.get("snap_cuts_audited", 0)
                                for st in self.stats),
            "partial_cuts": sum(st.get("snap_partial_cuts", 0)
                                for st in self.stats),
            "violations": [v for st in self.stats
                           for v in st.get("snap_violations", [])],
            "divergences": [d for st in self.stats
                            for d in st.get("snap_divergences", [])],
            "artifacts": sorted({a for st in self.stats
                                 for a in st.get("snap_artifacts", [])}),
            "halted": sorted(
                i for i, e in self.errors.items()
                if type(e).__name__ == "SnapViolation"),
        }

    def tenant_summary(self) -> Dict[str, Any]:
        """Aggregate per-tenant shed accounting across this shard's
        replicas (the fleet-autoscale soak rung gates shed_frames ==
        nacks_sent + nacks_suppressed per tenant over exactly this)."""
        by_tenant: Dict[int, Dict[str, int]] = {}
        for st in self.stats:
            for t, d in st.get("tenants", {}).items():
                agg = by_tenant.setdefault(int(t), {})
                for k, v in d.items():
                    agg[k] = agg.get(k, 0) + v
        return {"enabled": self.tenants is not None,
                "weights": dict(self.tenants or {}),
                "by_tenant": by_tenant}

    def start(self) -> List[Tuple[str, int]]:
        for i in range(self.n):
            t = threading.Thread(target=self._run_replica, args=(i,),
                                 name=f"fleet-replica-{i}", daemon=True)
            self._threads.append(t)
            t.start()
        return self.replicas

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout_s: float = 120.0) -> None:
        t_end = _time.monotonic() + timeout_s
        for t in self._threads:
            t.join(timeout=max(0.1, t_end - _time.monotonic()))
        alive = [t.name for t in self._threads if t.is_alive()]
        for tr in self._transports:
            try:
                tr.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        if self.errors:
            raise RuntimeError(f"fleet replicas failed: {self.errors}")
        if alive:
            raise RuntimeError(f"fleet replicas wedged: {alive}")

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        try:
            self.join()
        except RuntimeError:
            if exc[0] is None:
                raise
