"""Host multi-process round execution: one OS process per replica.

This is the deployment shape of the reference — n JVMs, one per ProcessID,
full TCP mesh, the InstanceHandler loop driving init → send → accumulate →
update per round (InstanceHandler.scala:164-258) — rebuilt on the native
transport (native/transport.cpp via runtime/transport.py).

The SAME algorithm classes the engines run (core/algorithm.py Round
DSL) run here unchanged: their send/update are per-lane pure functions, so
one process evaluates them for its own lane while the simulator vmaps
them over [scenario, lane] axes.  That is the framework's deployment
story: simulate at scale, deploy the identical protocol code
process-per-replica.

Round discipline (benign model, full Progress semantics —
InstanceHandler.scala:164-353):
  * send: evaluate SendSpec, unicast payload bytes per selected dest
    (self-delivery short-circuits the wire, Round.scala:114-117);
  * accumulate: honor the round's Progress policy (core/progress.py):
      - Timeout(ms): block until goAhead or the deadline; STRICT additionally
        refuses round-skew catch-up until the deadline;
      - WaitForMessage: no deadline — only goAhead (or, non-strict,
        catch-up) ends the round;
      - Sync(k): block until k processes are observed at >= this round
        (the benign form of the byzantine synchronizer barrier,
        InstanceHandler.scala:277-287);
      - GoAhead: the round ends after delivering pending messages.
    goAhead = expected_nbr_messages reached (plain rounds,
    Round.scala:60-66) or the per-receive go_ahead probe (FoldRound) —
    the fine-grained control LastVotingEvent uses;
  * benign catch-up (InstanceHandler.scala:289-301): the max round observed
    from any peer pulls this replica forward — skewed rounds fast-forward
    one at a time (send, deliver pending, update with didTimeout) without
    burning their timeouts;
  * early messages for future rounds are buffered, late ones dropped
    (the pendingMessages priority queue role, InstanceHandler.scala:68-72);
  * update: fold the mailbox; `exitAtEndOfRound` ends the run.

Deviation from the reference: a WaitForMessage/Sync round that makes no
progress for `wait_cap_ms` (default 30 s) is force-timed-out with a warning
— the reference blocks forever (buffer.take()), which an unattended
deployment of THIS framework must not.

Payloads cross the wire in the binary codec (runtime/codec.py — the Kryo
registered-class-codec role; same trust model as the reference: replicas
deserialize only from their own group, and the tagged pickle fallback
stays behind the restricted unpickler).  The send path encodes ONCE per
round into a pooled scratch, coalesces per-destination frames into
FLAG_BATCH containers flushed at the round boundary, and the receive
path drains every queued frame in one native call; the mailbox is
assembled IN PLACE into preallocated [n, ...] arrays (_RoundMailbox).
``HostRunner(wire="pickle")`` keeps the seed path alive as the A/B
baseline (apps/perf_ab.py).

Port of round_tpu/runtime/host.py.  A replica's round runs on ``device``
(the card unless the caller passes another; where the card is asked for
and absent the runner raises, it never carries on on the CPU): the state
lives there, and send, update and the go probe are the port's general-
engine functions on one lane (engine/executor.py::make_host_round_fns).
What crosses between host and device, per replica per round: ONE
device-to-host copy holding the round's payload, its destination mask and
the previous round's exit flag (the next round's send is issued right
after the update, so its payload rides with the flag; a send is pure, and
its result is dropped when the flag ends the run), and ONE host-to-device
copy of the assembled ``_RoundMailbox``.  A FoldRound's go probe costs a
copy each way per probe.  Differences from round_tpu, none of them on
the wire:
  * no compile step: the (send, update, go) functions are cached per
    round object under a lock (thread-mode replicas share them), with no
    warm-up;
  * the payload layout of the native pump comes from one call of the
    round's send on the initial state, not ``jax.eval_shape``;
  * the round's rng word is the general engine's (see
    make_host_round_fns), not round_tpu's threefry fold-in;
  * pytrees flatten as JAX's do (dict keys sorted, None an empty node),
    so a payload's leaf order and its wire bytes are round_tpu's;
  * runtime verification (``rv``): the round's decided flag and
    decision ride the round's one device-to-host copy with its exit
    flag, and the numpy twin of the lane monitor term checks them
    (rv/compile.py HostRv); a FLAG_DECISION heard mid-instance is
    checked before adoption with one more copy (a cold path);
  * snapshots (``snap``): on a round the sampling policy picks, the
    state's leaves ride the same copy as the exit flag; FLAG_SNAP frames
    reach the collector from both pumps.
"""

from __future__ import annotations

import collections
import dataclasses
import pickle
import queue as _queue
import threading
import time as _time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.progress import Progress
from round_tpu_torch.core.rounds import Round, RoundCtx
from round_tpu_torch.obs.metrics import METRICS, MS_BUCKETS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime import codec
from round_tpu_torch.runtime.log import get_logger
from round_tpu_torch.runtime.oob import (
    FLAG_DECISION, FLAG_NACK, FLAG_NORMAL, FLAG_SNAP, FLAG_VIEW, Message,
    Tag,
)
from round_tpu_torch.runtime.transport import HostTransport, RoundPump
from round_tpu_torch.utils.device import resolve_device

log = get_logger("host")

# unified metrics (obs/metrics.py; names in docs/OBSERVABILITY.md).  The
# instruments are module-level so the per-event cost is one lock-guarded
# add — no registry lookup on the hot path.
_C_ROUNDS = METRICS.counter("host.rounds")
_C_TIMEOUTS = METRICS.counter("host.timeouts")
_C_SENDS = METRICS.counter("host.sends")
_C_RECVS = METRICS.counter("host.recvs")
_C_MALFORMED = METRICS.counter("host.malformed")
_C_DECISIONS = METRICS.counter("host.decisions")
_C_OOB = METRICS.counter("host.oob_decisions")
_C_REPLIES = METRICS.counter("host.decision_replies")
_C_CATCHUP = METRICS.counter("host.catch_ups")
# overload vocabulary shared with runtime/lanes.py (same name = same
# instrument): NACKs observed from overloaded peers — purely diagnostic,
# the protocol's own retransmission is the retry
_C_NACKS_SEEN = METRICS.counter("overload.nacks_seen")
_H_ROUND_MS = METRICS.histogram("host.round_ms", MS_BUCKETS, unit="ms")
_G_DEADLINE = METRICS.gauge("host.deadline_ms")
_C_MUX_ROUTED = METRICS.counter("mux.routed")
_C_MUX_STASHED = METRICS.counter("mux.stashed")

# serializes round-function builds so thread-mode replicas sharing an
# Algorithm build each round class's trio once (see HostRunner._round_fns)
_ROUND_FNS_LOCK = threading.Lock()
# host-device traffic of the host runner, per copy (the port's own
# counters: round_tpu's replicas run on the host and copy nothing)
_C_D2H = METRICS.counter("host.d2h_copies")
_C_H2D = METRICS.counter("host.h2d_copies")

# queue sentinel broadcast by InstanceMux._loop when the router thread
# dies: endpoints must RAISE, not starve into round timeouts (ADVICE.md
# round-5 finding)
_ROUTER_DOWN = object()


# -- pytrees as JAX flattens them --------------------------------------------

_LEAF = object()  # the leaf marker of a _flatten treedef


def _flatten(tree) -> Tuple[list, Any]:
    """(leaves, treedef) in ``jax.tree_util.tree_flatten``'s order for
    wire payloads: dicts by sorted key, tuples and lists in order, None an
    empty node (torch's pytree keeps dict insertion order and takes None
    for a leaf, which would change a payload's leaf count and its bytes).
    The treedef is the tree with every leaf replaced by a marker, so two
    treedefs compare with ``==``."""
    leaves: list = []

    def walk(o):
        if o is None:
            return None
        if type(o) is dict:
            return {k: walk(o[k]) for k in sorted(o)}
        if type(o) in (tuple, list):
            return type(o)(walk(x) for x in o)
        leaves.append(o)
        return _LEAF

    return leaves, walk(tree)


def _unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def walk(t):
        if t is _LEAF:
            return next(it)
        if type(t) is dict:
            return {k: walk(v) for k, v in t.items()}
        if type(t) in (tuple, list):
            return type(t)(walk(x) for x in t)
        return t

    return walk(treedef)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype; bfloat16 is ml_dtypes' (as a jax
    array's is), and without ml_dtypes a bf16 leaf has no numpy form:
    TypeError, never a silent cast."""
    if dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            raise TypeError("a bfloat16 payload has no numpy dtype without "
                            "ml_dtypes") from None
        return np.dtype(ml_dtypes.bfloat16)
    return torch.empty((), dtype=dtype).numpy().dtype


def to_numpy(tree) -> Any:
    """A pytree of tensors as numpy leaves, in ONE device-to-host copy
    (the device leaves' bytes joined by one ``cat`` on the device), with
    dicts rebuilt in sorted key order: what round_tpu's
    ``tree_map(np.asarray, payload)`` gives for the same values, so the
    codec writes round_tpu's bytes.  Leaves already on the host (a CPU
    tensor, a Python or numpy scalar) are copied there, never moved."""
    leaves, treedef = _flatten(tree)
    out = [x if isinstance(x, torch.Tensor) else np.asarray(x)
           for x in leaves]
    for on_host in (True, False):
        idx = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)
               and (x.device.type == "cpu") == on_host]
        if not idx:
            continue
        src = [leaves[i] for i in idx]
        parts = [t.reshape(-1).view(torch.uint8) for t in src]
        # a lone device leaf's copy to the host is the one copy; else the
        # cat is a copy too (no result may alias a live tensor)
        buf = (parts[0] if len(parts) == 1 and not on_host
               else torch.cat(parts))
        if not on_host:
            _C_D2H.inc()
        raw = buf.cpu().numpy()
        at = 0
        for i, t in zip(idx, src):
            dt = _np_dtype(t.dtype)
            nbytes = t.numel() * dt.itemsize
            out[i] = raw[at:at + nbytes].view(dt).reshape(tuple(t.shape))
            at += nbytes
    return _unflatten(treedef, out)


def to_device(tree, device) -> Any:
    """A pytree of numpy leaves as tensors on ``device``, in ONE
    host-to-device copy (the leaves packed into one fresh byte buffer,
    each at a 16-byte aligned offset, so no result aliases the caller's
    arrays, on the CPU either).  bfloat16 leaves (ml_dtypes) come back as
    torch.bfloat16."""
    leaves, treedef = _flatten(tree)
    arrs = [np.asarray(x) for x in leaves]
    if not arrs:
        return tree
    parts = []
    for a in arrs:
        b = a.reshape(-1).view(np.uint8)
        parts.append(b)
        parts.append(np.zeros(-b.size % 16, dtype=np.uint8))
    dev = torch.device(device)
    buf = torch.from_numpy(np.concatenate(parts)).to(dev)
    if dev.type != "cpu":
        _C_H2D.inc()
    out, at = [], 0
    for a in arrs:
        tdt = (torch.bfloat16 if a.dtype.name == "bfloat16"
               else torch.from_numpy(a.reshape(-1)[:0]).dtype)
        out.append(buf[at:at + a.nbytes].view(tdt).reshape(a.shape))
        at += a.nbytes + (-a.nbytes % 16)
    return _unflatten(treedef, out)


@dataclasses.dataclass
class HostResult:
    state: Any
    decided: bool
    decision: Any
    rounds_run: int
    dropped_messages: int
    # wire messages discarded as garbage: undeserializable payloads,
    # out-of-range sender ids, wrong payload structure.  The reference
    # swallows deserialization errors and keeps running when byzantine
    # replicas are configured (InstanceHandler.scala:392-399); this runner
    # ALWAYS tolerates them — one garbage datagram on the unauthenticated
    # socket must never kill a replica.
    malformed_messages: int = 0
    # rounds that ended by deadline expiry rather than goAhead — the
    # throughput diagnostic (every one burns a full round timeout)
    timeouts: int = 0
    # the deadline (ms) each timeout-governed round actually waited on —
    # with an AdaptiveTimeout this is the convergence trajectory (starts
    # at the backoff cap, shrinks toward the observed round latency);
    # with a fixed timeout it is flat
    timeout_trajectory: List[int] = dataclasses.field(default_factory=list)
    # the instance was INTERRUPTED by a view move (runtime/view.py): the
    # ViewManager adopted a newer view (or discovered our removal) while
    # this instance ran over the old wire — the caller re-enters under the
    # new view instead of trusting a decision reached across the boundary
    stale_view: bool = False


class AdaptiveTimeout:
    """EWMA round-latency estimator with exponential backoff, jitter and
    a cap — the adaptive replacement for a fixed `timeout_ms` (the
    reference drives InstanceHandler deadlines from a static
    RuntimeOptions.timeout; an unattended deployment needs the deadline
    to TRACK the wire).

    Discipline:
      * starts at `cap_ms` (pessimistic: a fresh replica knows nothing
        about the wire, and a too-short first deadline burns rounds);
      * every round that completes by goAhead feeds its latency into an
        EWMA; the working deadline converges to `margin` x EWMA, floored
        and capped;
      * every round that EXPIRES backs the deadline off exponentially
        (`backoff` x current, capped) — loss and stalls push it up fast;
      * deterministic seeded jitter (±`jitter` fraction, murmur3 over the
        observation counter) desynchronizes replicas so their deadlines
        do not fire in lockstep.

    One instance may be shared across consecutive/concurrent instances of
    a replica (the host loops do): the estimator models the WIRE, which
    does not reset between consensus instances.  Thread-safety relies on
    the GIL (float stores); races only jitter the estimate."""

    def __init__(self, cap_ms: int = 2000, floor_ms: int = 10,
                 alpha: float = 0.3, margin: float = 3.0,
                 backoff: float = 2.0, jitter: float = 0.1, seed: int = 0):
        if not 0 < alpha <= 1:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if not 0 < floor_ms <= cap_ms:
            raise ValueError(
                f"need 0 < floor_ms <= cap_ms, got {floor_ms}, {cap_ms}")
        self.cap_ms, self.floor_ms = cap_ms, floor_ms
        self.alpha, self.margin = alpha, margin
        self.backoff, self.jitter, self.seed = backoff, jitter, seed
        self._ewma: Optional[float] = None
        self._current = float(cap_ms)
        self._obs = 0

    def current_ms(self) -> int:
        """The deadline to use for the next timeout-governed round."""
        return max(1, int(round(self._current)))

    @property
    def ewma_ms(self) -> Optional[float]:
        return self._ewma

    def observe(self, latency_ms: Optional[float], expired: bool) -> None:
        """Feed one round outcome: its wall latency when it completed by
        goAhead (expired=False), or a deadline expiry (expired=True,
        latency ignored — an expired round's wall time measures the
        deadline, not the wire)."""
        from round_tpu_torch.engine.scenarios import mix32_host

        self._obs += 1
        if expired:
            target = self._current * self.backoff
        else:
            if latency_ms is None:
                return
            self._ewma = (latency_ms if self._ewma is None else
                          self.alpha * latency_ms
                          + (1.0 - self.alpha) * self._ewma)
            target = self.margin * self._ewma
        if self.jitter > 0:
            u = mix32_host(self._obs * 0x9E3779B9 + self.seed)
            frac = ((u & 0xFFFF) / 0xFFFF * 2.0 - 1.0) * self.jitter
            target *= 1.0 + frac
        self._current = min(max(target, float(self.floor_ms)),
                            float(self.cap_ms))


def _schedule_value(value_schedule: str, base_value: int, my_id: int,
                    inst: int) -> int:
    """The deterministic per-instance proposal schedule of the host loops.

    "mixed" (default, the PerfTest2 shape): (base + id·7 + inst) mod 5 —
    replicas propose DISTINCT values, so agreement is non-trivial but the
    decided value is fault-schedule-dependent.  "uniform": (base + inst)
    mod 5 for every replica — by validity the decision is then invariant
    under ANY fault schedule, which is what lets the chaos harness diff a
    faulty run's decision log byte-for-byte against a clean run's."""
    if value_schedule == "uniform":
        return (base_value + inst) % 5
    if value_schedule != "mixed":
        raise ValueError(
            f"value_schedule must be 'mixed' or 'uniform', "
            f"got {value_schedule!r}")
    return (base_value + my_id * 7 + inst) % 5


def instance_io(algo: Algorithm, value: int) -> Dict[str, Any]:
    """The io pytree for one instance's scheduled proposal ``value``.

    Scalar-domain algorithms get the PerfTest2 shape ({"initial_value":
    int32}); a byte-payload algorithm (models/lastvoting.LastVotingBytes,
    detected by its ``payload_bytes`` attribute) gets a deterministic
    uint8[B] vector expanded from the value — distinct values map to
    distinct vectors (agreement stays non-trivial under the "mixed"
    schedule) and equal values to equal vectors (the "uniform" schedule
    stays fault-invariant by validity).  This is what lets the KB-payload
    wire-fraction workload (PERF_MODEL.md) run through the SAME host
    loops as the scalar protocols."""
    b = getattr(algo, "payload_bytes", None)
    if b is None:
        return {"initial_value": np.int32(value)}
    vec = ((np.arange(b, dtype=np.int64) * 131 + value * 31 + 7) % 256)
    return {"initial_value": vec.astype(np.uint8)}


def decision_scalar(decision) -> int:
    """Collapse a decision to the int the decision logs store: scalar
    decisions pass through unchanged (the seed behavior); a VECTOR
    decision (LastVotingBytes) becomes a 7-byte blake2s digest — equal
    vectors hash equal across replicas, and the digest fits the
    checkpoint's int64 array with the _UNDECIDED sentinel unreachable.
    Replies to laggards must ship the RAW decision, not this digest
    (callers keep the raw array beside the log for that)."""
    arr = np.asarray(decision)
    if arr.ndim == 0:
        return int(arr)
    import hashlib

    return int.from_bytes(
        hashlib.blake2s(arr.tobytes(), digest_size=7).digest(), "big")


def _try_send_decision(transport, replied: Dict[Tuple[int, int], float],
                       sender: int, instance: int, decision,
                       enc_cache: Optional[Dict[int, bytes]] = None) -> bool:
    """THE TooLate / trySendDecision reply (PerfTest.scala:40-60), shared
    by the sequential loop's foreign sink and the pipelined mux: answer a
    completed instance's late traffic with its decision, rate-limited per
    (sender, instance) — the reply itself can drop on UDP, so the
    laggard's next retransmission re-arms it.  True iff a reply actually
    went out (rate-limited/undecided calls return False, so reply
    accounting counts wire sends, not answerable packets).

    ``enc_cache`` ({instance: wire bytes}) makes the encode once-per-
    instance: without it every laggard probe — and every DESTINATION peer
    in the linger loop — re-serialized the same decision payload (the
    per-peer re-encode audit of this module; see also ViewManager.
    reply_view)."""
    if decision is None:
        return False
    now = _time.monotonic()
    if now - replied.get((sender, instance), -1.0) <= 0.25:
        return False
    replied[(sender, instance)] = now
    wire = enc_cache.get(instance) if enc_cache is not None else None
    if wire is None:
        wire = codec.encode(np.asarray(decision))
        if enc_cache is not None:
            enc_cache[instance] = wire
    transport.send(sender, Tag(instance=instance, flag=FLAG_DECISION), wire)
    _C_REPLIES.inc()
    if TRACE.enabled:
        TRACE.emit("decision_reply", node=getattr(transport, "id", None),
                   inst=instance, dst=sender)
    return True


class MuxEndpoint:
    """One instance's view of the shared transport: sends pass through,
    receives come from the instance's routed queue."""

    def __init__(self, mux: "InstanceMux", instance_id: int):
        self._mux = mux
        self._q = mux._queues[instance_id & 0xFFFF]

    def add_peer(self, pid, host, port):
        self._mux.transport.add_peer(pid, host, port)

    def send(self, dest, tag, payload):
        return self._mux.transport.send(dest, tag, payload)

    def recv(self, timeout_ms: int):
        try:
            if timeout_ms <= 0:
                got = self._q.get_nowait()
            else:
                got = self._q.get(timeout=timeout_ms / 1000.0)
        except _queue.Empty:
            return None
        if got is _ROUTER_DOWN:
            # re-arm for any later recv on this endpoint, then surface the
            # router failure instead of starving into None decisions
            self._q.put(_ROUTER_DOWN)
            raise RuntimeError(
                "InstanceMux router thread died"
            ) from self._mux.failure
        return got

    def recv_many(self, timeout_ms: int):
        """Drain every routed frame currently queued (the HostRunner
        batched-drain surface over a mux queue)."""
        out = []
        got = self.recv(timeout_ms)
        while got is not None:
            out.append(got)
            got = self.recv(0)
        return out

    def send_buffered(self, dest, tag, payload):
        t = self._mux.transport
        f = getattr(t, "send_buffered", None)
        if f is None:  # bare test doubles: degrade to a direct send
            return t.send(dest, tag, bytes(payload))
        return f(dest, tag, payload)

    def flush(self, to=None):
        f = getattr(self._mux.transport, "flush", None)
        return 0 if f is None else f(to)

    @property
    def dropped(self):
        return self._mux.transport.dropped


class InstanceMux:
    """Tag-routed demultiplexer over ONE HostTransport — the host-side
    InstanceDispatcher (InstanceDispatcher.scala:9-90): a single recv-loop
    thread routes packets to per-instance endpoints, so `rate` instances
    run CONCURRENTLY over one socket mesh (the reference's in-flight
    PerfTest2 rate / processPool shape; the sequential loop runs them one
    at a time).

    Routing rules (the dispatcher + defaultHandler split):
      * a registered instance's traffic → its queue (HostRunner consumes
        through a MuxEndpoint facade).  Routing is by TAG HEADER PEEK
        only — payload bytes are never decoded here (they stay raw
        memoryviews from the transport's batched drain until the owning
        runner's _loads), and a whole drain is routed under one lock
        acquisition;
      * NORMAL traffic for a COMPLETED instance → rate-limited
        FLAG_DECISION reply with that instance's decision (the TooLate /
        trySendDecision path, PerfTest.scala:40-60);
      * NORMAL traffic for a FUTURE instance → stashed raw and replayed
        into its queue at register time (the lazy-join role);
      * anything else is dropped (the reference's unknown-instance drop).
    """

    _STASH_CAP = 4096  # total stashed packets: when full the OLDEST entry
    # is evicted FIFO, so garbage tagged with never-registering instance
    # ids ages out instead of permanently exhausting the stash (the
    # unauthenticated-socket hardening discipline of this module)

    def __init__(self, transport: HostTransport):
        self.transport = transport
        self._lock = threading.Lock()
        self._queues: Dict[int, Any] = {}
        # native round pump (run_instance_loop_pipelined pump mode): the
        # router stays the shared-inbox drainer, but a frame routed to a
        # lane-bound instance's queue must WAKE that lane's runner out of
        # rt_pump_wait_lane — rt_pump_poke is that nudge
        self.pump: Optional[RoundPump] = None
        self._lanes: Dict[int, int] = {}   # iid -> pump lane
        self._stash: Dict[int, List[Tuple[int, Tag, bytes]]] = {}
        self._stash_order: collections.deque = collections.deque()
        self._decisions: Dict[int, Optional[np.ndarray]] = {}
        self._replied: Dict[Tuple[int, int], float] = {}
        self._enc_cache: Dict[int, bytes] = {}  # instance -> encoded
        # decision wire bytes (encode once, reply to every laggard/peer
        # with the shared buffer)
        self._stop = False
        # set when the router thread dies on an unexpected exception; every
        # endpoint raises and run_instance_loop_pipelined re-raises
        self.failure: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def register(self, instance_id: int) -> MuxEndpoint:
        iid = instance_id & 0xFFFF
        with self._lock:
            q = _queue.Queue()
            self._queues[iid] = q
            for got in self._stash.pop(iid, []):
                q.put(got)
            # purge the replayed instance from the eviction order too, or
            # its stale entries would inflate the cap check and evict LIVE
            # buckets long before the stash is actually full
            self._stash_order = collections.deque(
                x for x in self._stash_order if x != iid)
            if self.failure is not None:
                # the router is already dead: a fresh endpoint must fail
                # fast, not wait out its whole run on an unserviced queue
                q.put(_ROUTER_DOWN)
        return MuxEndpoint(self, iid)

    def bind_lane(self, instance_id: int, lane: int) -> None:
        """Route rt_pump_poke nudges for this instance to ``lane``."""
        with self._lock:
            self._lanes[instance_id & 0xFFFF] = lane

    def unbind_lane(self, instance_id: int) -> None:
        with self._lock:
            self._lanes.pop(instance_id & 0xFFFF, None)

    def complete(self, instance_id: int,
                 decision: Optional[np.ndarray]) -> None:
        iid = instance_id & 0xFFFF
        with self._lock:
            self._queues.pop(iid, None)
            self._lanes.pop(iid, None)
            self._decisions[iid] = decision

    def close(self) -> None:
        self._stop = True
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        try:
            self._loop_body()
        except BaseException as e:  # noqa: BLE001 — a dying router thread
            # must not be silent: record the failure and wake every
            # endpoint so in-flight instances raise instead of starving
            # into timeout-by-timeout None decisions (ADVICE.md round-5)
            self.failure = e
            log.error("InstanceMux router thread died: %r", e)
            METRICS.counter("mux.router_deaths").inc()
            if TRACE.enabled:
                TRACE.emit("mux_router_died",
                           node=getattr(self.transport, "id", None),
                           error=repr(e))
            with self._lock:
                for q in self._queues.values():
                    q.put(_ROUTER_DOWN)

    def _loop_body(self) -> None:
        # batched drain when the transport offers it: every queued frame
        # in one native call, routed (by tag header peek — payloads are
        # never decoded here) under ONE lock acquisition per drain instead
        # of one per packet
        recv_many = getattr(self.transport, "recv_many", None)
        while not self._stop:
            if recv_many is not None:
                got_list = recv_many(50)
            else:
                got = self.transport.recv(50)
                got_list = [got] if got is not None else []
            if not got_list:
                continue
            replies: List[Tuple[int, int, Any]] = []
            pokes: set = set()
            with self._lock:
                # routing decision and stash append under ONE acquisition:
                # a lookup in one critical section + append in another
                # would race register() replaying the stash in between,
                # silently losing the packet
                for got in got_list:
                    sender, tag, _raw = got
                    iid = tag.instance
                    q = self._queues.get(iid)
                    if q is not None:
                        q.put(got)
                        _C_MUX_ROUTED.inc()
                        lane = self._lanes.get(iid)
                        if lane is not None:
                            pokes.add(lane)
                    elif iid in self._decisions:
                        if tag.flag == FLAG_NORMAL:
                            replies.append(
                                (sender, iid, self._decisions[iid]))
                    elif tag.flag == FLAG_NORMAL:
                        while len(self._stash_order) >= self._STASH_CAP:
                            old = self._stash_order.popleft()
                            bucket = self._stash.get(old)
                            if bucket:
                                bucket.pop(0)
                                if not bucket:
                                    del self._stash[old]
                        if not isinstance(got[2], bytes):
                            # stash entries are LONG-LIVED (until the
                            # instance registers); a memoryview here would
                            # pin its whole drain copy — own the bytes
                            got = (got[0], got[1], bytes(got[2]))
                        self._stash.setdefault(iid, []).append(got)
                        self._stash_order.append(iid)
                        _C_MUX_STASHED.inc()
            pump = self.pump
            if pump is not None:
                for lane in pokes:
                    pump.poke(lane)
            for sender, iid, reply_with in replies:
                if reply_with is not None:
                    _try_send_decision(self.transport, self._replied,
                                       sender, iid, reply_with,
                                       enc_cache=self._enc_cache)


def run_instance_loop_pipelined(
    algo: Algorithm,
    my_id: int,
    peers: Dict[int, Tuple[str, int]],
    transport: HostTransport,
    instances: int,
    rate: int = 8,
    timeout_ms: int = 300,
    seed: int = 0,
    base_value: int = 0,
    max_rounds: int = 32,
    stats_out: Optional[Dict[str, int]] = None,
    nbr_byzantine: int = 0,
    value_schedule: str = "mixed",
    adaptive: Optional["AdaptiveTimeout"] = None,
    wire: str = "binary",
    pump: bool = True,
    device=None,
) -> List[Optional[int]]:
    """The PerfTest2 loop with `rate` instances IN FLIGHT (the reference's
    `-rt` rate + InstanceDispatcher shape): a sliding window of concurrent
    HostRunners over one InstanceMux.  An instance burning a round
    timeout no longer stalls the pipeline — the win is largest on lossy
    transports, where the sequential loop serializes every burned
    deadline.  Same value schedule and seeds as run_instance_loop, so the
    two modes are cross-checkable.

    With ``pump`` (and a pump-capable binary-wire transport), each
    in-flight instance occupies one NATIVE pump lane (_make_mux_pump):
    its frames are parsed/ingested in the C event loop, its runner blocks
    in rt_pump_wait_lane, and the router thread — still the shared-inbox
    drainer for out-of-band traffic — nudges the lane with rt_pump_poke
    when it routes to that instance's endpoint queue.  ``pump=False``
    pins the Python-pump baseline (the A/B arm of tests/test_pump.py).
    Every runner's round runs on ``device`` (the card when None)."""
    if rate < 1:
        raise ValueError(f"rate must be >= 1, got {rate}")
    import os as _os

    device = resolve_device(device)

    mux = InstanceMux(transport)
    pump_states = None
    if (pump and wire == "binary" and not TRACE.enabled
            and _os.environ.get("ROUND_TPU_PUMP", "1") != "0"):
        pump_states = _make_mux_pump(transport, algo, my_id, len(peers),
                                     nbr_byzantine, rate, device)
    if pump_states is not None:
        mux.pump = pump_states[0].pump
    decisions: List[Optional[int]] = [None] * instances
    errors: List[Tuple[int, BaseException]] = []
    stats_lock = threading.Lock()
    sem = threading.Semaphore(rate)
    lane_pool: collections.deque = collections.deque(range(rate))
    threads: List[threading.Thread] = []

    def worker(inst: int, ep: MuxEndpoint,
               ps: Optional[_RunnerPumpState]) -> None:
        try:
            runner = HostRunner(
                algo, my_id, peers, ep, instance_id=inst,
                timeout_ms=timeout_ms, seed=seed + inst,
                nbr_byzantine=nbr_byzantine, adaptive=adaptive,
                wire=wire, pump_state=ps, device=device,
            )
            value = _schedule_value(value_schedule, base_value, my_id, inst)
            res = runner.run(instance_io(algo, value),
                             max_rounds=max_rounds)
            if ps is not None:
                # retire the lane BEFORE complete(): frames for this
                # instance flow to the inbox again, where the router's
                # TooLate decision-reply path answers them
                ps.pump.close_lane(ps.lane)
                mux.unbind_lane(inst)
            d = decision_scalar(res.decision) if res.decided else None
            decisions[inst - 1] = d
            mux.complete(
                inst, np.asarray(res.decision) if res.decided else None)
            if stats_out is not None:
                with stats_lock:
                    for k, v in (("timeouts", res.timeouts),
                                 ("rounds_run", res.rounds_run),
                                 ("malformed", res.malformed_messages)):
                        stats_out[k] = stats_out.get(k, 0) + v
                    stats_out.setdefault("timeout_trajectory", []).extend(
                        res.timeout_trajectory)
        except BaseException as e:  # noqa: BLE001 — a worker-thread error
            # must FAIL the run like the sequential path's would, not
            # silently become a None decision; complete() so peer
            # retransmissions stop queueing against a dead instance
            with stats_lock:
                errors.append((inst, e))
            mux.complete(inst, None)
        finally:
            if ps is not None:
                ps.pump.close_lane(ps.lane)   # idempotent
                with stats_lock:
                    lane_pool.append(ps.lane)
            sem.release()

    try:
        for inst in range(1, instances + 1):
            sem.acquire()
            ps = None
            if pump_states is not None:
                with stats_lock:
                    # the semaphore bounds in-flight workers by rate, and
                    # every worker returns its lane before releasing, so
                    # the pool is never empty here
                    ps = pump_states[lane_pool.popleft()]
                mux.bind_lane(inst, ps.lane)
            # register BEFORE the runner exists: a fast peer's first
            # message may arrive the instant our previous one completes
            ep = mux.register(inst)
            t = threading.Thread(target=worker, args=(inst, ep, ps))
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
    finally:
        mux.close()
        if pump_states is not None:
            mux.pump = None
            pump_states[0].close()  # banks pump stats + detaches once
    if mux.failure is not None:
        # the router thread died: every None in `decisions` is starvation,
        # not a protocol outcome — fail the run (ADVICE.md round-5)
        raise RuntimeError(
            "InstanceMux router thread died mid-run"
        ) from mux.failure
    if errors:
        inst, err = errors[0]
        raise RuntimeError(
            f"{len(errors)} pipelined instance(s) failed, first: "
            f"instance {inst}"
        ) from err
    return decisions


def run_instance_loop(
    algo: Algorithm,
    my_id: int,
    peers: Dict[int, Tuple[str, int]],
    transport: HostTransport,
    instances: int,
    timeout_ms: int = 300,
    seed: int = 0,
    base_value: int = 0,
    max_rounds: int = 32,
    stats_out: Optional[Dict[str, int]] = None,
    send_when_catching_up: bool = True,
    delay_first_send_ms: int = -1,
    nbr_byzantine: int = 0,
    value_schedule: str = "mixed",
    adaptive: Optional[AdaptiveTimeout] = None,
    checkpoint_dir: Optional[str] = None,
    view=None,
    view_schedule: Optional[Dict[int, Tuple[int, int]]] = None,
    wire: str = "binary",
    pump: bool = True,
    health=None,
    rv=None,
    snap=None,
    device=None,
) -> List[Optional[int]]:
    """The PerfTest2 loop (PerfTest2.scala:19-110): `instances` consecutive
    consensus instances over one transport, with start-skew stashing —
    NORMAL messages tagged with a FUTURE instance are buffered and
    prefilled into that instance's runner (the defaultHandler lazy-join
    role); traffic for completed instances is dropped (TooLate).  Initial
    values follow the deterministic schedule (base_value + id·7 + inst)
    mod 5 (or the fault-invariant "uniform" schedule — _schedule_value),
    so runs are reproducible across replicas and modes.

    With `checkpoint_dir`, the decision list is DURABLY checkpointed
    after every instance (runtime/checkpoint.py atomic npz + manifest +
    decision-log TSV), and a fresh call over an existing checkpoint
    RESUMES: restored instances are not re-run, and the first live
    instance catches up over the wire via the peers' completed-instance
    FLAG_DECISION replies (the lazy-join/decision-replay machinery).
    This is the crash-restart story: SIGKILL a replica mid-run, start it
    again with the same arguments, and its final decision log must be
    byte-identical to a never-crashed run (tests/test_chaos.py).

    With a ``view`` (runtime/view.py ViewManager), every instance runs
    over the view's CURRENT group (pid + peer table re-read each
    instance), and ``view_schedule`` — {data instance -> (kind, arg)} —
    makes this replica propose that membership op by consensus right
    after the instance completes (the DynamicMembership.scala:231-245
    flow; all members carry the same script).  Schedule entries whose
    epoch has already been applied (a late joiner handed a post-change
    view at launch) are skipped.  An instance interrupted by a view move
    (stale_view) is re-run on the new wire; a replica that discovers its
    own removal returns its decision log immediately with the remaining
    entries undecided — the CALLER exits it cleanly.

    Every runner's round runs on ``device`` (the card when None).  With
    ``rv`` (rv.dump.RvConfig) every instance's decision plane is checked
    by the lane monitor term's numpy twin; with ``snap``
    (snap.audit.SnapConfig) the rounds are sampled into cuts, audited on
    the collector replica.

    Returns the per-instance decision log (None where undecided)."""
    device = resolve_device(device)
    stash: Dict[int, Dict[int, Dict[int, Any]]] = {}
    current = {"inst": 0}
    decisions: List[Optional[int]] = []
    # instance -> raw decision array: laggard replies must carry the value
    # a peer can ADOPT — for vector-decision algorithms (LastVotingBytes)
    # the log stores the digest (decision_scalar), which is not adoptable
    raw_decisions: Dict[int, np.ndarray] = {}
    replied: Dict[Tuple[int, int], float] = {}
    enc_cache: Dict[int, bytes] = {}
    start = 1
    if checkpoint_dir is not None:
        from round_tpu_torch.runtime import checkpoint as _ckpt

        if _ckpt.exists(checkpoint_dir):
            like = np.full(instances, _UNDECIDED, dtype=np.int64)
            arr, step, meta = _ckpt.restore(checkpoint_dir, like)
            if (meta.get("kind") != "host-decision-log"
                    or meta.get("instances") != instances
                    or not 0 <= int(step) <= instances):
                raise _ckpt.CheckpointError(
                    f"checkpoint at {checkpoint_dir} is not a host decision "
                    f"log for an {instances}-instance run: meta={meta}, "
                    f"step={step}")
            arr = np.asarray(arr)
            decisions = [None if int(v) == _UNDECIDED else int(v)
                         for v in arr[: int(step)]]
            start = int(step) + 1
            log.info("node %d: resumed %d decided instance(s) from %s, "
                     "continuing at instance %d", my_id,
                     sum(d is not None for d in decisions),
                     checkpoint_dir, start)

    def foreign(sender, tag, payload):
        if tag.instance <= current["inst"]:
            # traffic for a COMPLETED instance: instead of dropping it
            # (TooLate), reply with that instance's decision out-of-band —
            # the lagging replica adopts it and exits instead of burning a
            # timeout (PerfTest.scala:40-60, trySendDecision; essential on
            # UDP where the round-4 decision broadcast can simply drop).
            # RATE-LIMITED, not one-shot: the reply itself can drop on UDP,
            # so the laggard's next retransmission re-arms it
            idx = tag.instance - 1
            if 0 <= idx < len(decisions):
                reply = raw_decisions.get(tag.instance)
                if reply is None and getattr(algo, "payload_bytes",
                                             None) is None:
                    # scalar-decision log values ARE the raw decision
                    # (checkpoint-resumed instances have no raw entry);
                    # a vector algorithm's log holds digests, which a
                    # laggard cannot adopt — better no reply than a
                    # garbage one it must discard every round
                    reply = decisions[idx]
                if reply is not None:
                    _try_send_decision(transport, replied, sender,
                                       tag.instance, reply,
                                       enc_cache=enc_cache)
            return
        stash.setdefault(tag.instance, {}).setdefault(
            tag.round, {})[sender] = payload

    # NATIVE ROUND PUMP (native/transport.cpp): one state for ALL the
    # loop's consecutive runners — class mailboxes registered once, one
    # pump lane re-opened per instance.  The Python pump stays the
    # baseline/fallback: views (epoch guards), the catch-up-send
    # experiment and per-frame tracing all live there, and a transport
    # without the surface (bare doubles, receiver-side chaos families,
    # ROUND_TPU_PUMP=0, stale .so) simply returns None.
    import os as _os

    pump_state = None
    if (pump and wire == "binary" and view is None
            and send_when_catching_up and not TRACE.enabled
            and _os.environ.get("ROUND_TPU_PUMP", "1") != "0"):
        pump_state = _make_runner_pump(transport, algo, my_id,
                                       len(peers), nbr_byzantine, device)
    # runtime verification: one RvRuntime and monitor program for the
    # whole loop, one HostRv per instance inside the body
    rv_state = None
    if rv is not None:
        from round_tpu_torch.rv.compile import monitor_program
        from round_tpu_torch.rv.dump import RvRuntime

        program = monitor_program(algo, len(peers))
        if program is None:
            log.warning("node %d: rv requested but %s has no decision "
                        "plane to monitor; rv disabled", my_id,
                        type(algo).__name__)
        else:
            rv_state = (RvRuntime(rv, node=my_id, n=len(peers), seed=seed,
                                  max_rounds=max_rounds, device=device),
                        program, rv)
    # snapshots: ONE SnapDriver for the whole loop (the emitter, the
    # collector's part-cuts and the audit cache outlive an instance)
    snap_state = None
    if snap is not None:
        from round_tpu_torch.snap.driver import SnapDriver

        snap_state = SnapDriver(
            snap, algo, node=my_id, n=len(peers), seed=seed,
            max_rounds=max_rounds, transport=transport,
            value_schedule=value_schedule, base_value=base_value,
            view=view, device=device)
    try:
        return _run_instance_loop_body(
            algo, my_id, peers, transport, instances, timeout_ms, seed,
            base_value, max_rounds, stats_out, send_when_catching_up,
            delay_first_send_ms, nbr_byzantine, value_schedule, adaptive,
            checkpoint_dir, view, view_schedule, wire, pump_state,
            decisions, raw_decisions, replied, enc_cache, stash, current,
            foreign, start, health, device, rv_state, snap_state)
    finally:
        if rv_state is not None:
            # stats survive an rv halt: the summary carries the record
            rv_state[0].fill_stats(stats_out)
        if snap_state is not None:
            snap_state.fill_stats(stats_out)
        if pump_state is not None:
            pump_state.close()


def _run_instance_loop_body(
    algo, my_id, peers, transport, instances, timeout_ms, seed,
    base_value, max_rounds, stats_out, send_when_catching_up,
    delay_first_send_ms, nbr_byzantine, value_schedule, adaptive,
    checkpoint_dir, view, view_schedule, wire, pump_state,
    decisions, raw_decisions, replied, enc_cache, stash, current,
    foreign, start, health, device, rv_state=None, snap_state=None,
) -> List[Optional[int]]:
    # ordered view-change schedule: entry i moves the group from epoch i
    # to i+1, so a replica only PROPOSES an entry its own epoch has not
    # yet passed (a late joiner launched with a post-change view skips
    # the entries that produced it)
    sched_order = sorted(view_schedule) if view_schedule else []
    for inst in range(start, instances + 1):
        current["inst"] = inst
        for _attempt in range(4):
            vid, vpeers = my_id, peers
            if view is not None:
                if view.removed:
                    break
                vid, vpeers = view.my_id, view.view.peers()
            inst_rv = None
            if rv_state is not None:
                from round_tpu_torch.rv.compile import (
                    HostRv, schedule_init_values,
                )

                rv_runtime, rv_program, rv_cfg = rv_state
                nn = len(vpeers)
                inst_rv = HostRv(
                    rv_runtime, rv_program, inst,
                    schedule_init_values(algo, nn, value_schedule,
                                         base_value, inst),
                    [_schedule_value(value_schedule, base_value, pid,
                                     inst) for pid in range(nn)],
                    gossip=rv_cfg.gossip)
            runner = HostRunner(
                algo, vid, vpeers, transport, instance_id=inst,
                timeout_ms=timeout_ms, seed=seed + inst,
                foreign=foreign, prefill=stash.pop(inst, None),
                send_when_catching_up=send_when_catching_up,
                # start skew is a per-run experiment: only the first
                # instance is delayed (the reference sleeps at instance
                # start, and the point is skewING the replica, not
                # slowing every instance)
                delay_first_send_ms=(delay_first_send_ms
                                     if inst == 1 else -1),
                nbr_byzantine=nbr_byzantine,
                adaptive=adaptive,
                view=view,
                wire=wire,
                pump_state=pump_state,
                health=health,
                rv=inst_rv,
                snap=snap_state,
                device=device,
            )
            value = _schedule_value(value_schedule, base_value, vid, inst)
            res = runner.run(instance_io(algo, value),
                             max_rounds=max_rounds)
            if view is not None and res.stale_view and not res.decided \
                    and not view.removed:
                # the view moved under this instance: clear the stale
                # latch and re-run it over the NEW wire (bounded retries;
                # epochs advance a handful of times per deployment)
                view.stale = False
                continue
            break
        if view is not None and view.removed:
            # voted out: undecided placeholders for the un-run tail keep
            # the decision-log length schedule-shaped for the harness
            decisions.extend([None] * (instances - len(decisions)))
            break
        if res.decided:
            decisions.append(decision_scalar(res.decision))
            raw_decisions[inst] = np.asarray(res.decision)
        else:
            decisions.append(None)
        if checkpoint_dir is not None:
            _save_decision_checkpoint(checkpoint_dir, decisions, inst,
                                      instances)
        if stats_out is not None:
            # cumulative diagnostics across instances (timeouts is the
            # throughput one: every entry burned a full round deadline)
            for k, v in (("timeouts", res.timeouts),
                         ("rounds_run", res.rounds_run),
                         ("malformed", res.malformed_messages)):
                stats_out[k] = stats_out.get(k, 0) + v
            # concatenated per-round deadlines across instances: with an
            # adaptive estimator this is the convergence trajectory
            stats_out.setdefault("timeout_trajectory", []).extend(
                res.timeout_trajectory)
            if health is not None:
                stats_out["quarantine"] = health.summary()
        if view is not None and view_schedule and inst in view_schedule \
                and view.epoch == sched_order.index(inst):
            # the scripted membership change: consensus on the op over
            # the CURRENT view, applied to the live wire on decision
            # (runtime/view.py).  An undecided outcome leaves the view
            # unchanged — if peers DID decide, their next stamped frames
            # trigger the FLAG_VIEW catch-up and the next instance re-runs
            # on the adopted view.
            from round_tpu_torch.runtime.view import view_instance

            kind, arg = view_schedule[inst]
            view.propose(
                algo, kind, arg, seed=seed, timeout_ms=timeout_ms,
                max_rounds=max_rounds, adaptive=adaptive, foreign=foreign,
                prefill=stash.pop(view_instance(view.epoch), None),
                device=device,
            )
            view.stale = False  # any mid-change staleness was resolved
            # by propose/adopt; the next data instance starts fresh
    return decisions


def serve_decisions(transport, decisions: List[Optional[int]],
                    idle_ms: int = 4000, contact_idle_ms: int = 2000,
                    max_ms: int = 120_000, adoptable: bool = True) -> int:
    """Linger after a completed instance loop, answering peers' NORMAL
    traffic with FLAG_DECISION replies (the trySendDecision machinery)
    until the wire has been idle for `idle_ms` (hard cap `max_ms`).

    The recovery protocol NEEDS this when replicas are short-lived CLI
    processes: a crash-restarted replica catches up from its peers'
    decision replies, but the reference's processes are long-running
    services — ours exit when their own loop ends, and a replica whose
    restart latency exceeds the peers' remaining run time finds nobody
    left to answer (observed as a starved None on the last instance in
    the chaos soak).  Two-phase idle clock: the full `idle_ms` window
    only has to cover the laggard's silent RESTART latency; once the
    laggard is seen working its FINAL instance (it retransmits every
    round and adopts the reply within one), the re-armed window shrinks
    to `contact_idle_ms` so a finished laggard releases this replica
    quickly.  Earlier-instance traffic does NOT shrink the window —
    stale pre-crash packets drained at linger start must not collapse
    the restart window.  Returns the number of replies sent.

    ``adoptable=False`` lingers WITHOUT replying (the idle clock still
    runs): callers whose decision entries are digests rather than raw
    decisions (a vector-decision algorithm's log, decision_scalar) must
    not ship values a laggard's adopt_decision can only discard."""
    replied: Dict[Tuple[int, int], float] = {}
    enc_cache: Dict[int, bytes] = {}
    served = 0
    t_end = _time.monotonic() + max_ms / 1000.0
    window = idle_ms / 1000.0
    deadline = _time.monotonic() + window
    while _time.monotonic() < min(deadline, t_end):
        got = transport.recv(100)
        if got is None:
            continue
        sender, tag, _raw = got
        if (adoptable and tag.flag == FLAG_NORMAL
                and 1 <= tag.instance <= len(decisions)
                and decisions[tag.instance - 1] is not None):
            if _try_send_decision(transport, replied, sender, tag.instance,
                                  decisions[tag.instance - 1],
                                  enc_cache=enc_cache):
                served += 1
            if tag.instance == len(decisions):
                window = min(window, contact_idle_ms / 1000.0)
            deadline = _time.monotonic() + window
    return served


# undecided sentinel in checkpointed decision arrays (decisions are small
# non-negative protocol values; the sentinel is unreachable)
_UNDECIDED = -(1 << 62)


def _save_decision_checkpoint(checkpoint_dir: str,
                              decisions: List[Optional[int]],
                              step: int, instances: int) -> None:
    """Durably record the decision list after an instance completes:
    atomic npz (fixed [instances] int64, _UNDECIDED where undecided) +
    manifest + the canonical decision-log TSV (runtime/decisions.py) —
    a SIGKILL between instances loses at most the in-flight instance,
    which the restarted loop re-runs/recovers over the wire."""
    from round_tpu_torch.runtime import checkpoint as _ckpt
    from round_tpu_torch.runtime.decisions import DecisionLog

    arr = np.full(instances, _UNDECIDED, dtype=np.int64)
    for k, d in enumerate(decisions):
        if d is not None:
            arr[k] = d
    _ckpt.save(
        checkpoint_dir, arr, step=step,
        meta={"kind": "host-decision-log", "instances": instances},
        decisions=DecisionLog.from_values(decisions),
    )


class _RoundMailbox:
    """One round's mailbox, assembled IN PLACE: decoded payloads write
    directly into preallocated ``[n, ...]`` per-round arrays + mask — the
    exact buffers the update consumes after one copy to the device —
    replacing the per-message
    dict insert + per-probe restack of the old path (a FoldRound's
    go-probe used to re-flatten and re-stack the whole inbox on EVERY
    received message).  The arrays are REUSED across rounds (reset zeros
    them), so the steady state allocates nothing.

    ``legacy=True`` keeps the seed behavior byte-for-byte (dict inbox,
    stacked per values_mask call) — the "old path" arm of the wire A/B
    (apps/perf_ab.py).

    A payload that decoded fine but has the WRONG SHAPE for this round
    (tree structure, leaf count, leaf shape/dtype) is byzantine garbage —
    dropped per sender + counted via the runner, never a crash (the
    deserialize-failure tolerance of InstanceHandler.scala:392-399
    extended to the structural layer the codec does not check)."""

    __slots__ = ("runner", "legacy", "n", "treedef", "stacked", "mask",
                 "like", "count_arr", "_sig", "_inbox", "pinned")

    def __init__(self, runner: "HostRunner", legacy: bool):
        self.runner = runner
        self.legacy = legacy
        self.n = runner.n
        # pinned = the native pump holds raw pointers into stacked/mask/
        # count_arr: a signature change (which would REALLOCATE them) is
        # a driver bug, not wire input — fail loudly, never dangle
        self.pinned = False
        self.treedef = None
        self.stacked: List[np.ndarray] = []
        self.mask = np.zeros((self.n,), dtype=bool)
        self.like = None
        # the heard count lives in a shareable int64 cell: the native
        # round pump registers it by pointer and increments it with no
        # GIL held (runtime/transport.py RoundPump.set_class); the Python
        # pump updates the same cell, so `count` reads one source of
        # truth either way
        self.count_arr = np.zeros((1,), dtype=np.int64)
        self._sig = None
        self._inbox: Dict[int, Any] = {}

    @property
    def count(self) -> int:
        return int(self.count_arr[0])

    def reset(self, like: Any) -> None:
        """Arm for a new round whose payload exemplar is ``like`` (the
        just-computed send payload: every peer runs the same round class,
        so its shape IS the mailbox slot shape)."""
        self.like = like
        self.count_arr[0] = 0
        if self.legacy:
            self._inbox = {}
            return
        leaves, treedef = _flatten(like)
        sig = (treedef, tuple((np.shape(l), np.asarray(l).dtype)
                              for l in leaves))
        if sig != self._sig:
            if self.pinned and self._sig is not None:
                raise RuntimeError(
                    f"payload signature changed under a pump-registered "
                    f"mailbox: {sig} != {self._sig}")
            self._sig = sig
            self.treedef = treedef
            self.stacked = [
                np.zeros((self.n,) + np.shape(l),
                         dtype=np.asarray(l).dtype)
                for l in leaves
            ]
            self.mask = np.zeros((self.n,), dtype=bool)
        else:
            for a in self.stacked:
                a.fill(0)
            self.mask.fill(False)

    def insert(self, sender: int, payload: Any) -> bool:
        """Write one sender's payload into its slot; True when the round's
        heard-set grew (duplicates overwrite, structural garbage drops)."""
        if self.legacy:
            grew = sender not in self._inbox
            self._inbox[sender] = payload
            if grew:
                self.count_arr[0] += 1
            return True  # legacy semantics: structure checked at stacking
        try:
            leaves = _flatten(payload)[0]
            if len(leaves) != len(self.stacked):
                raise ValueError(
                    f"{len(leaves)} leaves != {len(self.stacked)}")
            for slot, leaf in zip(self.stacked, leaves):
                arr = np.asarray(leaf)
                if arr.shape != slot.shape[1:]:
                    raise ValueError(
                        f"leaf shape {arr.shape} != {slot.shape[1:]}")
                slot[sender] = arr.astype(slot.dtype, casting="same_kind")
        except Exception as e:  # noqa: BLE001 — garbage must not kill us
            r = self.runner
            r.malformed += 1
            _C_MALFORMED.inc()
            if self.mask[sender]:
                self.mask[sender] = False
                self.count_arr[0] -= 1
            for slot in self.stacked:
                slot[sender] = 0  # a half-written slot must not leak
            log.debug("node %d: dropping structurally-malformed payload "
                      "from %d: %s", r.id, sender, e)
            return False
        if not self.mask[sender]:
            self.mask[sender] = True
            self.count_arr[0] += 1
            return True
        return False  # duplicate: overwritten, heard-set unchanged

    def senders(self) -> List[int]:
        if self.legacy:
            return sorted(int(s) for s in self._inbox)
        return [int(i) for i in np.nonzero(self.mask)[0]]

    def values_mask(self):
        """The (values pytree, mask) pair, host arrays, that the update and
        the go probe consume after one copy to the device.  Binary mode:
        zero-work (the arrays already ARE the mailbox).  Legacy mode:
        stack now, exactly like the seed did."""
        if self.legacy:
            return self.runner._mailbox(self._inbox, self.like)
        return _unflatten(self.treedef, self.stacked), self.mask


def pump_coerce_encode(payload, slot_specs, treedef) -> bytes:
    """The SHARED coercion rule of the pump-mode bilingual slow path
    (HostRunner._pump_coerce_insert and LaneDriver._pump_fallback_insert
    must never drift apart — they gate the same equivalence contract):
    flatten, validate leaf count + shapes against ``slot_specs``
    [(shape, dtype), ...], cast same-kind into the slot dtypes (astype
    copies into a fresh C-contiguous array and — unlike
    ascontiguousarray — keeps 0-d payloads 0-d), and re-encode
    canonically.  Raises on any structural mismatch; the caller applies
    its driver's malformed semantics."""
    leaves = _flatten(payload)[0]
    if len(leaves) != len(slot_specs):
        raise ValueError(f"{len(leaves)} leaves != {len(slot_specs)}")
    coerced = []
    for (shape, dtype), leaf in zip(slot_specs, leaves):
        arr = np.asarray(leaf)
        if arr.shape != shape:
            raise ValueError(f"leaf shape {arr.shape} != {shape}")
        coerced.append(arr.astype(dtype, casting="same_kind", copy=True))
    return codec.encode(_unflatten(treedef, coerced))


class _RunnerPumpState:
    """Native-pump plumbing SHARED by the consecutive HostRunners of one
    instance loop: the one-lane RoundPump, per-round-class in-place
    mailboxes registered by pointer once per loop (not per instance), and
    the reusable send-wave buffers.  Built by _make_runner_pump; None
    anywhere in the chain keeps the Python pump."""

    __slots__ = ("pump", "send_ok", "boxes", "wave", "entries",
                 "entry_count", "lane", "mux")

    def __init__(self, pump: RoundPump, transport,
                 boxes: Dict[int, "_RoundMailbox"],
                 lane: int = 0, mux: bool = False):
        self.pump = pump
        self.send_ok = bool(getattr(transport, "pump_send_ok", False))
        self.boxes = boxes
        self.wave = bytearray()
        self.entries = bytearray()
        self.entry_count = 0
        # pump lane this runner occupies (the sequential loop always
        # lane 0; the pipelined mux hands each in-flight instance its
        # own lane) and the wait discipline that goes with it: mux=True
        # blocks in rt_pump_wait_lane — the single-waiter rt_pump_wait
        # consumes EVERY lane's reason bits, which is exactly wrong with
        # concurrent runner threads — and treats R_POKE as the router's
        # "your endpoint queue has traffic" nudge.
        self.lane = lane
        self.mux = mux

    def close(self) -> None:
        """Bank the native fast-path stats into the unified metrics
        (pump.* + host.recvs/host.malformed parity) and detach the pump
        so the plain inbox path owns the wire again (serve_decisions,
        next loop)."""
        d = self.pump.bank_metrics()
        if d[0] or d[1]:
            _C_RECVS.inc(int(d[0] + d[1]))
        if d[6]:
            # out-of-range-sender drops the event loop counted natively:
            # host.malformed must read the same whichever pump served
            _C_MALFORMED.inc(int(d[6]))
        self.pump.close()


def lane_init_state(algo: Algorithm, my_id: int, n: int, io, device):
    """One lane's initial state on ``device`` from a host io pytree (one
    host-to-device copy of the io)."""
    ctx = RoundCtx(id=torch.full((), my_id, dtype=torch.int32,
                                 device=device),
                   n=n, r=torch.zeros((), dtype=torch.int32, device=device))
    return algo.make_init_state(ctx, to_device(io, device))


def _payload_layouts(algo: Algorithm, my_id: int, n: int, device):
    """Per-round-class (payload exemplar, codec template) for the native
    pump, or None when any class's payload is outside the fixed-layout
    vocabulary.  Shapes and dtypes come from ONE call of each class's
    send on the initial state on ``device`` (round_tpu traces it with
    ``jax.eval_shape``): only the result tensors' metadata is read, so
    nothing is copied from the device, and the call's state is dropped
    (a send is pure).  Payload shapes are a fixed point across rounds
    (the lax.scan carry contract roundlint enforces), and the template's
    hole CONTENT is never compared, so zero-filled exemplars template
    identically to live traffic.  Cached on the round objects (keyed by
    n), like the round-function trios."""
    layouts = []
    state0 = None
    for rnd in algo.rounds:
        cached = getattr(rnd, "_pump_layout", None)
        if cached is not None and cached[0] == n:
            if cached[1] is None:
                return None
            layouts.append(cached[1])
            continue
        from round_tpu_torch.engine.executor import make_host_round_fns

        if state0 is None:
            state0 = lane_init_state(algo, my_id, n,
                                     instance_io(algo, 0), device)
        raw_send, _u, _g = make_host_round_fns(rnd, n, device)
        try:
            _st, payload, _d = raw_send(0, my_id, 0, state0)
            leaves, treedef = _flatten(payload)
            exemplar = _unflatten(treedef, [
                np.zeros(tuple(t.shape), dtype=_np_dtype(t.dtype))
                for t in leaves])
        except Exception:  # noqa: BLE001 — a send that fails here keeps
            # the Python pump (never break a working driver for a fast
            # path)
            rnd._pump_layout = (n, None)
            return None
        lay = codec.array_layout(exemplar)
        if lay is None:
            rnd._pump_layout = (n, None)
            return None
        rnd._pump_layout = (n, (exemplar, lay))
        layouts.append((exemplar, lay))
    return layouts


def _make_runner_pump(transport, algo: Algorithm, my_id: int, n: int,
                      nbr_byzantine: int, device
                      ) -> Optional[_RunnerPumpState]:
    """Attach the native round pump for a sequential instance loop, or
    None (Python-pump fallback) when the transport has no pump surface or
    a round class's payload is outside the fixed-byte-layout vocabulary.
    Each class's payload exemplar comes from _payload_layouts (one send
    on the init state — payload shapes are a fixed point across rounds,
    the lax.scan carry contract roundlint enforces), its codec template
    derived, and the class mailboxes registered by pointer."""
    mk = getattr(transport, "enable_pump", None)
    if mk is None:
        return None
    layouts = _payload_layouts(algo, my_id, n, device)
    if layouts is None:
        return None  # outside the fixed-layout vocabulary
    pump = mk(1, n, len(algo.rounds), nbr_byzantine)
    if pump is None:
        return None
    import types as _types

    stub = _types.SimpleNamespace(n=n, id=my_id, malformed=0)
    boxes: Dict[int, _RoundMailbox] = {}
    for c, (exemplar, (tmpl, holes)) in enumerate(layouts):
        box = _RoundMailbox(stub, legacy=False)
        box.reset(exemplar)  # allocate [n, ...] arrays + fix the sig
        for a in box.stacked:
            a.fill(0)
        box.count_arr[0] = 0
        box.pinned = True
        pump.set_class(0, c, tmpl, holes, box.stacked, mask=box.mask,
                       count=box.count_arr, per_lane=False)
        boxes[c] = box
    return _RunnerPumpState(pump, transport, boxes)


def _make_mux_pump(transport, algo: Algorithm, my_id: int, n: int,
                   nbr_byzantine: int, rate: int, device
                   ) -> Optional[List[_RunnerPumpState]]:
    """The pipelined-mux form of _make_runner_pump: ONE native pump with
    ``rate`` lanes, each in-flight instance occupying its own lane with
    its own per-class mailboxes (registered per (lane, class) — the
    runner's plain ``[n, ...]`` arrays, not the LaneDriver's ``[L, n,
    ...]`` boxes, because each mux runner still thinks per-instance).
    Runners block in rt_pump_wait_lane; the router thread stays the
    shared-inbox drainer and nudges a lane with rt_pump_poke when it
    routes out-of-band traffic to that lane's endpoint queue.  Returns
    one _RunnerPumpState per lane, or None for the Python-pump world."""
    mk = getattr(transport, "enable_pump", None)
    if mk is None:
        return None
    layouts = _payload_layouts(algo, my_id, n, device)
    if layouts is None:
        return None  # outside the fixed-layout vocabulary
    pump = mk(rate, n, len(algo.rounds), nbr_byzantine)
    if pump is None:
        return None
    import types as _types

    states: List[_RunnerPumpState] = []
    for lane in range(rate):
        stub = _types.SimpleNamespace(n=n, id=my_id, malformed=0)
        boxes: Dict[int, _RoundMailbox] = {}
        for c, (exemplar, (tmpl, holes)) in enumerate(layouts):
            box = _RoundMailbox(stub, legacy=False)
            box.reset(exemplar)
            for a in box.stacked:
                a.fill(0)
            box.count_arr[0] = 0
            box.pinned = True
            pump.set_class(lane, c, tmpl, holes, box.stacked,
                           mask=box.mask, count=box.count_arr,
                           per_lane=False)
            boxes[c] = box
        states.append(_RunnerPumpState(pump, transport, boxes,
                                       lane=lane, mux=True))
    return states


class HostRunner:
    """Run one replica of an Algorithm instance over the host transport.

    `peers` maps every node id (including ours) to (host, port).  The run is
    an instance in the reference sense: `instance_id` tags every packet.
    Foreign-instance NORMAL packets go to the `foreign` sink when one is
    set (the consecutive-instance driver's stash — see __init__), else
    with other-flag traffic to `default_handler` (or are dropped).

    The replica's round runs on ``device`` (the card when None; where the
    card is asked for and absent this raises).  ``rv`` is one instance's
    rv/compile.py HostRv and ``snap`` the loop's snap/driver.py
    SnapDriver."""

    def __init__(
        self,
        algo: Algorithm,
        my_id: int,
        peers: Dict[int, Tuple[str, int]],
        transport: HostTransport,
        instance_id: int = 1,
        timeout_ms: int = 200,
        seed: int = 0,
        default_handler=None,
        foreign=None,
        prefill: Optional[Dict[int, Dict[int, Any]]] = None,
        wait_cap_ms: int = 30_000,
        send_when_catching_up: bool = True,
        delay_first_send_ms: int = -1,
        nbr_byzantine: int = 0,
        adaptive: Optional[AdaptiveTimeout] = None,
        view=None,
        wire: str = "binary",
        pump_state: Optional["_RunnerPumpState"] = None,
        health=None,
        rv=None,
        snap=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.algo = algo
        self.id = my_id
        self.n = len(peers)
        self.transport = transport
        self.instance_id = instance_id & 0xFFFF
        self.timeout_ms = timeout_ms
        self.wait_cap_ms = wait_cap_ms
        # wire mode: "binary" (the hot path — codec payloads, per-peer
        # frame coalescing with a round-boundary flush, preallocated
        # in-place mailbox) or "pickle" (the seed path, kept as the A/B
        # baseline: pickle.dumps + one native send per message + dict
        # inbox).  RECEIVING is always bilingual — codec.loads routes on
        # the first byte — so mixed-mode clusters interoperate.
        if wire not in ("binary", "pickle"):
            raise ValueError(f"wire must be 'binary' or 'pickle', "
                             f"got {wire!r}")
        self.wire = wire
        self._scratch = codec.Scratch() if wire == "binary" else None
        self._sendb = (getattr(transport, "send_buffered", None)
                       if wire == "binary" else None)
        self._flushfn = (getattr(transport, "flush", None)
                         if wire == "binary" else None)
        if self._flushfn is None:
            # buffering without a flush would queue every hot-path frame
            # forever: the pair resolves TOGETHER or not at all
            self._sendb = None
        self._recv_many = getattr(transport, "recv_many", None)
        self._mbox = _RoundMailbox(self, legacy=(wire == "pickle"))
        # native round pump plumbing (run_instance_loop builds ONE
        # _RunnerPumpState for all its consecutive runners; None = the
        # Python pump below, which stays the A/B baseline and fallback).
        # Views and the catch-up-send experiment keep the Python pump:
        # epoch stamping/guarding and send suppression live there.
        self._ps = (pump_state if wire == "binary" and view is None
                    and send_when_catching_up else None)
        # adaptive round deadline (EWMA + backoff, see AdaptiveTimeout):
        # replaces the fixed timeout_ms for every round that DELEGATES its
        # Progress to the runner (the RuntimeOptions role); rounds that
        # declare their own Progress.timeout keep it — the algorithm knows
        # better than the estimator
        self.adaptive = adaptive
        # catch-up send policy (RuntimeOptions.scala:31-37 +
        # InstanceHandler.scala:169-177): when a round is entered during
        # catch-up (a peer was observed ahead of it), sending its messages
        # is optional — they arrive communication-closed-late at peers that
        # have moved on.  Default ON like the reference.
        self.send_when_catching_up = send_when_catching_up
        # stagger this replica's first send (delayFirstSend, used by the
        # reference's tests to force start skew)
        self.delay_first_send_ms = delay_first_send_ms
        self.suppressed_sends = 0   # rounds whose send was skipped
        # f for the byzantine catch-up rule (InstanceHandler.scala:302-307):
        # with f > 0 the catch-up target is the (f+1)-th highest observed
        # round, so up to f lying peers cannot drag this replica forward
        if not 0 <= nbr_byzantine < self.n:
            raise ValueError(
                f"nbr_byzantine={nbr_byzantine} must be in [0, n={self.n})")
        self.nbr_byzantine = nbr_byzantine
        # view subsystem hook (runtime/view.py ViewManager): stamps the
        # view epoch onto outgoing NORMAL tags, guards incoming ones, and
        # routes FLAG_VIEW catch-ups; None = the epoch-less single-view
        # world every pre-view deployment ran in
        self.view = view
        self.seed = seed
        self.default_handler = default_handler
        # sink for NORMAL messages of other instances: a consecutive-
        # instance driver (PerfTest2's loop) stashes them and prefills the
        # next runner — without it, start-skew between replicas drops the
        # fast node's round-0 send and the slow node burns a full timeout
        # every instance (the reference solves this with defaultHandler's
        # lazy join, PerfTest2.scala:72-110)
        self.foreign = foreign
        # peer quarantine scorer (runtime/health.py PeerHealth): shared
        # across consecutive runners like AdaptiveTimeout — a peer's
        # health does not reset between instances.  None = the polite
        # pre-overload world (zero behavior change).
        self._health = health
        self._rv = rv
        self._rv_replied: Dict[Tuple[int, int], float] = {}
        self._snap = snap
        self._snap_shed = False
        self.malformed = 0
        self.timeouts = 0   # rounds ended by deadline expiry (diagnostics)
        self._trajectory: List[int] = []   # per-round deadline used (ms)
        self._delegated_timeout = False    # set by _round_progress
        for pid, (host, port) in peers.items():
            if pid != my_id:
                transport.add_peer(pid, host, port)
        # round -> {sender: payload}; early messages wait here
        self._pending: Dict[int, Dict[int, Any]] = dict(prefill or {})

    def _loads(self, raw) -> Tuple[bool, Any]:
        """Deserialize a wire payload, tolerating garbage: any failure
        counts the message malformed and the caller drops it
        (InstanceHandler.scala:392-399 semantics, applied unconditionally).
        Codec frames decode zero-copy (runtime/codec.py — array leaves are
        views into the receive buffer); anything else goes through the
        RESTRICTED unpickler (transport.wire_loads): numpy/builtin
        payloads only, so a crafted __reduce__ gadget cannot execute code
        — an exception guard alone would run the attacker's payload before
        catching anything."""
        if not raw:
            return True, None
        try:
            return True, codec.loads(raw)
        except Exception as e:  # noqa: BLE001 — any garbage must be survivable
            self.malformed += 1
            _C_MALFORMED.inc()
            log.debug("node %d: dropping malformed payload (%d bytes): %s",
                      self.id, len(raw), e)
            return False, None

    def _progress_goal(self, expected) -> int:
        """The round-PROGRESS threshold: the protocol's expected message
        count capped at n, with quarantined peers excused
        (runtime/health.py) — they stop pacing the round wave; their
        frames, when they DO arrive, still land in the mailbox and still
        count toward the protocol's own quorums (which are computed
        inside the update over the full mailbox, untouched)."""
        goal = min(self.n, int(expected))
        if self._health is not None:
            goal = self._health.effective_threshold(goal)
        return goal

    def _ctx(self, r: int) -> RoundCtx:
        """Context for eager host hooks (expected_nbr_messages): plain
        ints, no rng, nothing on the device."""
        return RoundCtx(id=self.id, n=self.n, r=r)

    def _round_fns(self, rnd):
        """(pre+send, update, go-probe) for one Round at this group size
        on this runner's device (engine/executor.py::make_host_round_fns,
        shared with the port's general engine).  The cache lives ON the
        round object so every instance over the same Algorithm (the
        PerfTest2 loop) reuses the trio; there is no compile step and no
        warm-up (round_tpu traces and compiles the trio here, under the
        same lock).

        The go-probe is the per-receive Progress of the reference
        (InstanceHandler.scala:383-400): for a FoldRound it evaluates
        ``go_ahead`` over the current masked mailbox, which is how
        LastVotingEvent's fine-grained conditions (coord majority,
        non-coord immediate goAhead) run host-side; plain Rounds fall back
        to the expected_nbr_messages count (Round.scala:60-66)."""
        key = (self.n, self.device)
        cached = getattr(rnd, "_host_fns", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        # double-checked module lock: thread-mode replicas share the
        # Algorithm object and reach round 0 within milliseconds of each
        # other — an unlocked check-then-set would have every thread
        # build its own trio
        with _ROUND_FNS_LOCK:
            cached = getattr(rnd, "_host_fns", None)
            if cached is not None and cached[0] == key:
                return cached[1]
            from round_tpu_torch.engine.executor import make_host_round_fns

            fns = make_host_round_fns(rnd, self.n, self.device)
            rnd._host_fns = (key, fns)
            return fns

    def _go(self, f_go, rr, sid, seed, state, mbox) -> bool:
        """One go probe: the mailbox to the device in one copy, the
        verdict back in one."""
        vals, mask = to_device(mbox.values_mask(), self.device)
        return bool(to_numpy(f_go(rr, sid, seed, state, vals, mask)))

    def _pump_coerce_insert(self, mbox: "_RoundMailbox", sender: int,
                            raw) -> None:
        """Pump-mode bilingual slow path: a frame that missed the native
        template (legacy-pickle peer, byzantine bytes) decodes here, gets
        coerced to the slot dtypes with the mailbox's same-kind cast rule
        and re-inserted CANONICALLY under the pump lock — byte-for-byte
        the _RoundMailbox.insert semantics."""
        ok, payload = self._loads(raw)
        if not ok:
            if self._health is not None:
                self._health.note_malformed(sender)
            return
        pump = self._ps.pump
        try:
            enc = pump_coerce_encode(
                payload, [(s.shape[1:], s.dtype) for s in mbox.stacked],
                mbox.treedef)
            if pump.insert(self._ps.lane, sender, enc) < 0:
                raise ValueError("canonical re-encode missed the template")
        except Exception as e:  # noqa: BLE001 — garbage must not kill us
            self.malformed += 1
            _C_MALFORMED.inc()
            if self._health is not None:
                self._health.note_malformed(sender)
            pump.mark_malformed(self._ps.lane, sender)
            log.debug("node %d: dropping structurally-malformed payload "
                      "from %d: %s", self.id, sender, e)
        # host.recvs accounting rides the pump stats bank (rt_pump_insert
        # ticked fast/dup) — an inline inc here would double-count

    def _pump_round(self, r, rr, sid, seed, state, payload_np, dest, f_go,
                    max_rnd):
        """One round's send + accumulate through the native pump: reset/
        prefill/self-deliver the class mailbox while DISARMED, arm (which
        applies natively-buffered pending frames for this round), ship
        the whole send fan-out in one rt_pump_flush crossing, then block
        in rt_pump_wait until goAhead / deadline / skew / misc.  Returns
        the accumulate outcome tuple of the Python path (plus the raw
        expected-message count, for quarantine blame attribution)."""
        P = RoundPump
        ps = self._ps
        pump = ps.pump
        lane = ps.lane
        rounds = self.algo.rounds
        ci = r % len(rounds)
        rnd = rounds[ci]
        mbox = ps.boxes[ci]
        mbox.reset(payload_np)
        for _sender, _payload in self._pending.pop(r, {}).items():
            mbox.insert(_sender, _payload)
        if dest[self.id]:
            # self-delivery is never suppressed (Round.scala:114-117)
            mbox.insert(self.id, payload_np)
        prog = self._round_progress(rnd)
        use_deadline = prog.is_timeout
        if use_deadline:
            _G_DEADLINE.set(prog.timeout_millis)
        expected = rnd.expected_nbr_messages(self._ctx(r), state)
        t0 = _time.monotonic()
        timedout = deadline_expired = False
        oob_decided = False

        # -- arm ------------------------------------------------------------
        thr, flags, dl, ext = 0, 0, 0, 0
        if not prog.is_go_ahead:
            if f_go is not None or prog.is_sync:
                flags |= P.F_GROWTH
            else:
                thr = self._progress_goal(expected)
            if prog.is_strict or prog.is_sync:
                flags |= P.F_STRICT
            if use_deadline:
                dl = int(prog.timeout_millis)
            else:
                dl = ext = self.wait_cap_ms
                flags |= P.F_EXTEND
        # a zero threshold with no growth wake is an already-satisfied
        # quorum (expected <= 0): same instant-end semantics as GoAhead
        instant = prog.is_go_ahead or (thr <= 0 and not flags)
        if instant:
            pump.arm(lane, r, ci, 0, 0, 0, 0)  # applies pending only
        else:
            pump.arm(lane, r, ci, thr, flags, dl, ext)

        # -- send (after arm: a fast peer's reply races only into the
        # native pending buffer, never into a torn mailbox) ---------------
        sent = 0
        if ps.send_ok:
            del ps.wave[:]
            del ps.entries[:]
            ps.entry_count = 0
            codec.encode_into(payload_np, ps.wave)
            ln = len(ps.wave)
            tagw = Tag(instance=self.instance_id,
                       round=r).pack() & 0xFFFFFFFFFFFFFFFF
            for d in range(self.n):
                if d == self.id or not dest[d]:
                    continue
                ps.entries += P._ENTRY.pack(d, tagw, 0, ln)
                ps.entry_count += 1
                sent += 1
            if sent:
                pump.flush(ps.wave, ps.entries, ps.entry_count)
        else:
            # chaos wrapper in the way: faults apply per logical frame on
            # the send_buffered surface, exactly like the Python pump
            wire = self._scratch.encode(payload_np)
            tag = Tag(instance=self.instance_id, round=r)
            for d in range(self.n):
                if d == self.id or not dest[d]:
                    continue
                if self._sendb is not None:
                    self._sendb(d, tag, wire)
                else:
                    self.transport.send(d, tag, bytes(wire))
                sent += 1
            if sent and self._sendb is not None:
                self._flushfn()
        if sent:
            _C_SENDS.inc(sent)

        # -- accumulate -----------------------------------------------------
        def go_ahead() -> bool:
            if f_go is not None:
                return self._go(f_go, rr, sid, seed, state, mbox)
            return mbox.count >= self._progress_goal(expected)

        def drain_misc() -> None:
            nonlocal state, oob_decided
            while True:
                if self._recv_many is not None:
                    got_list = self._recv_many(0)
                else:
                    got = self.transport.recv(0)
                    got_list = [got] if got is not None else []
                if not got_list:
                    return
                for got in got_list:
                    sender, tg, raw = got
                    if not 0 <= sender < self.n:
                        self.malformed += 1
                        _C_MALFORMED.inc()
                        continue
                    if tg.instance == self.instance_id \
                            and tg.flag == FLAG_NORMAL:
                        if pump.feed(sender, tg, raw) == -2:
                            self._pump_coerce_insert(mbox, sender, raw)
                    elif tg.flag == FLAG_DECISION \
                            and tg.instance == self.instance_id:
                        ok, p = self._loads(raw)
                        if ok and p is not None and self._rv is not None:
                            # agreement check before adoption
                            self._rv.on_decision_frame(state, p, r)
                        adopted = (self.algo.adopt_decision(state, p)
                                   if ok else None)
                        if adopted is not None:
                            state = adopted
                            oob_decided = True
                            _C_OOB.inc()
                            if TRACE.enabled:
                                TRACE.emit("recv_decision", node=self.id,
                                           inst=self.instance_id, round=r,
                                           src=sender)
                    elif tg.flag == FLAG_NACK:
                        _C_NACKS_SEEN.inc()
                        if TRACE.enabled:
                            TRACE.emit("nack_seen", node=self.id,
                                       inst=tg.instance, src=sender)
                    elif tg.flag == FLAG_SNAP and self._snap is not None:
                        # a snapshot sample off the pump's misc path
                        self._snap.on_frame(sender, tg, raw)
                    elif tg.flag == FLAG_NORMAL and self.foreign is not None:
                        ok, p = self._loads(raw)
                        if ok:
                            self.foreign(sender, tg, p)
                    elif self.default_handler is not None:
                        ok, p = self._loads(raw)
                        if ok:
                            self.default_handler(Message(
                                sender=sender, tag=tg, payload=p))

        if instant:
            # queued frames were applied at arm; one misc sweep mirrors
            # the Python path's pre-update drain, then the round ends
            if ps.mux:
                # mux mode: the router thread owns the shared inbox; our
                # misc traffic is whatever it routed to the endpoint
                # queue (drain unconditionally — a nowait queue poll)
                pump.wait_lane(lane, 0)
                drain_misc()
            else:
                _n, misc = pump.wait(0)
                if misc:
                    drain_misc()
            pump.disarm(lane)
            return (state, mbox, prog, use_deadline, t0, timedout,
                    deadline_expired, oob_decided, expected)

        if flags & P.F_GROWTH:
            # initial probe, mirroring the Python loop's dirty=True first
            # iteration: prefill/self-delivery/natively-applied pending
            # may ALREADY satisfy the go condition or sync barrier, and
            # the native side raises no GROWTH wake for frames applied at
            # arm — without this a satisfied round would sit out its
            # whole deadline
            go = f_go is not None and go_ahead()
            if not go and prog.is_sync and int((max_rnd >= r).sum()) \
                    >= prog.k + self.nbr_byzantine:
                go = True
            if go:
                pump.disarm(lane)
                return (state, mbox, prog, use_deadline, t0, timedout,
                        deadline_expired, oob_decided, expected)

        if ps.mux:
            # frames routed to the endpoint queue between our rounds
            # (while this lane was disarmed) raised pokes we may have
            # consumed at arm: one nowait sweep closes the race
            drain_misc()
            if oob_decided:
                # same discipline as every oob exit below: stop native
                # mailbox writes before Python touches the mailbox (the
                # wait loop is skipped, so IT can't disarm for us)
                pump.disarm(lane)

        while not oob_decided:
            if ps.mux:
                # per-lane wait: rt_pump_wait_lane consumes only THIS
                # lane's reason bits (the global rt_pump_wait would
                # steal every concurrent runner's wakes); R_POKE is the
                # router's out-of-band nudge — our endpoint queue has
                # traffic (FLAG_DECISION, template misses) to drain
                rs = pump.wait_lane(lane, 10_000)
                if rs < 0:
                    break  # transport stopped under us
                if rs & P.R_POKE:
                    drain_misc()
                    if oob_decided:
                        pump.disarm(lane)
                        break
            else:
                nready, misc = pump.wait(10_000)
                if nready < 0:
                    break  # transport stopped; unwind like a timeout
                if misc:
                    drain_misc()
                    if oob_decided:
                        pump.disarm(lane)
                        break
                rs = int(pump.reasons[lane])
            if rs & P.R_THRESH:
                break
            if rs & P.R_DEADLINE:
                timedout = True
                deadline_expired = True
                self.timeouts += 1
                _C_TIMEOUTS.inc()
                if TRACE.enabled:
                    TRACE.emit(
                        "timeout", node=self.id, inst=self.instance_id,
                        round=r,
                        deadline_ms=(int(prog.timeout_millis)
                                     if use_deadline else self.wait_cap_ms),
                        kind="deadline" if use_deadline else "wait_cap",
                        heard=mbox.count)
                if not use_deadline:
                    log.warning(
                        "node %d round %d: %s was idle for %d ms; forcing "
                        "timeout (the reference would block forever)",
                        self.id, r, prog, self.wait_cap_ms)
                break
            if rs & P.R_SKEW:
                timedout = True
                _C_CATCHUP.inc()
                if TRACE.enabled:
                    TRACE.emit("catch_up", node=self.id,
                               inst=self.instance_id, round=r,
                               next_round=int(pump.next_round[lane]))
                break
            if rs & P.R_GROWTH:
                go = f_go is not None and go_ahead()
                if not go and prog.is_sync and int(
                        (max_rnd >= r).sum()) \
                        >= prog.k + self.nbr_byzantine:
                    go = True
                if go:
                    pump.disarm(lane)
                    break
        return (state, mbox, prog, use_deadline, t0, timedout,
                deadline_expired, oob_decided, expected)

    def _round_progress(self, rnd) -> Progress:
        """The round's declared Progress policy; a round that keeps the
        Round-class default delegates to the runner's configured timeout
        (the RuntimeOptions role) — fixed `timeout_ms`, or the live
        AdaptiveTimeout estimate when one is configured.  Sets
        `_delegated_timeout` so the run loop knows whether this round's
        outcome should feed the estimator."""
        p = rnd.init_progress
        if p is Round.init_progress:
            self._delegated_timeout = True
            if self.adaptive is not None:
                return Progress.timeout(self.adaptive.current_ms())
            return Progress.timeout(self.timeout_ms)
        self._delegated_timeout = False
        return p

    def run(self, io: Any, max_rounds: int = 64) -> HostResult:
        algo = self.algo
        state = lane_init_state(algo, self.id, self.n, io, self.device)
        rounds = algo.rounds
        exited = False
        r = 0
        # the round's send, issued right after the previous round's
        # update so that its payload rides in one copy with that round's
        # exit flag (see the module docstring)
        ahead = None
        # view interrupt: the ViewManager MOVED (a FLAG_VIEW catch-up was
        # adopted, or our removal discovered) — this instance runs over a
        # stale wire and must hand control back to the host loop.  Merely
        # OBSERVING a peer ahead (view.stale) does NOT interrupt: the
        # catch-up reply to our next stamped send is already on its way,
        # and bailing before ingesting it would burn the host loop's
        # bounded re-runs without ever adopting the new view
        epoch0 = self.view.epoch if self.view is not None else 0

        def view_int() -> bool:
            v = self.view
            return v is not None and (v.removed or v.epoch != epoch0)
        # benign catch-up state (InstanceHandler.scala:289-301): highest
        # round observed per peer; their max pulls this replica forward.
        # In pump mode the array is the SHARED native row — the event
        # loop writes peers' claims with no GIL held, this side only ever
        # writes its own element
        if self._ps is not None:
            for box in self._ps.boxes.values():
                box.runner = self
            self._ps.pump.open_lane(self._ps.lane, self.instance_id)
            max_rnd = self._ps.pump.max_rnd[self._ps.lane]
        else:
            max_rnd = np.full(self.n, -1, dtype=np.int64)
        max_rnd[self.id] = 0
        next_round = 0
        if self.delay_first_send_ms > 0:
            # delayFirstSend (InstanceHandler.scala:169-171): sleep before
            # the instance's first round — start-skew injection
            _time.sleep(self.delay_first_send_ms / 1000.0)
        while r < max_rounds and not exited:
            rnd = rounds[r % len(rounds)]
            if TRACE.enabled:
                TRACE.emit("round_start", node=self.id,
                           inst=self.instance_id, round=r)
            rr, sid, seed = r, self.id, self.seed
            f_send, f_update, f_go = self._round_fns(rnd)
            # the send TRANSITION always runs (it is part of the round's
            # state semantics); whether the messages go out is the policy
            if ahead is None:
                state, payload, dest_mask = f_send(rr, sid, seed, state)
                payload_np, dest = to_numpy((payload, dest_mask))
            else:
                state, payload_np, dest = ahead
                ahead = None
            if self._ps is not None:
                # NATIVE PUMP round (native/transport.cpp rt_pump_*):
                # mailbox reset + prefill + self-delivery while the
                # lane is disarmed, ONE arm (applies natively-buffered
                # pending), one flush crossing for the whole send
                # fan-out, then ONE blocking wait per wake — the
                # per-message recv loop below is the Python-pump
                # baseline arm of the A/B (apps/host_perftest --ab-pump)
                (state, mbox, prog, use_deadline, t0, timedout,
                 deadline_expired, oob_decided, expected) = self._pump_round(
                    r, rr, sid, seed, state, payload_np, dest, f_go,
                    max_rnd)
            else:
                # catching up = a peer was observed past this round
                # (InstanceHandler.scala:176: msg pending ⇒ only send when
                # sendWhenCatchingUp); our messages would arrive
                # communication-closed-late at peers already beyond r
                sending = self.send_when_catching_up or next_round <= r
                # the view epoch rides the otherwise-unused callStack byte of
                # every NORMAL frame (runtime/view.py; 0 in the epoch-less
                # world, which IS epoch 0's stamp — fully backwards-compatible)
                cs = self.view.epoch_byte if self.view is not None else 0
                if sending:
                    # encode ONCE per round into the pooled scratch (binary)
                    # or a pickle bytes (legacy); every destination ships the
                    # same buffer.  Binary sends coalesce into per-peer
                    # FLAG_BATCH frames, flushed at the end of the send loop —
                    # the round boundary of comm-closure makes this safe.
                    if self._scratch is not None:
                        wire = self._scratch.encode(payload_np)
                    else:
                        wire = pickle.dumps(payload_np)
                    tag = Tag(instance=self.instance_id, round=r, call_stack=cs)
                    sendb = self._sendb
                    sent = 0
                    for d in range(self.n):
                        if d == self.id or not dest[d]:
                            continue
                        if sendb is not None:
                            sendb(d, tag, wire)
                        else:
                            self.transport.send(
                                d, tag, wire if isinstance(wire, bytes)
                                else bytes(wire))
                        sent += 1
                        if TRACE.enabled:
                            TRACE.emit("send", node=self.id,
                                       inst=self.instance_id, round=r, dst=d,
                                       bytes=len(wire))
                    if sent:
                        if sendb is not None:  # __init__ guarantees flush too
                            self._flushfn()
                        _C_SENDS.inc(sent)
                else:
                    self.suppressed_sends += 1

                # -- accumulate (InstanceHandler.scala:164-353) ---------------
                mbox = self._mbox
                mbox.reset(payload_np)
                for _sender, _payload in self._pending.pop(r, {}).items():
                    mbox.insert(_sender, _payload)
                if dest[self.id]:
                    # self-delivery is NEVER suppressed: a replica's message to
                    # itself cannot be communication-closed-late, and dropping
                    # it would starve the full-mailbox go-ahead probe on every
                    # suppressed round — the knob suppresses WIRE sends only
                    mbox.insert(self.id, payload_np)
                prog = self._round_progress(rnd)
                block = prog.is_strict       # strict: no catch-up early-exit
                use_deadline = prog.is_timeout
                t0 = _time.monotonic()
                deadline = t0 + (prog.timeout_millis if use_deadline
                                 else self.wait_cap_ms) / 1000.0
                if use_deadline:
                    _G_DEADLINE.set(prog.timeout_millis)
                expected = rnd.expected_nbr_messages(self._ctx(r), state)
                timedout = False
                # deadline_expired ⊂ timedout: the catch-up fast-forward break
                # also flags timedout but is round SKEW, not wire latency — only
                # a true expiry may back the adaptive estimator off
                deadline_expired = False

                def go_ahead() -> bool:
                    if f_go is not None:
                        return self._go(f_go, rr, sid, seed, state, mbox)
                    return mbox.count >= self._progress_goal(expected)

                oob_decided = False

                def ingest(got, extend_deadline=True, buffer_only=False) -> bool:
                    """Route one received packet; True when THIS round's inbox
                    grew.  Shared by the blocking accumulate loop and the
                    GoAhead pre-update drain.  With buffer_only, a
                    current-round message is dropped instead of joining the
                    inbox (it is late-for-the-quorum; under the default policy
                    it would have been read next round and dropped as late, so
                    this keeps the frontier drain behavior-neutral for the
                    current round's update)."""
                    nonlocal state, deadline, next_round, oob_decided
                    sender, tag, raw = got
                    if self.view is not None:
                        # the view guard runs BEFORE the sender-range check:
                        # after a REMOVE shrinks n, a stale replica's old pid
                        # can be >= n (it dials the member that inherited its
                        # id, or — when the last pid was removed — anyone),
                        # and dropping it as malformed would starve it of the
                        # FLAG_VIEW catch-up forever.  Neither path indexes a
                        # sender-sized structure: adoption validates the
                        # payload structurally, and the reply rides the stale
                        # peer's own inbound channel (by_peer), so an
                        # arbitrary sender id is safe — at worst a garbage
                        # frame reflects one rate-limited ~100-byte reply.
                        if tag.flag == FLAG_VIEW:
                            # catch-up from a peer ahead of our view: adopt
                            # (rewire + epoch jump); view_int() then ends this
                            # instance so the host loop re-enters on the new
                            # wire
                            ok, p = self._loads(raw)
                            if ok:
                                self.view.adopt_wire(p)
                            return False
                        if (tag.flag == FLAG_NORMAL
                                and not self.view.check_epoch(sender, tag)):
                            # cross-epoch data traffic is DROPPED, never
                            # folded: a stale peer was just answered with
                            # FLAG_VIEW; an ahead peer flagged us stale
                            return False
                    if not 0 <= sender < self.n:
                        # protocol garbage on the unauthenticated socket: an
                        # out-of-range id would corrupt every downstream
                        # sender-indexed structure (stash, mailbox stacking)
                        self.malformed += 1
                        _C_MALFORMED.inc()
                        return False
                    if tag.instance != self.instance_id or tag.flag != FLAG_NORMAL:
                        if (tag.flag == FLAG_DECISION
                                and tag.instance == self.instance_id):
                            # out-of-band decision recovery (PerfTest.scala:
                            # 40-60): a peer that already decided replies to
                            # our late traffic with the value — adopt and exit
                            # instead of burning this round's timeout
                            ok, p = self._loads(raw)
                            if ok and p is not None \
                                    and self._rv is not None:
                                # the agreement term's cold site: check
                                # BEFORE adoption overwrites the state
                                # the conflict lives in
                                self._rv.on_decision_frame(state, p, r)
                            adopted = (self.algo.adopt_decision(state, p)
                                       if ok else None)
                            if adopted is not None:
                                state = adopted
                                oob_decided = True
                                _C_OOB.inc()
                                if TRACE.enabled:
                                    TRACE.emit("recv_decision", node=self.id,
                                               inst=self.instance_id, round=r,
                                               src=sender)
                        elif tag.flag == FLAG_NACK:
                            # a peer SHED our frame under admission overload
                            # (runtime/lanes.py _shed_frame): accounted, not
                            # actionable — the protocol's own retransmission
                            # is the retry, the decision-reply path the
                            # catch-up
                            _C_NACKS_SEEN.inc()
                            if TRACE.enabled:
                                TRACE.emit("nack_seen", node=self.id,
                                           inst=tag.instance, src=sender)
                        elif tag.flag == FLAG_SNAP \
                                and self._snap is not None:
                            # a snapshot sample: the collector joins it
                            self._snap.on_frame(sender, tag, raw)
                        elif tag.flag == FLAG_NORMAL and self.foreign is not None:
                            ok, p = self._loads(raw)
                            if ok:
                                self.foreign(sender, tag, p)
                        elif self.default_handler is not None:
                            ok, p = self._loads(raw)
                            if ok:
                                self.default_handler(Message(
                                    sender=sender, tag=tag, payload=p,
                                ))
                        return False
                    if tag.round > max_rnd[sender]:
                        max_rnd[sender] = tag.round
                    if tag.round < r:
                        return False  # late: the round is communication-closed
                    ok, payload = self._loads(raw)
                    if not ok:
                        if self._health is not None:
                            self._health.note_malformed(sender)
                        if TRACE.enabled:
                            TRACE.emit("malformed", node=self.id,
                                       inst=self.instance_id, round=tag.round,
                                       src=sender)
                        return False
                    if extend_deadline and not use_deadline:
                        # the wait cap is an IDLE cap: any same-instance
                        # message is progress and extends the deadline
                        deadline = _time.monotonic() + self.wait_cap_ms / 1000.0
                    if tag.round > r:
                        self._pending.setdefault(tag.round, {})[sender] = payload
                        if self.nbr_byzantine <= 0:
                            # benign catch-up: the furthest peer sets the target
                            next_round = max(next_round, int(max_rnd.max()))
                        else:
                            # byzantine catch-up (InstanceHandler.scala:302-307):
                            # drop the f highest claims — a target needs f+1
                            # attestations, so lying peers cannot drag us ahead
                            srt = np.sort(max_rnd)
                            next_round = max(
                                next_round, int(srt[-(self.nbr_byzantine + 1)]))
                        return False
                    if buffer_only:
                        return False  # post-quorum same-round: same fate as
                        # arriving next round under the default policy (late)
                    grew = mbox.insert(sender, payload)
                    _C_RECVS.inc()
                    if TRACE.enabled:
                        TRACE.emit("recv", node=self.id, inst=self.instance_id,
                                   round=r, src=sender)
                    return grew

                dirty = True  # inbox changed since the last go probe
                while not prog.is_go_ahead and not oob_decided \
                        and not view_int():
                    if dirty and go_ahead():
                        break
                    dirty = False
                    if prog.is_sync and int((max_rnd >= r).sum()) \
                            >= prog.k + self.nbr_byzantine:
                        # sync(k) barrier: f of the attestations may be lies,
                        # so the barrier needs k + f (computeSync,
                        # InstanceHandler.scala:279-287)
                        break
                    if next_round > r + 1 and not block:
                        # genuine round skew: a peer is MORE than one round
                        # ahead, so this round's window is over — fast-forward
                        # (counts as TO, :245).  A one-round lead is normal
                        # pipelining (the peer finished the round we are in and
                        # sent its next message, which can overtake a slower
                        # peer's current-round packet on another socket);
                        # breaking on it would truncate rounds to partial
                        # mailboxes microseconds before completion — measured
                        # 20x throughput loss on the PerfTest2 harness — and a
                        # 1-round-behind replica self-heals within one round
                        # timeout anyway.
                        timedout = True
                        _C_CATCHUP.inc()
                        if TRACE.enabled:
                            TRACE.emit("catch_up", node=self.id,
                                       inst=self.instance_id, round=r,
                                       next_round=int(next_round))
                        break
                    left_ms = int((deadline - _time.monotonic()) * 1000)
                    if left_ms <= 0:
                        timedout = True
                        deadline_expired = True
                        self.timeouts += 1
                        _C_TIMEOUTS.inc()
                        if TRACE.enabled:
                            TRACE.emit(
                                "timeout", node=self.id, inst=self.instance_id,
                                round=r,
                                deadline_ms=(int(prog.timeout_millis)
                                             if use_deadline
                                             else self.wait_cap_ms),
                                kind="deadline" if use_deadline else "wait_cap",
                                heard=mbox.count)
                        if not use_deadline:
                            log.warning(
                                "node %d round %d: %s was idle for "
                                "%d ms; forcing timeout (the reference would "
                                "block forever)", self.id, r, prog,
                                self.wait_cap_ms)
                        break
                    got = self.transport.recv(left_ms)
                    if got is None:
                        continue  # re-check the deadline
                    if ingest(got):
                        dirty = True
                if (prog.is_go_ahead or not self.send_when_catching_up) \
                        and not oob_decided:
                    # ONE non-blocking drain, two roles.  (a) A GoAhead round
                    # delivers messages ALREADY QUEUED in the transport before
                    # updating (the reference delivers pending messages before
                    # ending the round, InstanceHandler.scala:219-231):
                    # same-round into the inbox, future rounds into the
                    # buffer.  (b) The catch-up send policy needs the FRONTIER
                    # visible: ingestion normally stops at the quorum break,
                    # so a replica replaying a long backlog never sees the
                    # rounds ahead (the reference's one-message-at-a-time loop
                    # reads ahead by construction) — future rounds land in the
                    # pending buffer and push next_round forward.  In role (b)
                    # alone, post-quorum same-round payloads are DROPPED
                    # (buffer_only): under the default policy they would have
                    # been read next round and dropped as late, so the knob
                    # stays behavior-neutral for the current round's update.
                    # recv_many pulls EVERY queued frame in one batched native
                    # drain (transport.recv_many); transports without it (bare
                    # test doubles) fall back to the per-frame poll
                    while True:
                        if self._recv_many is not None:
                            got_list = self._recv_many(0)
                        else:
                            got = self.transport.recv(0)
                            got_list = [got] if got is not None else []
                        if not got_list:
                            break
                        for got in got_list:
                            ingest(got, extend_deadline=False,
                                   buffer_only=not prog.is_go_ahead)
                        if oob_decided or view_int():
                            break

            if use_deadline:
                self._trajectory.append(int(prog.timeout_millis))
            if self.adaptive is not None and self._delegated_timeout:
                adapted = False
                if deadline_expired:
                    self.adaptive.observe(None, expired=True)
                    adapted = True
                elif not timedout:
                    # goAhead/oob completion: the round's wall time IS the
                    # wire latency sample (skew fast-forwards teach nothing)
                    self.adaptive.observe(
                        (_time.monotonic() - t0) * 1000.0, expired=False)
                    adapted = True
                if adapted and TRACE.enabled:
                    ew = self.adaptive.ewma_ms
                    TRACE.emit("adaptive", node=self.id,
                               inst=self.instance_id, round=r,
                               expired=deadline_expired,
                               deadline_ms=self.adaptive.current_ms(),
                               ewma_ms=None if ew is None
                               else round(ew, 3))

            # -- update ---------------------------------------------------
            if view_int():
                # view boundary: do NOT fold the partial old-epoch mailbox
                # (a decision reached across the boundary could be over
                # the wrong group) — hand back undecided-so-far, the host
                # loop re-runs the instance on the new wire
                exited = True
            elif oob_decided:
                exited = True
            else:
                vals, mask = to_device(mbox.values_mask(), self.device)
                state, exit_flag = f_update(
                    rr, sid, seed, state, vals, mask,
                )
                # with monitors on, the decision plane rides the same
                # copy, and so do the state's leaves on a sampled round
                plane = ((algo.decided(state), algo.decision(state))
                         if self._rv is not None and not view_int()
                         else ())
                sample = (_flatten(state)[0]
                          if self._snap is not None and not view_int()
                          and self._snap.due(self.instance_id, r) else [])
                if r + 1 < max_rounds:
                    # the next round's send rides with the exit flag in
                    # one copy; dropped when the flag ends the run
                    nxt = self._round_fns(rounds[(r + 1) % len(rounds)])[0]
                    st_n, payload_n, dest_n = nxt(r + 1, sid, seed, state)
                    exit_np, payload_np_n, dest_np_n, sample, *plane = \
                        to_numpy((exit_flag, payload_n, dest_n, sample,
                                  *plane))
                    exited = bool(exit_np)
                    if not exited:
                        ahead = (st_n, payload_np_n, dest_np_n)
                else:
                    exit_np, sample, *plane = to_numpy(
                        (exit_flag, sample, *plane))
                    exited = bool(exit_np)
                if plane:
                    self._rv_round(bool(plane[0]), plane[1], r)
                if sample:
                    # the round boundary's post-update state (an adopted
                    # exit skipped the update: no boundary to sample)
                    self._snap.after_round(self.instance_id, r,
                                           [np.array(x) for x in sample])
            if oob_decided and self._rv is not None and not view_int():
                # an adopted decision skipped the update: check it eagerly
                from round_tpu_torch.rv.compile import _plane

                self._rv_round(*_plane(algo, state), r)
            if self._snap is not None:
                # collector housekeeping (a no-op elsewhere): a halt
                # raises here, a shed of THIS instance forces it undecided
                for iid in self._snap.flush():
                    if iid == self.instance_id & 0xFFFF:
                        self._snap_shed = True
            if self._health is not None:
                # one completed round wave of quarantine evidence: heard
                # peers decay/rejoin, unheard peers accrue timeout score
                # only when the deadline actually EXPIRED (a goAhead round
                # that didn't need peer p teaches nothing about p)
                self._health.note_round(
                    mbox.senders(), deadline_expired,
                    goal=min(self.n, int(expected)))
            _C_ROUNDS.inc()
            wall_ms = (_time.monotonic() - t0) * 1000.0
            _H_ROUND_MS.observe(wall_ms)
            if TRACE.enabled:
                # ho = the senders heard this round — the HO set of the
                # model, which is what trace_view merges across replicas
                TRACE.emit("round_end", node=self.id, inst=self.instance_id,
                           round=r, heard=mbox.count, n=self.n,
                           ho=mbox.senders(),
                           timedout=timedout, exited=exited,
                           oob=oob_decided, wall_ms=round(wall_ms, 3))
            log.debug("node %d round %d: heard %d/%d%s%s", self.id, r,
                      mbox.count, self.n, " TO" if timedout else "",
                      " exit" if exited else "")
            r += 1
            max_rnd[self.id] = r
            next_round = max(next_round, r)

        decided_np, decision = to_numpy((algo.decided(state),
                                         algo.decision(state)))
        decided = bool(decided_np)
        if view_int():
            # never report a decision across a view boundary (see above)
            decided = False
        if self._rv is not None and self._rv.shed:
            # rv 'shed' policy: a violating instance is reported
            # undecided; its decision must not enter the log
            decided = False
        if self._snap_shed:
            # snapshot 'shed' (the collector's verdict): undecided too
            decided = False
        if decided:
            _C_DECISIONS.inc()
        if TRACE.enabled:
            TRACE.emit("decision", node=self.id, inst=self.instance_id,
                       round=r, decided=decided,
                       value=decision.tolist() if decided else None)
        return HostResult(
            state=state, decided=decided, decision=decision, rounds_run=r,
            dropped_messages=self.transport.dropped,
            malformed_messages=self.malformed,
            timeouts=self.timeouts,
            timeout_trajectory=list(self._trajectory),
            stale_view=view_int(),
        )

    def _rv_round(self, decided: bool, decision, r: int) -> None:
        """One completed round's monitor verdicts (rv/compile.py HostRv)
        and, with gossip on, this replica's fresh decision broadcast: the
        agreement monitor's observability channel."""
        self._rv.after_plane(decided, decision, r)
        if self._rv.gossip and self._rv.just_decided:
            for d in range(self.n):
                if d != self.id:
                    _try_send_decision(
                        self.transport, self._rv_replied, d,
                        self.instance_id, self._rv.mon.prev_val)

    def _mailbox(self, inbox: Dict[int, Any], like: Any):
        """Stack per-sender payloads into the (values, mask) pair of
        [n, ...] host arrays the Round DSL's update expects (the
        dense-mailbox view of the wire).

        A payload that unpickled fine but has the WRONG SHAPE for this
        round (tree structure, leaf count, leaf shape/dtype) is byzantine
        garbage too — dropped per sender + counted, never a crash (the
        deserialize-failure tolerance of InstanceHandler.scala:392-399
        extended to the structural layer pickle does not check)."""
        leaves_like, treedef = _flatten(like)
        stacked = [
            np.zeros((self.n,) + np.shape(l), dtype=np.asarray(l).dtype)
            for l in leaves_like
        ]
        mask = np.zeros((self.n,), dtype=bool)
        for sender, payload in inbox.items():
            try:
                leaves = _flatten(payload)[0]
                if len(leaves) != len(stacked):
                    raise ValueError(
                        f"{len(leaves)} leaves != {len(stacked)}")
                for slot, leaf in zip(stacked, leaves):
                    arr = np.asarray(leaf)
                    if arr.shape != slot.shape[1:]:
                        raise ValueError(
                            f"leaf shape {arr.shape} != {slot.shape[1:]}")
                    slot[sender] = arr.astype(slot.dtype, casting="same_kind")
            except Exception as e:  # noqa: BLE001 — garbage must not kill us
                self.malformed += 1
                _C_MALFORMED.inc()
                mask[sender] = False
                log.debug("node %d: dropping structurally-malformed payload "
                          "from %d: %s", self.id, sender, e)
                continue
            mask[sender] = True
        return _unflatten(treedef, stacked), mask
