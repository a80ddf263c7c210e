"""Lane-batched instance serving: live consensus instances as ONE lane axis.

Port of round_tpu/runtime/lanes.py.  The per-instance drivers run one
Python round loop per instance; this module inverts the driver's control
flow so the unit of work is "one round of L instances":

  * instances are LANES of the engine's batch axis
    (engine/executor.py LaneStep): one vmapped mega-step — send/update
    over a ``[L, ...]`` state pytree with a ragged per-lane round vector
    and active mask — advances every ready instance per dispatch;
    instances at different rounds batch together when they share the
    round CLASS (``rounds[r % k]``), else bucket by class;
  * the Python host loop drains FLAG_BATCH frames into per-lane
    ``[L, n, ...]`` mailboxes, launches the mega-step and flushes per-lane
    sends, which coalesce ACROSS lanes into one container per peer per
    wave;
  * admission: instances join and retire lanes between dispatches
    (runtime/instances.py LaneTable pads to a lane-count bucket).

Equivalence contract: for the same seeds this driver gives the per-
instance drivers' decisions byte for byte — both run the same per-lane
math (engine/executor.py make_lane_round_fns, rng word included), heard
sets match under the same fault schedule (chaos faults are per LOGICAL
frame), and checkpoint/resume keeps run_instance_loop's decision-log
format.

Where the port differs from round_tpu (none of it on the wire):
  * the ``[L, ...]`` state lives on ``device`` (the card unless the caller
    passes another; where the card is asked for and absent the driver
    raises).  round_tpu keeps it in host numpy and copies all of it back
    after every dispatch.  Per round class and update wave the port makes
    ONE host-to-device copy (the mailbox, joined with the lanes' rounds
    and active mask) and ONE device-to-host copy (the exit flags, joined
    by one ``cat`` with the payload and destination rows of the NEXT
    round's send, which is issued right after the update for the lanes
    that go on — the look-ahead of runtime/host.py); on waves with exits
    one more device-to-host copy carries ``lane_decide``'s (decided,
    decision).  A tick's admissions go to the device in one copy with
    the first send's rounds and mask, and that send's payload comes back
    in one.  A FoldRound go probe is one dispatch and one copy each way
    per class with dirty waiting lanes.  Every copy is counted under
    ``host.h2d_copies``/``host.d2h_copies``;
  * no compile step and no warm-up call (engine/executor.py lane_step);
  * the rng word of lane l is the host runner's for the same instance
    (``host_lane_word(host_key_salts(seed + inst), rr, id)``), computed
    on the device (executor.lane_words);
  * runtime verification (``rv``): the monitor term runs inside the same
    update mega-step (engine/executor.py LaneStep ``monitor=``).  The
    carried monitor state is the host's: it rides the wave's one
    host-to-device copy, and the verdicts and the post-update decision
    plane join the wave's one device-to-host copy, merged into the
    carried state for the wave's lanes on the host.  Monitors add no
    copy to a wave;
  * snapshots (``snap``): the rows of the lanes a wave samples are
    gathered on the device from the update's output and ride the wave's
    one device-to-host copy (round_tpu copies rows of the host state it
    already holds); cut audits run on the collector replica's device;
  * the replicated key-value store (``kv``, a kv.store.KVShard):
    decided client instances apply to the replica's store in decision
    order from the decision rows the wave's ``lane_decide`` fetch
    already brought to the host, so kv adds no copy to a wave; FLAG_READ
    serves the three read grades and FLAG_TXN validates transaction
    records, as in round_tpu.

Not supported here (as in round_tpu): live view changes (runtime/view.py
— the sequential loop remains the membership-change driver) and the
``send_when_catching_up=False`` experiment.
"""

from __future__ import annotations

import collections
import os
import pickle
import time as _time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import Round, RoundCtx
from round_tpu_torch.engine.executor import lane_decide, lane_step
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime import codec
from round_tpu_torch.runtime.host import (
    _UNDECIDED, AdaptiveTimeout, _flatten, _save_decision_checkpoint,
    _schedule_value, _try_send_decision, _unflatten, decision_scalar,
    instance_io, lane_init_state, pump_coerce_encode, to_device, to_numpy,
)
from round_tpu_torch.runtime.instances import AdmissionControl, LaneTable
from round_tpu_torch.runtime.log import get_logger
from round_tpu_torch.runtime.oob import (
    FLAG_DECISION, FLAG_NACK, FLAG_NORMAL, FLAG_PROPOSE, FLAG_READ,
    FLAG_SNAP, FLAG_SUBSCRIBE, FLAG_TOO_LATE, FLAG_TXN,
    FLEET_MAX_INSTANCE, FLEET_MIN_INSTANCE, Tag,
)
from round_tpu_torch.runtime.transport import RoundPump
from round_tpu_torch.rv.dump import RvViolation
from round_tpu_torch.utils.device import resolve_device
from round_tpu_torch.utils.tree import tree_flatten, tree_unflatten

log = get_logger("lanes")

# lanes.* vocabulary.  host.* counters are shared with the per-instance
# drivers — same names resolve to the same instruments.
_C_DISPATCH = METRICS.counter("lanes.dispatches")
_C_SEND_D = METRICS.counter("lanes.send_dispatches")
_C_UPD_D = METRICS.counter("lanes.update_dispatches")
_C_GO_D = METRICS.counter("lanes.go_dispatches")
_C_ADMIT = METRICS.counter("lanes.admitted")
_C_RETIRE = METRICS.counter("lanes.retired")
_C_LANE_OOB = METRICS.counter("lanes.oob_decisions")
_G_OCC = METRICS.gauge("lanes.occupancy")
_G_WIDTH = METRICS.gauge("lanes.width")
_H_IPD = METRICS.histogram(
    "lanes.instances_per_dispatch",
    (1, 2, 4, 8, 16, 32, 64, 128, 256, 512), unit="instances")
_C_ROUNDS = METRICS.counter("host.rounds")
_C_SENDS = METRICS.counter("host.sends")
_C_RECVS = METRICS.counter("host.recvs")
_C_TIMEOUTS = METRICS.counter("host.timeouts")
_C_MALFORMED = METRICS.counter("host.malformed")
_C_DECISIONS = METRICS.counter("host.decisions")
_C_CATCHUP = METRICS.counter("host.catch_ups")
# stash visibility: every evicted entry counts, the live depth is a gauge
_C_STASH_EVICT = METRICS.counter("lanes.stash_evictions")
_G_STASH_DEPTH = METRICS.gauge("lanes.stash_depth")
# client-serving vocabulary (runtime/fleet.py): proposals accepted off
# the wire and decisions streamed back to clients/subscribers
_C_CLIENT_PROPS = METRICS.counter("lanes.client_proposals")
_C_CLIENT_STREAM = METRICS.counter("lanes.client_streams")
_G_CLIENT_QUEUE = METRICS.gauge("lanes.client_queue")
# overload vocabulary: every shed is accounted — shed_frames ==
# nacks_sent + nacks_suppressed
_C_SHED_FRAMES = METRICS.counter("overload.shed_frames")
_C_SHED_INSTANCES = METRICS.counter("overload.shed_instances")
_C_NACKS_SENT = METRICS.counter("overload.nacks_sent")
_C_NACKS_SUPP = METRICS.counter("overload.nacks_suppressed")
_C_NACKS_SEEN = METRICS.counter("overload.nacks_seen")
_G_QUEUED = METRICS.gauge("overload.queued_bytes")
_G_SHEDDING = METRICS.gauge("overload.shedding")
# per-tenant overload vocabulary: the same shed accounting namespaced by
# the tenant id a client frame carries in Tag.call_stack
_C_T_SHED_FRAMES = METRICS.counter("tenant.shed_frames")
_C_T_SHED_INSTANCES = METRICS.counter("tenant.shed_instances")
_C_T_NACKS_SENT = METRICS.counter("tenant.nacks_sent")
_C_T_NACKS_SUPP = METRICS.counter("tenant.nacks_suppressed")
_G_T_SHEDDING = METRICS.gauge("tenant.shedding")

_STASH_CAP = 4096  # same eviction discipline as InstanceMux._STASH_CAP
_DONE_CAP = 8192   # client-serving decision-bank cap (_retire_lane)

# per-class progress kinds (parsed once from Round.init_progress)
_P_TIMEOUT, _P_WAIT, _P_GOAHEAD, _P_SYNC = range(4)


class _ClassBox:
    """One round class's lane mailboxes on the host
    (round_tpu/runtime/lanes.py::_ClassBox): decoded payloads write IN
    PLACE into preallocated ``[L, n, ...]`` arrays + an ``[L, n]`` mask,
    the runtime/host.py _RoundMailbox grown a lane axis, which the update
    mega-step consumes after one copy to the device.  Rows are reset as
    lanes enter the class's round; the arrays live for the driver's
    lifetime.  Payload leaves are in JAX's order (host._flatten)."""

    __slots__ = ("n", "width", "treedef", "vals", "mask", "count", "_sig",
                 "on_malformed")

    def __init__(self, n: int, width: int, on_malformed=None):
        self.n, self.width = n, width
        self.treedef = None
        self.vals: List[np.ndarray] = []
        self.mask = np.zeros((width, n), dtype=bool)
        self.count = np.zeros((width,), dtype=np.int64)
        self._sig = None
        # structural-garbage sink: keeps the driver's malformed counters
        # in parity with _RoundMailbox.insert
        self.on_malformed = on_malformed

    def reset_row(self, lane: int, like: Any) -> None:
        leaves, treedef = _flatten(like)
        sig = (treedef, tuple((np.shape(x), np.asarray(x).dtype)
                              for x in leaves))
        if self._sig is None:
            self._sig = sig
            self.treedef = treedef
            self.vals = [
                np.zeros((self.width, self.n) + np.shape(x),
                         dtype=np.asarray(x).dtype)
                for x in leaves
            ]
        elif sig != self._sig:
            # payload shape is static per (algorithm, round class, n) —
            # a mismatch is a driver bug, not wire garbage
            raise RuntimeError(
                f"round-class payload signature changed mid-run: {sig} "
                f"!= {self._sig}")
        for a in self.vals:
            a[lane] = 0
        self.mask[lane] = False
        self.count[lane] = 0

    def insert(self, lane: int, sender: int, payload: Any) -> bool:
        """Write one sender's payload into (lane, sender); True when the
        lane's heard-set grew.  Structural garbage (wrong tree/leaf
        shape/dtype) drops per sender."""
        try:
            leaves = _flatten(payload)[0]
            if len(leaves) != len(self.vals):
                raise ValueError(
                    f"{len(leaves)} leaves != {len(self.vals)}")
            for slot, leaf in zip(self.vals, leaves):
                arr = np.asarray(leaf)
                if arr.shape != slot.shape[2:]:
                    raise ValueError(
                        f"leaf shape {arr.shape} != {slot.shape[2:]}")
                slot[lane, sender] = arr.astype(slot.dtype,
                                                casting="same_kind")
        except Exception as e:  # noqa: BLE001 — garbage must not kill us
            if self.mask[lane, sender]:
                self.mask[lane, sender] = False
                self.count[lane] -= 1
            for slot in self.vals:
                slot[lane, sender] = 0
            if self.on_malformed is not None:
                self.on_malformed(sender)
            log.debug("lane %d: dropping structurally-malformed payload "
                      "from %d: %s", lane, sender, e)
            return False
        if not self.mask[lane, sender]:
            self.mask[lane, sender] = True
            self.count[lane] += 1
            return True
        return False

    def values_mask(self):
        return _unflatten(self.treedef, self.vals), self.mask


class _IntakeQueue:
    """Client-proposal intake, namespaced by tenant
    (round_tpu/runtime/lanes.py::_IntakeQueue): one FIFO deque per tenant
    plus a global arrival sequence.  ``pop_fifo`` follows strict arrival
    order across every deque; the weighted-fair path pops one tenant's
    head and meters queued BYTES per tenant."""

    __slots__ = ("_q", "_bytes", "_len", "_seq")

    def __init__(self):
        self._q: Dict[int, collections.deque] = {}
        self._bytes: Dict[int, int] = {}
        self._len = 0
        self._seq = 0

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def push(self, tenant: int, iid: int, io, sender: int,
             nbytes: int) -> None:
        q = self._q.get(tenant)
        if q is None:
            q = self._q[tenant] = collections.deque()
        q.append((self._seq, iid, io, sender, nbytes))
        self._seq += 1
        self._bytes[tenant] = self._bytes.get(tenant, 0) + int(nbytes)
        self._len += 1

    def append(self, item) -> None:
        """A 3-tuple (iid, io, sender) into the tenant-0 deque (the tests
        drive the admission path through this)."""
        iid, io, sender = item
        arr = io.get("initial_value") if isinstance(io, dict) else None
        self.push(0, iid, io, sender, int(getattr(arr, "nbytes", 0)))

    def bytes_by_tenant(self) -> Dict[int, int]:
        return dict(self._bytes)

    def tenants_queued(self) -> List[int]:
        return [t for t, q in self._q.items() if q]

    def queued(self, tenant: int) -> int:
        q = self._q.get(tenant)
        return len(q) if q else 0

    def _pop(self, tenant: int):
        q = self._q[tenant]
        _seq, iid, io, sender, nb = q.popleft()
        b = self._bytes.get(tenant, 0) - nb
        self._bytes[tenant] = b if b > 0 else 0
        if not q:
            del self._q[tenant]
            self._bytes.pop(tenant, None)
        self._len -= 1
        return iid, io, sender

    def pop_tenant(self, tenant: int):
        return self._pop(tenant)

    def pop_fifo(self):
        best_t = None
        best_seq = None
        for t, q in self._q.items():
            if q and (best_seq is None or q[0][0] < best_seq):
                best_t, best_seq = t, q[0][0]
        return (best_t,) + self._pop(best_t)

    def drain_tenant(self, tenant: int):
        out = []
        while self._q.get(tenant):
            out.append(self._pop(tenant))
        return out

    def items(self):
        """(iid, io, sender) over every queued proposal, any order."""
        for q in self._q.values():
            for _seq, iid, io, sender, _nb in q:
                yield iid, io, sender


class LaneDriver:
    """Drive up to ``lanes`` concurrent consensus instances of ONE replica
    as lanes of the engine's batch axis (round_tpu/runtime/lanes.py::
    LaneDriver; module docstring).  The driver is single-threaded and
    owns the transport drain.  The lane state lives on ``device``."""

    def __init__(
        self,
        algo: Algorithm,
        my_id: int,
        peers: Dict[int, Tuple[str, int]],
        transport,
        lanes: int = 16,
        timeout_ms: int = 300,
        seed: int = 0,
        base_value: int = 0,
        max_rounds: int = 32,
        nbr_byzantine: int = 0,
        value_schedule: str = "mixed",
        adaptive: Optional[AdaptiveTimeout] = None,
        wire: str = "binary",
        wait_cap_ms: int = 30_000,
        use_pump: bool = True,
        admission: Optional[AdmissionControl] = None,
        health=None,
        clients=None,
        rv=None,
        snap=None,
        kv=None,
        tenants=None,
        device=None,
    ):
        if wire not in ("binary", "pickle"):
            raise ValueError(f"wire must be 'binary' or 'pickle', "
                             f"got {wire!r}")
        self.device = resolve_device(device)
        self.algo = algo
        self.id = my_id
        self.n = len(peers)
        self.transport = transport
        self.timeout_ms = timeout_ms
        self.seed = seed
        self.base_value = base_value
        self.max_rounds = max_rounds
        self.value_schedule = value_schedule
        self.adaptive = adaptive
        self.wire = wire
        self.wait_cap_ms = wait_cap_ms
        if not 0 <= nbr_byzantine < self.n:
            raise ValueError(
                f"nbr_byzantine={nbr_byzantine} must be in [0, n={self.n})")
        self.nbr_byzantine = nbr_byzantine
        for pid, (host, port) in peers.items():
            if pid != my_id:
                transport.add_peer(pid, host, port)

        self.k = len(algo.rounds)
        self.table = LaneTable(lanes)
        self.L = self.table.width
        _G_WIDTH.set(self.L)
        n, L = self.n, self.L

        # batched lane state: device leaves in JAX's leaf order
        # (utils.tree.tree_flatten), built at the first admission
        self._treedef = None
        self._state: List[torch.Tensor] = []
        # per-lane salt1 of host_key_salts(seed + inst) (salt0 is 0) on
        # the device; admissions reach it in one copy per tick (_admits,
        # written before the tick's first send)
        self._seeds_dev = torch.zeros((L,), dtype=torch.int64,
                                      device=self.device)
        self._admits: List[Tuple[int, List[np.ndarray], int]] = []
        self._rr = np.zeros((L,), dtype=np.int32)
        # the next round's send, fetched with the update's exit flags
        # (look-ahead): (payload leaves, payload treedef, dest) of the
        # fetch that holds lane l's row, None where a send must dispatch
        self._ahead: List[Optional[tuple]] = [None] * L

        # per-lane control plane
        self._inst = np.zeros((L,), dtype=np.int64)       # 0 = free slot
        self._live = np.zeros((L,), dtype=bool)
        self._need_send = np.zeros((L,), dtype=bool)
        self._waiting = np.zeros((L,), dtype=bool)
        self._dirty = np.zeros((L,), dtype=bool)
        self._deadline = np.full((L,), np.inf)
        self._t0 = np.zeros((L,))
        self._use_deadline = np.zeros((L,), dtype=bool)
        self._delegated = np.zeros((L,), dtype=bool)
        self._expected = np.full((L,), n, dtype=np.int64)
        # the RAW pre-quarantine threshold, kept for health blame
        # attribution (runtime/health.py note_round goal=)
        self._expected_raw = np.full((L,), n, dtype=np.int64)
        self._max_rnd = np.full((L, n), -1, dtype=np.int64)
        self._next_round = np.zeros((L,), dtype=np.int64)
        self._oob_done = np.zeros((L,), dtype=bool)
        self._pending: List[Dict[int, Dict[int, Any]]] = [
            {} for _ in range(L)]

        # per-class machinery
        self._boxes = [_ClassBox(n, L, on_malformed=self._note_malformed)
                       for _ in range(self.k)]
        self._steps: List[Optional[Any]] = [None] * self.k
        self._prog = [self._parse_progress(rnd) for rnd in algo.rounds]
        self._expected_static = [
            type(rnd).expected_nbr_messages is Round.expected_nbr_messages
            for rnd in algo.rounds
        ]

        # wire plumbing (the hot path shared with HostRunner)
        self._scratch = codec.Scratch() if wire == "binary" else None
        self._sendb = (getattr(transport, "send_buffered", None)
                       if wire == "binary" else None)
        self._flushfn = (getattr(transport, "flush", None)
                         if wire == "binary" else None)
        if self._flushfn is None:
            self._sendb = None
        self._recv_many = getattr(transport, "recv_many", None)

        # NATIVE ROUND PUMP (native/transport.cpp rt_pump_*): the receive
        # state machine runs inside the transport event loop, and this
        # driver blocks in ONE pump.wait per wave.  The Python pump stays
        # the A/B baseline and the fallback (no native support,
        # ROUND_TPU_PUMP=0, tracing, pickle wire, or a payload outside the
        # fixed-layout vocabulary).
        self._pump = None
        self._pump_send = False
        self._arm_specs = bytearray()
        self._arm_count = 0
        self._wave = bytearray()
        self._entries = bytearray()
        self._entry_count = 0
        self._goahead_armed: set = set()
        if (use_pump and wire == "binary" and not TRACE.enabled
                and os.environ.get("ROUND_TPU_PUMP", "1") != "0"):
            self._setup_pump()

        # instance-level bookkeeping
        self._done: Dict[int, Optional[np.ndarray]] = {}  # iid -> raw
        self._replied: Dict[Tuple[int, int], float] = {}
        self._enc_cache: Dict[int, bytes] = {}
        self._stash: Dict[int, List[Tuple[int, Tag, bytes]]] = {}
        self._stash_order: collections.deque = collections.deque()
        self._stash_count = 0  # LIVE stashed entries
        self._init_cache: Dict[Tuple, List[np.ndarray]] = {}
        self.malformed = 0
        self.timeouts = 0
        self.rounds_run = 0   # cumulative across every lane and instance
        self._trajectory: List[int] = []
        # overload hardening: admission budget + load shedding (None =
        # the polite world) and the peer-quarantine health scorer
        self._admission = admission
        self._health = health
        self._stash_bytes = 0
        self._pending_bytes = 0   # live bytes across all lanes' pending
        self._nacked: Dict[Tuple[int, int], float] = {}
        self._pending_sizes: List[Dict[int, int]] = [{} for _ in range(L)]
        self.shed_frames = 0
        self.shed_instances = 0
        self.nacks_sent = 0
        self.nacks_suppressed = 0
        # fleet client protocol (runtime/fleet.py): ``clients`` names
        # transport sender ids OUTSIDE the consensus group (the front-door
        # router) whose frames speak FLAG_PROPOSE / FLAG_SUBSCRIBE
        self._clients = frozenset(clients or ())
        # per-tenant weighted-fair admission (instances.TenantAdmission);
        # None = the tenant-blind driver
        self._tenants = tenants
        self._tenant_stats: Dict[int, Dict[str, int]] = {}
        self._proposals = _IntakeQueue()
        self._proposed: set = set()
        self._client_of: Dict[int, int] = {}
        self._subscribers: set = set()
        self.client_proposals = 0
        self.client_streams = 0
        # the canonical proposal shape/dtype: client values are validated
        # against it at the protocol boundary
        self._io_proto = (np.asarray(instance_io(algo, 0)["initial_value"])
                          if self._clients else None)
        # runtime verification (rv.dump.RvConfig): the algorithm's monitor
        # program fused into the update mega-step, and the carried state
        # (prev decided/decision, peer decision heard, the validity
        # witness rows) on the host.  None = monitors off
        self._rv = None
        self._rv_mon = None
        if rv is not None:
            from round_tpu_torch.rv.compile import monitor_program
            from round_tpu_torch.rv.dump import RvRuntime

            self._rv_mon = monitor_program(algo, n)
            if self._rv_mon is None:
                log.warning("node %d: rv requested but %s has no "
                            "decision plane to monitor; rv disabled",
                            my_id, type(algo).__name__)
            else:
                self._rv = RvRuntime(rv, node=my_id, n=n, seed=seed,
                                     max_rounds=max_rounds,
                                     device=self.device)
                (self._rv_prev_dec, self._rv_prev_val, self._rv_ext_dec,
                 self._rv_ext_val, self._rv_init) = self._rv_mon.zeros(L)
                self._rv_client_inst: set = set()
                self._rv_shed_lanes: set = set()
                self._rv_init_cache: Dict[int, np.ndarray] = {}
        # round-consistent snapshots (snap.audit.SnapConfig): sample this
        # replica's lanes at round boundaries and, on the collector
        # replica, assemble cuts and audit them.  None = snapshots off
        self._snap = None
        self._snap_rows: Dict[int, List[np.ndarray]] = {}
        if snap is not None:
            from round_tpu_torch.snap.driver import SnapDriver

            self._snap = SnapDriver(
                snap, algo, node=my_id, n=n, seed=seed,
                max_rounds=max_rounds, transport=transport,
                value_schedule=value_schedule, base_value=base_value,
                admission=admission, device=self.device)
        # replicated key-value serving (kv.store.KVShard): decided client
        # instances also apply to its per-replica store IN DECISION
        # ORDER, FLAG_READ frames serve the three read grades
        # (linearizable reads queue behind their write barrier + one
        # serve wave; lease/stale answer inline), and FLAG_TXN rides the
        # PROPOSE machinery with record validation.  None = kv off
        self._kv = kv
        self._kv_reads: List[Any] = []   # queued linearizable reads
        self._kv_wave = 0                # serve-loop wave counter
        self._kv_prev_rounds = 0         # lease-freshness deltas
        self._kv_prev_timeouts = 0

    # -- native pump setup -------------------------------------------------

    def _setup_pump(self) -> None:
        """Attach the native round pump: each round class's fixed-byte-
        layout template (host._payload_layouts), the class boxes
        pre-allocated and every (lane, class) mailbox slot registered by
        pointer.  Any miss leaves the driver on the Python pump."""
        mk = getattr(self.transport, "enable_pump", None)
        if mk is None:
            return
        from round_tpu_torch.runtime.host import _payload_layouts

        layouts = _payload_layouts(self.algo, self.id, self.n, self.device)
        if layouts is None:
            return  # outside the fixed-layout vocabulary
        pump = mk(self.L, self.n, self.k, self.nbr_byzantine)
        if pump is None:
            return
        for c, (exemplar, (tmpl, holes)) in enumerate(layouts):
            box = self._boxes[c]
            box.reset_row(0, exemplar)  # allocate [L, n, ...] + fix sig
            for a in box.vals:
                a[0] = 0
            for lane in range(self.L):
                pump.set_class(lane, c, tmpl, holes, box.vals,
                               lane_index=lane, mask=box.mask,
                               count=box.count, per_lane=True)
        self._pump = pump
        # the catch-up bookkeeping arrays are SHARED with the native side
        self._max_rnd = pump.max_rnd
        self._max_rnd.fill(-1)
        self._next_round = pump.next_round
        self._pump_send = bool(getattr(self.transport, "pump_send_ok",
                                       False))

    # -- static per-class progress ----------------------------------------

    def _parse_progress(self, rnd) -> Tuple[int, bool, int]:
        """(kind, strict, millis_or_k).  A round that keeps the Round-class
        default DELEGATES to the runner's configured timeout."""
        p = rnd.init_progress
        if p is Round.init_progress:
            return (_P_TIMEOUT, False, -1)  # -1: resolve per lane at entry
        if p.is_timeout:
            return (_P_TIMEOUT, p.is_strict, int(p.timeout_millis))
        if p.is_go_ahead:
            return (_P_GOAHEAD, False, 0)
        if p.is_sync:
            return (_P_SYNC, True, int(p.k))
        return (_P_WAIT, p.is_strict, 0)

    # -- the state on the device -------------------------------------------

    def _state_tree(self):
        return tree_unflatten(self._state, self._treedef)

    def _set_state(self, tree) -> None:
        self._state = tree_flatten(tree)[0]

    def _state_row(self, lane: int):
        """Lane ``lane``'s state as a pytree of device views."""
        self._flush_admissions()
        return tree_unflatten([leaf[lane] for leaf in self._state],
                              self._treedef)

    def _write_row(self, lane: int, leaves) -> None:
        """Overwrite lane ``lane``'s state with device leaves (the
        out-of-band adoption path; a copy on the device)."""
        self._flush_admissions()
        for dst, src in zip(self._state, leaves):
            dst[lane] = src

    def _flush_admissions(self, rr=None, active=None):
        """Write the queued admissions' init rows and seeds on the device
        by index, in ONE host-to-device copy that also carries ``rr`` and
        ``active`` when given (the first send's inputs).  Returns the
        uploaded (rr, active) tensors, or (None, None)."""
        extra = [] if rr is None else [rr, active]
        if not self._admits and not extra:
            return None, None
        if self._admits:
            idx = np.array([a[0] for a in self._admits], dtype=np.int64)
            rows = [np.stack([a[1][j] for a in self._admits])
                    for j in range(len(self._state))]
            salts = np.array([a[2] for a in self._admits], dtype=np.int64)
            up = to_device([idx, salts, *rows, *extra], self.device)
            idx_d, salts_d = up[0], up[1]
            for leaf, row in zip(self._state, up[2:2 + len(rows)]):
                leaf.index_copy_(0, idx_d, row)
            self._seeds_dev.index_copy_(0, idx_d, salts_d)
            self._admits = []
            extra_d = up[2 + len(rows):]
        else:
            extra_d = to_device(extra, self.device)
        return (extra_d[0], extra_d[1]) if extra else (None, None)

    # -- admission ---------------------------------------------------------

    def _init_leaves(self, io) -> List[np.ndarray]:
        """Per-lane init state leaves for one instance's io pytree, as
        host arrays, cached by initial-value bytes (dtype and shape in the
        key).  The init state is made on the host, as round_tpu makes it,
        and reaches the device with the tick's admissions.  An io whose
        init state does not fit the lane state the first admission
        defined raises ValueError (the caller releases the lane)."""
        v = np.asarray(io["initial_value"])
        key = (v.dtype.str, v.shape, v.tobytes())
        if len(self._init_cache) >= 512:
            # client-driven serving proposes arbitrary values: a long-
            # lived shard must not cache one init state per instance
            self._init_cache.clear()
        got = self._init_cache.get(key)
        if got is None:
            st = lane_init_state(self.algo, self.id, self.n, io, "cpu")
            leaves, spec = tree_flatten(st)
            if self._treedef is not None and (
                    spec != self._treedef
                    or [(t.shape, t.dtype) for t in leaves]
                    != [(s.shape[1:], s.dtype) for s in self._state]):
                raise ValueError(
                    f"an init state of {[tuple(t.shape) for t in leaves]} "
                    f"does not fit the lane state")
            got = to_numpy(leaves)
            if self._treedef is None:
                self._treedef = spec
                self._state = [
                    torch.zeros((self.L,) + tuple(t.shape), dtype=t.dtype,
                                device=self.device)
                    for t in leaves
                ]
            self._init_cache[key] = got
        return got

    def _rv_reset_lane(self, lane: int, inst: int, client_io) -> None:
        """Fresh monitor state for one admitted instance: no decision
        history, no peer decision heard, and the validity witness rows —
        the deterministic schedule matrix, or the client proposal
        (round_tpu/runtime/lanes.py::LaneDriver._rv_reset_lane)."""
        from round_tpu_torch.rv.compile import schedule_init_values

        iid = inst & 0xFFFF
        self._rv_prev_dec[lane] = False
        self._rv_prev_val[lane] = 0
        self._rv_ext_dec[lane] = False
        self._rv_ext_val[lane] = 0
        self._rv_shed_lanes.discard(lane)
        if client_io is not None:
            self._rv_client_inst.add(iid)
            self._rv_init[lane] = np.asarray(
                client_io["initial_value"])[None]
            return
        self._rv_client_inst.discard(iid)
        # deterministic in (schedule, base, inst), from a ~5-value domain
        key = inst % 5 if self.value_schedule in ("mixed", "uniform") \
            else inst
        got = self._rv_init_cache.get(key)
        if got is None:
            if len(self._rv_init_cache) >= 64:
                self._rv_init_cache.clear()
            got = schedule_init_values(self.algo, self.n,
                                       self.value_schedule,
                                       self.base_value, inst)
            self._rv_init_cache[key] = got
        self._rv_init[lane] = got

    def _rv_values(self, inst: int) -> List[int]:
        """The artifact ``values`` row: per-process scheduled proposals
        (zeros for a client-proposed instance)."""
        if inst & 0xFFFF in getattr(self, "_rv_client_inst", ()):
            return [0] * self.n
        return [_schedule_value(self.value_schedule, self.base_value,
                                pid, inst) for pid in range(self.n)]

    def _admit(self, inst: int, io=None) -> None:
        iid = inst & 0xFFFF
        lane = self.table.admit(iid)
        client_io = io
        if io is None:
            value = _schedule_value(self.value_schedule, self.base_value,
                                    self.id, inst)
            io = instance_io(self.algo, value)
        from round_tpu_torch.engine.scenarios import host_key_salts

        salt = host_key_salts(self.seed + inst)[1]
        self._admits.append((lane, self._init_leaves(io), salt))
        self._inst[lane] = inst
        self._rr[lane] = 0
        self._ahead[lane] = None
        self._live[lane] = True
        self._need_send[lane] = True
        self._waiting[lane] = False
        self._dirty[lane] = False
        self._oob_done[lane] = False
        if self._pump is not None:
            # maps iid -> lane natively and resets the shared catch-up rows
            self._pump.open_lane(lane, iid)
        self._max_rnd[lane] = -1
        self._max_rnd[lane, self.id] = 0
        self._next_round[lane] = 0
        self._pending[lane] = {}
        if self._rv is not None:
            self._rv_reset_lane(lane, inst, client_io)
        if self._snap is not None and client_io is not None:
            # the fleet's uniform-proposal contract: the client scalar IS
            # every pid's proposal row
            self._snap.note_client_value(
                inst, decision_scalar(
                    np.asarray(client_io["initial_value"])))
        _C_ADMIT.inc()
        _G_OCC.set(self.table.occupancy)
        if TRACE.enabled:
            TRACE.emit("lane_admit", node=self.id, inst=iid, lane=lane)
        self._pending_bytes -= sum(self._pending_sizes[lane].values())
        self._pending_sizes[lane] = {}
        # replay start-skew traffic stashed before admission — it lands
        # in pending[0]
        replay = self._stash.pop(iid, [])
        self._stash_count -= len(replay)
        self._stash_bytes -= sum(len(r[2]) for r in replay)
        _G_STASH_DEPTH.set(self._stash_count)
        for got in replay:
            self._ingest(got)

    # -- wire in -----------------------------------------------------------

    def _note_malformed(self, sender: Optional[int] = None) -> None:
        self.malformed += 1
        _C_MALFORMED.inc()
        if self._health is not None and sender is not None:
            self._health.note_malformed(sender)

    def _loads(self, raw, sender: Optional[int] = None) -> Tuple[bool, Any]:
        if not raw:
            return True, None
        try:
            return True, codec.loads(raw)
        except Exception as e:  # noqa: BLE001 — any garbage must survive
            self._note_malformed(sender)
            log.debug("node %d: dropping malformed payload (%d bytes): %s",
                      self.id, len(raw), e)
            return False, None

    def _shed_frame(self, sender: int, iid: int,
                    tenant: Optional[int] = None) -> None:
        """Refuse one future-instance frame under load shedding: counted,
        and answered with a rate-limited FLAG_NACK.  Every shed ticks
        exactly one of nacks_sent / nacks_suppressed, per tenant too."""
        self.shed_frames += 1
        _C_SHED_FRAMES.inc()
        ts = None
        if tenant is not None and self._tenants is not None:
            ts = self._tenant_stats.setdefault(
                tenant, {"shed_frames": 0, "shed_instances": 0,
                         "nacks_sent": 0, "nacks_suppressed": 0})
            ts["shed_frames"] += 1
            _C_T_SHED_FRAMES.inc()
            if TRACE.enabled:
                TRACE.emit("tenant_shed", node=self.id, inst=iid,
                           src=sender, tenant=tenant)
        now = _time.monotonic()
        if now - self._nacked.get((sender, iid), -1.0) <= 0.25:
            self.nacks_suppressed += 1
            _C_NACKS_SUPP.inc()
            if ts is not None:
                ts["nacks_suppressed"] += 1
                _C_T_NACKS_SUPP.inc()
            return
        if len(self._nacked) >= 8192:
            # the rate-limit map must not become its own overload vector
            self._nacked.clear()
        self._nacked[(sender, iid)] = now
        self.transport.send(sender, Tag(instance=iid, flag=FLAG_NACK,
                                        call_stack=tenant or 0))
        self.nacks_sent += 1
        _C_NACKS_SENT.inc()
        if ts is not None:
            ts["nacks_sent"] += 1
            _C_T_NACKS_SENT.inc()
        if TRACE.enabled:
            TRACE.emit("shed", node=self.id, inst=iid, src=sender)

    # -- fleet client protocol (runtime/fleet.py) --------------------------

    def _client_frame(self, sender: int, tag: Tag, raw) -> None:
        """One frame from a CLIENT peer (the fleet front door).  PROPOSE
        is idempotent: live/queued instances absorb it, completed ones
        answer with FLAG_DECISION / FLAG_TOO_LATE, and shedding answers
        with the accounted FLAG_NACK."""
        if tag.flag == FLAG_SUBSCRIBE:
            self._subscribers.add(sender)
            return
        if tag.flag == FLAG_READ:
            # the kv read verb: lease/stale grades answer inline from
            # applied state, linearizable reads queue behind their write
            # barrier + one serve wave and SHED like proposals under
            # admission pressure (lease/stale cost no lane)
            if self._kv is not None:
                self._kv_read_frame(sender, tag, raw)
            return
        if tag.flag == FLAG_TXN and self._kv is None:
            # the txn verb needs a kv shard to validate against
            self._note_malformed(sender)
            self.transport.send(sender, Tag(instance=tag.instance,
                                            flag=FLAG_TOO_LATE))
            return
        if tag.flag not in (FLAG_PROPOSE, FLAG_TXN):
            return  # decisions/NACKs are client->driver only downstream
        iid = tag.instance
        if not FLEET_MIN_INSTANCE <= iid <= FLEET_MAX_INSTANCE:
            # reserved-id proposals are refused at the shard boundary too
            self._note_malformed(sender)
            self.transport.send(sender,
                                Tag(instance=iid, flag=FLAG_TOO_LATE))
            return
        if iid in self._done:
            d = self._done[iid]
            if d is not None:
                _try_send_decision(self.transport, self._replied, sender,
                                   iid, d, enc_cache=self._enc_cache)
            else:
                self.transport.send(sender,
                                    Tag(instance=iid, flag=FLAG_TOO_LATE))
            return
        if self.table.lane_of(iid) is not None or iid in self._proposed:
            return  # running or queued: the retry is absorbed
        tenant = (tag.call_stack & 0xFF) if self._tenants is not None \
            else 0
        if self._tenants is not None \
                and self._tenants.is_shedding(tenant):
            self._shed_frame(sender, iid, tenant=tenant)
            return
        if ((self._admission is not None and self._admission.shedding)
                or len(self._proposals) >= _STASH_CAP):
            self._shed_frame(
                sender, iid,
                tenant=tenant if self._tenants is not None else None)
            return
        ok, payload = self._loads(raw, sender)
        if not ok or payload is None:
            if payload is None and ok:
                self._note_malformed(sender)  # empty proposal: no value
            return
        arr = np.asarray(payload)
        proto = self._io_proto
        if arr.shape != proto.shape or not np.can_cast(
                arr.dtype, proto.dtype, casting="same_kind"):
            # a proposal that can never be this algorithm's initial value
            self._note_malformed(sender)
            self.transport.send(sender,
                                Tag(instance=iid, flag=FLAG_TOO_LATE))
            return
        # own the bytes: decode is zero-copy into the receive buffer
        arr = (arr.astype(proto.dtype) if arr.dtype != proto.dtype
               else np.array(arr))
        if tag.flag == FLAG_TXN and not self._kv.is_txn_record(arr):
            # FLAG_TXN is PROPOSE's state machine plus payload
            # validation: a non-transaction record on the txn verb is
            # refused with the give-up signal
            self._note_malformed(sender)
            self.transport.send(sender,
                                Tag(instance=iid, flag=FLAG_TOO_LATE))
            return
        if self._kv is not None:
            # register the write barrier for linearizable reads
            self._kv.note_propose(iid, arr)
        self._proposals.push(tenant, iid, {"initial_value": arr}, sender,
                             arr.nbytes)
        self._proposed.add(iid)
        self._client_of[iid] = sender
        self.client_proposals += 1
        _C_CLIENT_PROPS.inc()
        _G_CLIENT_QUEUE.set(len(self._proposals))
        if TRACE.enabled:
            TRACE.emit("client_propose", node=self.id, inst=iid,
                       src=sender)

    def _stream_decision(self, iid: int, decided: bool, raw) -> None:
        """Stream one completed instance to its proposer + subscribers:
        FLAG_DECISION with the raw decision, FLAG_TOO_LATE when it
        finished undecided."""
        targets = list(self._subscribers)
        c = self._client_of.pop(iid, None)
        if c is not None and c not in self._subscribers:
            targets.append(c)
        for t in targets:
            if decided and raw is not None:
                _try_send_decision(self.transport, self._replied, t, iid,
                                   raw, enc_cache=self._enc_cache)
            else:
                self.transport.send(t, Tag(instance=iid,
                                           flag=FLAG_TOO_LATE))
            self.client_streams += 1
            _C_CLIENT_STREAM.inc()

    # -- kv serving (kv/, docs/KV.md) --------------------------------------

    def _kv_read_frame(self, sender: int, tag: Tag, raw) -> None:
        """One FLAG_READ frame: lease/stale answer inline (no lane, no
        consensus — served even while shedding), linearizable reads
        queue behind their write barrier + one serve wave, and SHED with
        the same accounted NACK as proposals under admission pressure
        (Tag.instance carries the 16-bit read id for correlation)."""
        from round_tpu_torch.kv import reads as _kvr

        req = _kvr.decode_read(bytes(raw) if raw is not None else b"")
        if req is None:
            self._note_malformed(sender)
            return
        if _kvr.serve_read(self._kv, sender, req["r"], req["k"],
                           req["g"], self.transport):
            return
        # linearizable reads cost a lane wave, so they shed per tenant
        # too (the read verb carries the tenant in call_stack)
        r_tenant = (tag.call_stack & 0xFF) if self._tenants is not None \
            else None
        if ((self._admission is not None and self._admission.shedding)
                or len(self._kv_reads) >= _STASH_CAP
                or (r_tenant is not None
                    and self._tenants.is_shedding(r_tenant))):
            self._shed_frame(sender, tag.instance, tenant=r_tenant)
            return
        self._kv.reads_lin += 1
        _kvr.C_READS[_kvr.GRADE_LIN].inc()
        self._kv_reads.append(_kvr.PendingRead(
            sender, req["r"], req["k"],
            self._kv.barrier_for(req["k"]), self._kv_wave))

    def _kv_tick(self) -> None:
        """One serve wave's kv work: advance the wave counter, feed the
        lease clock (a round wave that advanced by THRESHOLD — not
        deadline — heard a quorum inside one round trip; works on both
        the Python and native pumps, which never surface per-peer frames
        here), revoke the lease for good once the rv monitor has
        recorded any violation, and release queued linearizable reads
        whose write barrier drained at least one full wave ago."""
        from round_tpu_torch.kv import reads as _kvr

        dr = self.rounds_run - self._kv_prev_rounds
        dt = self.timeouts - self._kv_prev_timeouts
        self._kv_prev_rounds = self.rounds_run
        self._kv_prev_timeouts = self.timeouts
        # the wave is a ROUND wave, not a serve-loop iteration: a queued
        # linearizable read must see actual round progress before it
        # answers.  An idle lane table runs no rounds, so idleness itself
        # advances the wave: per-link FIFO already ordered the read after
        # every acked write's apply, and nothing is in flight
        if dr > 0 or not self.table.occupancy:
            self._kv_wave += 1
        if dr > dt:
            self._kv.lease.note_quorum()
        if (self._rv is not None
                and getattr(self._rv, "violations", None)):
            self._kv.lease.revoke()
        if not self._kv_reads:
            return
        keep = []
        for pr in self._kv_reads:
            if pr.ready(self._kv.pending, self._kv_wave):
                seq, val = self._kv.answer(pr.key)
                self.transport.send(
                    pr.sender, _kvr.read_tag(pr.rid),
                    _kvr.encode_reply(pr.rid, _kvr.ST_OK, seq, val))
            else:
                keep.append(pr)
        self._kv_reads = keep

    def _kv_fail_reads(self) -> None:
        """Best-effort on a halt: refuse every queued linearizable read
        so clients fall to their retry/give-up path immediately."""
        from round_tpu_torch.kv import reads as _kvr

        for pr in self._kv_reads:
            try:
                self.transport.send(
                    pr.sender, _kvr.read_tag(pr.rid),
                    _kvr.encode_reply(pr.rid, _kvr.ST_REFUSED, 0, b""))
            except Exception:  # noqa: BLE001 — the halt still propagates
                pass
        self._kv_reads = []

    def _ingest(self, got) -> None:
        sender, tag, raw = got
        if not 0 <= sender < self.n:
            if sender in self._clients:
                self._client_frame(sender, tag, raw)
                return
            self.malformed += 1
            _C_MALFORMED.inc()
            return
        if self._kv is not None:
            # any peer frame is lease-freshness evidence (the Python
            # pump path; the native pump feeds note_quorum via _kv_tick)
            self._kv.lease.note_peer(sender)
        if tag.flag == FLAG_NACK:
            # a peer SHED our frame: informational — the protocol's own
            # retransmission is the retry
            _C_NACKS_SEEN.inc()
            if TRACE.enabled:
                TRACE.emit("nack_seen", node=self.id, inst=tag.instance,
                           src=sender)
            return
        if tag.flag == FLAG_SNAP:
            # snapshot sample: the collector joins it into a cut, anyone
            # else drops it as wire noise
            if self._snap is not None:
                self._snap.on_frame(sender, tag, raw)
            return
        iid = tag.instance
        lane = self.table.lane_of(iid)
        if lane is None:
            if tag.flag == FLAG_DECISION and self._rv is not None:
                # agreement over the decision bank: a peer's decision for
                # an instance we completed must match ours
                self._rv_check_done(iid, raw)
                return
            if tag.flag != FLAG_NORMAL:
                return
            if iid in self._done:
                # TooLate: answer a completed instance's traffic with its
                # decision (rate-limited; encode-once via the cache)
                d = self._done[iid]
                if d is not None:
                    _try_send_decision(self.transport, self._replied,
                                       sender, iid, d,
                                       enc_cache=self._enc_cache)
                return
            if self._admission is not None and self._admission.shedding:
                self._shed_frame(sender, iid)
                return
            # future instance: stash raw until admission (FIFO-capped)
            while self._stash_count >= _STASH_CAP and self._stash_order:
                old = self._stash_order.popleft()
                bucket = self._stash.get(old)
                if bucket:
                    ev = bucket.pop(0)
                    self._stash_count -= 1
                    self._stash_bytes -= len(ev[2])
                    _C_STASH_EVICT.inc()
                    if not bucket:
                        del self._stash[old]
            if not isinstance(got[2], bytes):
                got = (got[0], got[1], bytes(got[2]))
            self._stash.setdefault(iid, []).append(got)
            self._stash_order.append(iid)
            self._stash_count += 1
            self._stash_bytes += len(got[2])
            _G_STASH_DEPTH.set(self._stash_count)
            return
        if tag.flag == FLAG_DECISION:
            ok, p = self._loads(raw, sender)
            if ok and p is not None and self._rv is not None:
                # record the peer decision for the fused agreement term
                # and check the already-decided case now: the adoption
                # below overwrites the lane before the next wave
                self._rv_note_ext(lane, p)
            adopted = (self.algo.adopt_decision(self._state_row(lane), p)
                       if ok else None)
            if adopted is not None:
                self._write_row(lane, tree_flatten(adopted)[0])
                self._oob_done[lane] = True
                _C_LANE_OOB.inc()
                if TRACE.enabled:
                    TRACE.emit("recv_decision", node=self.id, inst=iid,
                               round=int(self._rr[lane]), src=sender)
            return
        if tag.flag != FLAG_NORMAL:
            return
        if self._pump is not None:
            # pump mode: the fast path could not prove this frame safe
            # (stash replay, or a template miss); run it through the
            # native state machine, a current-round miss comes back -2
            rc = self._pump.feed(sender, tag, raw)
            if rc != -2:
                return
            self._pump_fallback_insert(lane, sender, raw)
            return
        r = int(self._rr[lane])
        if tag.round > self._max_rnd[lane, sender]:
            self._max_rnd[lane, sender] = tag.round
        if tag.round < r:
            return  # late: the round is communication-closed
        ok, payload = self._loads(raw, sender)
        if not ok:
            return
        if self._waiting[lane] and not self._use_deadline[lane]:
            # WaitForMessage/Sync cap is an IDLE cap: progress extends it
            self._deadline[lane] = _time.monotonic() + \
                self.wait_cap_ms / 1000.0
        if tag.round > r or not self._waiting[lane]:
            # future round — or current round before OUR send: buffer,
            # prefilled at round entry
            bucket = self._pending[lane].setdefault(tag.round, {})
            if sender not in bucket:
                sz = len(raw) if raw else 0
                self._pending_bytes += sz
                self._pending_sizes[lane][tag.round] = \
                    self._pending_sizes[lane].get(tag.round, 0) + sz
            bucket[sender] = payload
            if tag.round > r:
                if self.nbr_byzantine <= 0:
                    self._next_round[lane] = max(
                        int(self._next_round[lane]),
                        int(self._max_rnd[lane].max()))
                else:
                    srt = np.sort(self._max_rnd[lane])
                    self._next_round[lane] = max(
                        int(self._next_round[lane]),
                        int(srt[-(self.nbr_byzantine + 1)]))
            return
        grew = self._boxes[r % self.k].insert(lane, sender, payload)
        _C_RECVS.inc()
        if grew:
            self._dirty[lane] = True

    def _pump_fallback_insert(self, lane: int, sender: int, raw) -> None:
        """The bilingual slow path of pump mode: decode, coerce leaves to
        the slot dtypes with the mailbox's same-kind cast rule, re-encode
        CANONICALLY and insert under the pump lock."""
        ok, payload = self._loads(raw, sender)
        if not ok:
            return
        box = self._boxes[int(self._rr[lane]) % self.k]
        try:
            enc = pump_coerce_encode(
                payload, [(s.shape[2:], s.dtype) for s in box.vals],
                box.treedef)
            rc = self._pump.insert(lane, sender, enc)
            if rc < 0:
                raise ValueError("canonical re-encode missed the template")
        except Exception as e:  # noqa: BLE001 — garbage must not kill us
            self._note_malformed(sender)
            self._pump.mark_malformed(lane, sender)
            log.debug("lane %d: dropping structurally-malformed payload "
                      "from %d: %s", lane, sender, e)
            return
        # host.recvs accounting rides the pump stats bank
        if rc == 1:
            self._dirty[lane] = True

    def _drain(self, timeout_ms: int) -> int:
        if self._recv_many is not None:
            got_list = self._recv_many(timeout_ms)
        else:
            got = self.transport.recv(timeout_ms)
            got_list = [got] if got is not None else []
        for got in got_list:
            self._ingest(got)
        return len(got_list)

    # -- send wave ---------------------------------------------------------

    def _send_wave(self) -> None:
        lanes = np.nonzero(self._need_send & self._live)[0]
        if lanes.size == 0:
            return
        if self._pump is not None:
            del self._wave[:]
            del self._entries[:]
            self._entry_count = 0
            del self._arm_specs[:]
            self._arm_count = 0
        shipped = 0
        for c in sorted({int(self._rr[l]) % self.k for l in lanes}):
            group = [int(l) for l in lanes if int(self._rr[l]) % self.k == c]
            fresh = [l for l in group if self._ahead[l] is None]
            if fresh:
                self._send_class(c, fresh)
            now = _time.monotonic()
            for lane in group:
                pl_leaves, pl_tree, dest = self._ahead[lane]
                self._ahead[lane] = None
                shipped += self._begin_round(
                    c, lane,
                    _unflatten(pl_tree, [x[lane] for x in pl_leaves]),
                    dest[lane], now)
        if self._pump is not None:
            # arm BEFORE the frames hit the wire, then ONE crossing ships
            # the whole wave (or the per-frame Python path under chaos)
            if self._arm_count:
                self._pump.arm_specs(self._arm_specs, self._arm_count)
            if self._entry_count and self._pump_send:
                self._pump.flush(self._wave, self._entries,
                                 self._entry_count)
            elif shipped and self._sendb is not None:
                self._flushfn()
        elif shipped and self._sendb is not None:
            self._flushfn()

    def _send_class(self, c: int, group: List[int]) -> None:
        """One send mega-step for lanes with no look-ahead payload (fresh
        admissions): the tick's admissions, rounds and mask go to the
        device in one copy, payload and destinations come back in one."""
        step = self._step(c)
        active = np.zeros((self.L,), dtype=bool)
        active[group] = True
        rr_d, act_d = self._flush_admissions(self._rr, active)
        st, payload, dest = step.send(rr_d, self.id, self._seeds_dev,
                                      self._state_tree(), act_d)
        self._set_state(st)
        _C_SEND_D.inc()
        _C_DISPATCH.inc()
        _H_IPD.observe(len(group))
        _G_OCC.set(self.table.occupancy)
        pl_np, dest_np = to_numpy((payload, dest))
        pl_leaves, pl_tree = _flatten(pl_np)
        for lane in group:
            self._ahead[lane] = (pl_leaves, pl_tree, dest_np)

    def _begin_round(self, c: int, lane: int, payload_row, dest_row,
                     now: float) -> int:
        r = int(self._rr[lane])
        iid = int(self._inst[lane]) & 0xFFFF
        kind, strict, millis = self._prog[c]
        self._delegated[lane] = millis < 0 and kind == _P_TIMEOUT
        if self._delegated[lane]:
            millis = (self.adaptive.current_ms()
                      if self.adaptive is not None else self.timeout_ms)
        self._use_deadline[lane] = kind == _P_TIMEOUT
        if kind == _P_TIMEOUT:
            self._deadline[lane] = now + millis / 1000.0
            self._trajectory.append(int(millis))
        else:
            self._deadline[lane] = now + self.wait_cap_ms / 1000.0
        self._t0[lane] = now
        if self._expected_static[c]:
            self._expected[lane] = self.n
        else:
            ctx = RoundCtx(id=self.id, n=self.n, r=r)
            self._expected[lane] = int(to_numpy(
                self.algo.rounds[c].expected_nbr_messages(
                    ctx, self._state_row(lane))))
        self._expected_raw[lane] = min(self.n, int(self._expected[lane]))
        if self._health is not None:
            # quarantined peers are excused from the PROGRESS threshold
            self._expected[lane] = self._health.effective_threshold(
                int(self._expected_raw[lane]))
        box = self._boxes[c]
        box.reset_row(lane, payload_row)
        self._pending_bytes -= self._pending_sizes[lane].pop(r, 0)
        for sender, payload in self._pending[lane].pop(r, {}).items():
            box.insert(lane, sender, payload)
        if TRACE.enabled:
            TRACE.emit("round_start", node=self.id, inst=iid, round=r)
        sent = 0
        if dest_row.any():
            if self._pump is not None and self._pump_send:
                # encode ONCE into the wave buffer; destinations become
                # plan entries for the single rt_pump_flush crossing
                off = len(self._wave)
                codec.encode_into(payload_row, self._wave)
                ln = len(self._wave) - off
                tagw = Tag(instance=iid,
                           round=r).pack() & 0xFFFFFFFFFFFFFFFF
                for d in range(self.n):
                    if d == self.id or not dest_row[d]:
                        continue
                    self._entries += RoundPump._ENTRY.pack(d, tagw, off, ln)
                    self._entry_count += 1
                    sent += 1
            else:
                if self._scratch is not None:
                    wire = self._scratch.encode(payload_row)
                else:
                    wire = pickle.dumps(payload_row)
                tag = Tag(instance=iid, round=r)
                sendb = self._sendb
                for d in range(self.n):
                    if d == self.id or not dest_row[d]:
                        continue
                    if sendb is not None:
                        sendb(d, tag, wire)
                    else:
                        self.transport.send(
                            d, tag, wire if isinstance(wire, bytes)
                            else bytes(wire))
                    sent += 1
                    if TRACE.enabled:
                        TRACE.emit("send", node=self.id, inst=iid, round=r,
                                   dst=d, bytes=len(wire))
            if sent:
                _C_SENDS.inc(sent)
        if dest_row[self.id]:
            # self-delivery short-circuits the wire (Round.scala:114-117)
            box.insert(lane, self.id, payload_row)
        self._need_send[lane] = False
        self._waiting[lane] = True
        self._dirty[lane] = True
        if self._pump is not None:
            self._queue_arm(lane, r, c, kind, strict, millis)
        return sent

    def _queue_arm(self, lane: int, r: int, c: int, kind: int,
                   strict: bool, millis: int) -> None:
        """Append this lane's arm spec for the wave's single
        rt_pump_arm_many crossing: progress threshold / growth-wake
        flags / native deadline, mirroring _parse_progress semantics."""
        P = RoundPump
        thr, flags, dl, ext = 0, 0, 0, 0
        has_go = self._step(c).go is not None
        if kind == _P_TIMEOUT:
            dl = int(millis)
            if has_go:
                flags |= P.F_GROWTH
            else:
                thr = min(self.n, int(self._expected[lane]))
            if strict:
                flags |= P.F_STRICT
        elif kind == _P_GOAHEAD:
            # arm applies the natively-buffered pending frames; the lane
            # is ready THIS tick
            self._goahead_armed.add(lane)
        elif kind == _P_SYNC:
            flags |= P.F_GROWTH | P.F_STRICT | P.F_EXTEND
            dl = ext = self.wait_cap_ms
        else:  # _P_WAIT
            flags |= P.F_EXTEND
            dl = ext = self.wait_cap_ms
            if has_go:
                flags |= P.F_GROWTH
            else:
                thr = min(self.n, int(self._expected[lane]))
            if strict:
                flags |= P.F_STRICT
        self._arm_specs += P._ARM.pack(lane, r, c, thr, flags, dl, ext,
                                       P.R_ROUND_END)
        self._arm_count += 1

    def _step(self, c: int):
        step = self._steps[c]
        if step is None:
            step = self._steps[c] = lane_step(
                self.algo.rounds[c], self.n, self.L,
                monitor=self._rv_mon if self._rv is not None else None)
        return step

    # -- probe / update ----------------------------------------------------

    def _probe_go(self) -> Dict[int, np.ndarray]:
        """Batched FoldRound go probes: ONE dispatch per round class that
        has dirty waiting lanes, its mailbox and rounds in one copy to the
        device and the verdicts in one back."""
        out: Dict[int, np.ndarray] = {}
        for c in range(self.k):
            step = self._steps[c]
            if step is None or step.go is None:
                continue
            lanes = [l for l in np.nonzero(self._waiting & self._dirty)[0]
                     if int(self._rr[l]) % self.k == c]
            if not lanes:
                continue
            (vals, mask), rr_d = to_device(
                (self._boxes[c].values_mask(), self._rr), self.device)
            out[c] = to_numpy(step.go(rr_d, self.id, self._seeds_dev,
                                      self._state_tree(), vals, mask))
            _C_GO_D.inc()
            _C_DISPATCH.inc()
        return out

    def _ready(self) -> Tuple[List[int], List[int]]:
        """(ready lanes to update, oob lanes to finish) this tick; marks
        timedout/expired per lane via self._lane_timedout."""
        now = _time.monotonic()
        go_by_class = self._probe_go()
        ready: List[int] = []
        oob: List[int] = []
        self._lane_timedout: Dict[int, Tuple[bool, bool]] = {}
        for lane in np.nonzero(self._waiting)[0]:
            lane = int(lane)
            if self._oob_done[lane]:
                oob.append(lane)
                continue
            c = int(self._rr[lane]) % self.k
            kind, strict, _millis = self._prog[c]
            step = self._steps[c]
            go = False
            if self._dirty[lane]:
                if step is not None and step.go is not None:
                    g = go_by_class.get(c)
                    go = bool(g[lane]) if g is not None else False
                else:
                    go = (self._boxes[c].count[lane]
                          >= min(self.n, int(self._expected[lane])))
                self._dirty[lane] = False
            timedout = expired = False
            if not go:
                if kind == _P_GOAHEAD:
                    go = True  # queued messages were delivered this tick
                elif kind == _P_SYNC and int(
                        (self._max_rnd[lane] >= self._rr[lane]).sum()
                ) >= self._prog[c][2] + self.nbr_byzantine:
                    go = True
                elif (self._next_round[lane] > self._rr[lane] + 1
                        and not strict):
                    timedout = True  # genuine round skew: fast-forward
                    _C_CATCHUP.inc()
                    if TRACE.enabled:
                        TRACE.emit(
                            "catch_up", node=self.id,
                            inst=int(self._inst[lane]) & 0xFFFF,
                            round=int(self._rr[lane]),
                            next_round=int(self._next_round[lane]))
                elif now >= self._deadline[lane]:
                    timedout = expired = True
                    self.timeouts += 1
                    _C_TIMEOUTS.inc()
                    if TRACE.enabled:
                        TRACE.emit(
                            "timeout", node=self.id,
                            inst=int(self._inst[lane]) & 0xFFFF,
                            round=int(self._rr[lane]),
                            kind=("deadline" if self._use_deadline[lane]
                                  else "wait_cap"),
                            heard=int(self._boxes[c].count[lane]))
            if go or timedout:
                ready.append(lane)
                self._lane_timedout[lane] = (timedout, expired)
        return ready, oob

    def _ready_pump(self) -> Tuple[List[int], List[int]]:
        """Pump-mode readiness: the consumed native reason bits plus the
        Python-side probes (FoldRound go, Sync barriers), as _ready's
        (ready, oob) lists."""
        ready: List[int] = []
        oob: List[int] = []
        self._lane_timedout = {}
        pump = self._pump
        reasons = pump.reasons
        P = RoundPump
        for lane in np.nonzero(self._waiting)[0]:
            lane = int(lane)
            if not self._live[lane]:
                continue
            if self._oob_done[lane]:
                pump.disarm(lane)
                oob.append(lane)
                continue
            if lane in self._goahead_armed:
                self._goahead_armed.discard(lane)
                pump.disarm(lane)
                ready.append(lane)
                self._lane_timedout[lane] = (False, False)
                continue
            rs = int(reasons[lane])
            if not rs:
                continue
            if rs & P.R_THRESH:
                ready.append(lane)
                self._lane_timedout[lane] = (False, False)
                continue
            if rs & P.R_SKEW:
                _C_CATCHUP.inc()
                if TRACE.enabled:
                    TRACE.emit(
                        "catch_up", node=self.id,
                        inst=int(self._inst[lane]) & 0xFFFF,
                        round=int(self._rr[lane]),
                        next_round=int(self._next_round[lane]))
                ready.append(lane)
                self._lane_timedout[lane] = (True, False)
                continue
            if rs & P.R_DEADLINE:
                self.timeouts += 1
                _C_TIMEOUTS.inc()
                if TRACE.enabled:
                    TRACE.emit(
                        "timeout", node=self.id,
                        inst=int(self._inst[lane]) & 0xFFFF,
                        round=int(self._rr[lane]),
                        kind=("deadline" if self._use_deadline[lane]
                              else "wait_cap"),
                        heard=int(self._boxes[
                            int(self._rr[lane]) % self.k].count[lane]))
                ready.append(lane)
                self._lane_timedout[lane] = (True, True)
                continue
            if rs & (P.R_GROWTH | P.R_POKE):
                self._dirty[lane] = True
        # FoldRound go probes (one batched dispatch per class) + Sync
        # barriers for the grown lanes
        go_by_class = self._probe_go()
        for lane in np.nonzero(self._waiting & self._dirty)[0]:
            lane = int(lane)
            if lane in self._lane_timedout or self._oob_done[lane] \
                    or not self._live[lane]:
                continue
            c = int(self._rr[lane]) % self.k
            kind, _strict, kparam = self._prog[c]
            step = self._steps[c]
            go = False
            if step is not None and step.go is not None:
                g = go_by_class.get(c)
                go = bool(g[lane]) if g is not None else False
            elif kind == _P_SYNC:
                go = int((self._max_rnd[lane] >= self._rr[lane]).sum()) \
                    >= kparam + self.nbr_byzantine
            self._dirty[lane] = False
            if go:
                pump.disarm(lane)
                ready.append(lane)
                self._lane_timedout[lane] = (False, False)
        return ready, oob

    def _update_wave(self, ready: List[int]) -> List[Tuple[int, bool]]:
        """One update mega-step per round class with ready lanes; returns
        [(lane, exited)].  Per class: the mailbox, rounds and mask go to
        the device in one copy; the update runs, then the next class's
        send for the lanes that go on (not exited, under max_rounds, both
        decided on the device); the exit flags come back in one copy with
        that send's payload and destinations, which the next send wave
        ships."""
        out: List[Tuple[int, bool]] = []
        for c in sorted({int(self._rr[l]) % self.k for l in ready}):
            group = [l for l in ready if int(self._rr[l]) % self.k == c]
            active = np.zeros((self.L,), dtype=bool)
            active[group] = True
            # the carried monitor state rides this wave's one upload
            mon_up = ((self._rv_prev_dec, self._rv_prev_val,
                       self._rv_ext_dec, self._rv_ext_val, self._rv_init)
                      if self._rv is not None else ())
            (vals, mask), rr_d, act_d, *mon_d = to_device(
                (self._boxes[c].values_mask(), self._rr, active, *mon_up),
                self.device)
            if self._rv is None:
                st, ex = self._step(c).update(
                    rr_d, self.id, self._seeds_dev, self._state_tree(),
                    vals, mask, act_d)
                mon_out = ()
            else:
                st, ex, ok, dec, val = self._step(c).update(
                    rr_d, self.id, self._seeds_dev, self._state_tree(),
                    vals, mask, act_d, *mon_d)
                mon_out = (ok, dec, val)
            # the rows the snapshot policy samples at this boundary, from
            # the post-update state, ride the wave's one fetch
            due = ([l for l in group if self._snap.due(
                int(self._inst[l]), int(self._rr[l]))]
                if self._snap is not None else [])
            leaves = tree_flatten(st)[0] if due else []
            rows = [[leaf[l] for leaf in leaves] for l in due]
            rr_n = rr_d + act_d.to(torch.int32)
            go_on = act_d & ~ex & (rr_n < self.max_rounds)
            st, payload, dest = self._step((c + 1) % self.k).send(
                rr_n, self.id, self._seeds_dev, st, go_on)
            self._set_state(st)
            ex_np, pl_np, dest_np, rows_np, *mon_np = to_numpy(
                (ex, payload, dest, rows, *mon_out))
            for lane, row in zip(due, rows_np):
                self._snap_rows[lane] = [np.array(x) for x in row]
            _C_UPD_D.inc()
            _C_SEND_D.inc()
            _C_DISPATCH.inc(2)
            _H_IPD.observe(len(group))
            pl_leaves, pl_tree = _flatten(pl_np)
            for lane in group:
                exited = bool(ex_np[lane])
                out.append((lane, exited))
                if not exited and int(self._rr[lane]) + 1 < self.max_rounds:
                    self._ahead[lane] = (pl_leaves, pl_tree, dest_np)
            if mon_np:
                old_dec = self._rv_prev_dec
                # the wave's lanes carry their post-update plane forward
                self._rv_prev_dec = np.where(active, mon_np[1], old_dec)
                self._rv_prev_val[group] = mon_np[2][group]
                self._rv_after_wave(group, mon_np[0], old_dec)
        return out

    # -- runtime verification ------------------------------------------------

    def _rv_after_wave(self, group: List[int], ok: np.ndarray,
                       old_dec: np.ndarray) -> None:
        """Consume one fused wave's verdicts: gossip newly decided lanes
        (the agreement monitor's observability channel) and act on every
        tripped monitor per the policy
        (round_tpu/runtime/lanes.py::LaneDriver._rv_after_wave)."""
        rv = self._rv
        rv.note_checks(len(group) * self._rv_mon.n_monitors)
        if rv.cfg.gossip:
            for lane in group:
                if self._rv_prev_dec[lane] and not old_dec[lane]:
                    iid = int(self._inst[lane]) & 0xFFFF
                    val = self._rv_prev_val[lane]
                    for d in range(self.n):
                        if d != self.id:
                            _try_send_decision(
                                self.transport, self._replied, d, iid,
                                val, enc_cache=self._enc_cache)
        # lanes outside the group are vacuously ok
        for lane, fidx in zip(*np.nonzero(~ok)):
            self._rv_violate(int(lane), int(fidx), "mega-step")

    def _rv_violate(self, lane: int, fidx: int, where: str) -> None:
        inst = int(self._inst[lane])
        observed = {
            "decided": bool(self._rv_prev_dec[lane]),
            "decision": decision_scalar(self._rv_prev_val[lane]),
            "ext_decided": bool(self._rv_ext_dec[lane]),
            "ext_decision": decision_scalar(self._rv_ext_val[lane]),
        }
        # violate() raises RvViolation itself under the halt policy
        action = self._rv.violate(
            inst=inst, round_=int(self._rr[lane]),
            label=self._rv_mon.labels[fidx],
            values=self._rv_values(inst), observed=observed, where=where)
        if action == "shed":
            self._rv_shed_lanes.add(lane)

    def _rv_check_oob(self, lane: int, row) -> np.ndarray:
        """Eager verdicts on an oob-adopted lane (the cold-path twin of
        the fused term); returns the lane's decision."""
        from round_tpu_torch.rv.compile import eager_verdicts

        self._rv.note_checks(self._rv_mon.n_monitors)
        tripped, decided, decision = eager_verdicts(
            self._rv_mon, row, bool(self._rv_prev_dec[lane]),
            self._rv_prev_val[lane], bool(self._rv_ext_dec[lane]),
            self._rv_ext_val[lane], self._rv_init[lane])
        self._rv_prev_dec[lane] = decided
        self._rv_prev_val[lane] = decision
        for fidx in tripped:
            self._rv_violate(lane, int(fidx), "oob-adopt")
        return decision

    def _rv_note_ext(self, lane: int, payload) -> None:
        """A FLAG_DECISION arrived for a LIVE lane: record the peer's
        decision for the fused agreement term, and check the
        already-decided case here, since the adoption that follows
        overwrites the lane before the next wave."""
        p = self._rv_mon
        try:
            v = np.asarray(payload, dtype=p.decision_dtype).reshape(
                p.decision_shape)
        except Exception:  # noqa: BLE001 — a garbage decision frame is
            return         # the adoption path's problem, not rv's
        self._rv_ext_dec[lane] = True
        self._rv_ext_val[lane] = v
        agree = p.slot_index("agreement")
        if agree is not None and self._rv_prev_dec[lane] \
                and not np.array_equal(v, self._rv_prev_val[lane]):
            self._rv_violate(lane, agree, "decision-adopt")

    def _rv_check_done(self, iid: int, raw) -> None:
        """A FLAG_DECISION arrived for a COMPLETED instance: the banked
        decision and the peer's must agree."""
        banked = self._done.get(iid)
        if banked is None:
            return
        ok, payload = self._loads(raw)
        if not ok or payload is None:
            return
        p = self._rv_mon
        agree = p.slot_index("agreement")
        if agree is None:
            return
        try:
            v = np.asarray(payload, dtype=p.decision_dtype).reshape(
                p.decision_shape)
        except Exception:  # noqa: BLE001
            return
        if not np.array_equal(v, np.asarray(banked)):
            observed = {"decided": True,
                        "decision": decision_scalar(banked),
                        "ext_decision": decision_scalar(v)}
            # raises under halt; shed has no lane left to retire
            self._rv.violate(
                inst=iid, round_=-1, label=p.labels[agree],
                values=self._rv_values(iid), observed=observed,
                where="decision-bank")

    # -- lane lifecycle ----------------------------------------------------

    def _observe_adaptive(self, lane: int, expired: bool,
                          timedout: bool) -> None:
        if self.adaptive is None or not self._delegated[lane]:
            return
        if expired:
            self.adaptive.observe(None, expired=True)
        elif not timedout:
            self.adaptive.observe(
                (_time.monotonic() - self._t0[lane]) * 1000.0,
                expired=False)

    def _retire_lane(self, lane: int, decided: bool, decision
                     ) -> Tuple[int, Optional[np.ndarray]]:
        """Release one finished lane: record the raw decision in the
        TooLate/reply bank, retire the slot, tick the counters/traces.
        Returns (inst, raw)."""
        inst = int(self._inst[lane])
        iid = inst & 0xFFFF
        raw = np.array(np.asarray(decision)) if decided else None
        self._done[iid] = raw
        if self._clients and len(self._done) > _DONE_CAP:
            # client-serving shards live indefinitely: the decision bank
            # evicts oldest-first past the cap (with its encode cache)
            while len(self._done) > _DONE_CAP:
                old = next(iter(self._done))
                del self._done[old]
                self._enc_cache.pop(old, None)
        if len(self._replied) > 8192:
            self._replied.clear()  # rate-limit map, same cap as _nacked
        if self._pump is not None:
            # the instance's late traffic flows to the inbox again, where
            # the TooLate reply lives
            self._pump.close_lane(lane)
            self._goahead_armed.discard(lane)
        self.table.retire(iid)
        if self._snap is not None:
            # the proposal-row note dies with the instance
            self._snap.forget_value(iid)
        self._live[lane] = False
        self._waiting[lane] = False
        self._need_send[lane] = False
        self._ahead[lane] = None
        self._pending[lane] = {}
        self._pending_bytes -= sum(self._pending_sizes[lane].values())
        self._pending_sizes[lane] = {}
        self._deadline[lane] = np.inf
        _C_RETIRE.inc()
        _G_OCC.set(self.table.occupancy)
        if decided:
            _C_DECISIONS.inc()
        if TRACE.enabled:
            TRACE.emit("decision", node=self.id, inst=iid,
                       round=int(self._rr[lane]), decided=decided,
                       value=(np.asarray(decision).tolist()
                              if decided else None))
            TRACE.emit("lane_retire", node=self.id, inst=iid, lane=lane,
                       decided=decided)
        return inst, raw

    def _finish_lane(self, lane: int, decided: bool, decision,
                     results: List[Optional[int]],
                     checkpoint_dir: Optional[str],
                     completed: set, instances: int) -> None:
        inst, _raw = self._retire_lane(lane, decided, decision)
        results[inst - 1] = decision_scalar(decision) if decided else None
        completed.add(inst)
        if checkpoint_dir is not None:
            step = 0
            while (step + 1) in completed:
                step += 1
            _save_decision_checkpoint(checkpoint_dir, results, step,
                                      instances)

    # -- the serving loop --------------------------------------------------

    def _admission_update(self) -> bool:
        """Re-evaluate the admission budget over every byte this driver
        has QUEUED but not consumed — stash, per-lane pending buffers and
        the native inbox backlog."""
        queued = (self._stash_bytes + self._pending_bytes
                  + int(getattr(self.transport, "inbox_bytes", 0)))
        shedding = self._admission.update(
            max(1, self.table.occupancy), queued,
            bool(getattr(self.transport, "backpressure", False)))
        _G_QUEUED.set(queued)
        _G_SHEDDING.set(1 if shedding else 0)
        return shedding

    def _tick(self, deferring: bool) -> List[Tuple[int, bool, Any]]:
        """ONE serving tick, shared by run and serve: ship the send wave,
        block in the pump wait (or the Python drain), translate
        readiness, run the update mega-steps and advance rounds.  Returns
        the lanes that finished this tick as (lane, decided,
        decision-row)."""
        self._send_wave()
        if self._pump is not None:
            # ONE blocking native wait per wave; non-blocking when a lane
            # needs immediate service (a GoAhead lane, or a freshly-armed
            # dirty lane), short while admission is deferring
            nready, misc = self._pump.wait(
                0 if (self._goahead_armed
                      or bool(np.any(self._waiting & self._dirty)))
                else (50 if deferring else 2000))
            if nready < 0:
                raise RuntimeError(
                    "transport stopped under the lane driver")
            if misc or bool(
                    (self._pump.reasons & RoundPump.R_BACKPR).any()):
                self._drain(0)
            ready, oob = self._ready_pump()
        else:
            now = _time.monotonic()
            live_deadlines = self._deadline[self._waiting]
            if live_deadlines.size:
                wait_s = max(0.0, float(live_deadlines.min()) - now)
                timeout_ms = int(min(wait_s * 1000.0, 50.0))
            else:
                timeout_ms = 50
            self._drain(timeout_ms)
            ready, oob = self._ready()
        finished: List[Tuple[int, bool, Any]] = []
        for lane in oob:
            # oob adoption skips the update
            self.rounds_run += 1
            _C_ROUNDS.inc()
            row = self._state_row(lane)
            if self._rv is None:
                finished.append((lane, True,
                                 to_numpy(self.algo.decision(row))))
                continue
            # an adopted decision never reaches a fused wave: check it
            # eagerly, and the shed policy applies here too
            decision = self._rv_check_oob(lane, row)
            shed = lane in self._rv_shed_lanes
            self._rv_shed_lanes.discard(lane)
            if shed:
                self.shed_instances += 1
                _C_SHED_INSTANCES.inc()
            finished.append((lane, not shed, decision))
        if not ready:
            return finished
        exits = self._update_wave(ready)
        finishing = []
        for lane, exited in exits:
            timedout, expired = self._lane_timedout.get(
                lane, (False, False))
            self._observe_adaptive(lane, expired, timedout)
            if self._health is not None:
                c0 = int(self._rr[lane]) % self.k
                self._health.note_round(
                    np.nonzero(self._boxes[c0].mask[lane])[0], expired,
                    goal=int(self._expected_raw[lane]))
            self.rounds_run += 1
            _C_ROUNDS.inc()
            r = int(self._rr[lane])
            if TRACE.enabled:
                c = r % self.k
                TRACE.emit(
                    "round_end", node=self.id,
                    inst=int(self._inst[lane]) & 0xFFFF, round=r,
                    heard=int(self._boxes[c].count[lane]), n=self.n,
                    timedout=timedout, exited=exited,
                    wall_ms=round(
                        (_time.monotonic() - self._t0[lane]) * 1e3, 3))
            rows = self._snap_rows.pop(lane, None)
            if rows is not None:
                # round boundary: the post-update rows the wave fetched
                self._snap.after_round(int(self._inst[lane]), r, rows)
            if exited or r + 1 >= self.max_rounds or (
                    self._rv is not None
                    and lane in self._rv_shed_lanes):
                # rv 'shed': a lane whose monitor tripped retires now,
                # forced undecided below
                finishing.append(lane)
            else:
                self._rr[lane] = r + 1
                self._max_rnd[lane, self.id] = r + 1
                self._next_round[lane] = max(
                    int(self._next_round[lane]), r + 1)
                self._waiting[lane] = False
                self._need_send[lane] = True
        if finishing:
            decided_v, decision_v = to_numpy(
                lane_decide(self.algo, self.L)(self._state_tree()))
            for lane in finishing:
                shed = (self._rv is not None
                        and lane in self._rv_shed_lanes)
                if shed:
                    self._rv_shed_lanes.discard(lane)
                    self.shed_instances += 1
                    _C_SHED_INSTANCES.inc()
                finished.append(
                    (lane, bool(decided_v[lane]) and not shed,
                     decision_v[lane]))
        return finished

    def _bank_pump_stats(self) -> None:
        if self._pump is None:
            return
        # fold the native fast-path stats into the unified metrics
        d = self._pump.bank_metrics()
        _C_RECVS.inc(int(d[0] + d[1]))
        if d[6]:
            self.malformed += int(d[6])
            _C_MALFORMED.inc(int(d[6]))

    def _fill_stats(self, stats_out: Optional[Dict[str, int]]) -> None:
        if stats_out is None:
            return
        for key, v in (("timeouts", self.timeouts),
                       ("rounds_run", self.rounds_run),
                       ("malformed", self.malformed),
                       ("shed_frames", self.shed_frames),
                       ("shed_instances", self.shed_instances),
                       ("nacks_sent", self.nacks_sent),
                       ("nacks_suppressed", self.nacks_suppressed),
                       ("client_proposals", self.client_proposals),
                       ("client_streams", self.client_streams)):
            stats_out[key] = stats_out.get(key, 0) + v
        stats_out.setdefault("timeout_trajectory", []).extend(
            self._trajectory)
        if self._tenants is not None:
            # per-tenant shed accounting, keyed by tenant id
            ten = stats_out.setdefault("tenants", {})
            for t, d in self._tenant_stats.items():
                agg = ten.setdefault(t, {})
                for k, v in d.items():
                    agg[k] = agg.get(k, 0) + v
        if self._health is not None:
            stats_out["quarantine"] = self._health.summary()
        if self._rv is not None:
            self._rv.fill_stats(stats_out)
        if self._snap is not None:
            self._snap.fill_stats(stats_out)
        if self._kv is not None:
            self._kv.fill_stats(stats_out)

    def run(self, instances: int, checkpoint_dir: Optional[str] = None,
            stats_out: Optional[Dict[str, int]] = None,
            linger_ms: int = 0,
            ) -> List[Optional[int]]:
        """Run ``instances`` consecutive consensus instances (numbered
        1..instances, the PerfTest2 schedule) with up to the lane width in
        flight; returns the per-instance decision log like
        run_instance_loop.  With ``checkpoint_dir`` the log is durably
        checkpointed as instances complete and an existing checkpoint
        RESUMES.  ``linger_ms`` keeps answering laggards' retransmissions
        for that idle window after the schedule completes (_linger)."""
        results: List[Optional[int]] = [None] * instances
        completed: set = set()
        next_admit = 1
        if checkpoint_dir is not None:
            from round_tpu_torch.runtime import checkpoint as _ckpt

            if _ckpt.exists(checkpoint_dir):
                like = np.full(instances, _UNDECIDED, dtype=np.int64)
                arr, step, meta = _ckpt.restore(checkpoint_dir, like)
                if (meta.get("kind") != "host-decision-log"
                        or meta.get("instances") != instances
                        or not 0 <= int(step) <= instances):
                    raise _ckpt.CheckpointError(
                        f"checkpoint at {checkpoint_dir} is not a host "
                        f"decision log for an {instances}-instance run: "
                        f"meta={meta}, step={step}")
                arr = np.asarray(arr)
                vector = getattr(self.algo, "payload_bytes",
                                 None) is not None
                for i in range(1, instances + 1):
                    v = int(arr[i - 1])
                    if v != _UNDECIDED:
                        # completed AND decided; a vector algorithm's log
                        # holds digests a peer could only discard
                        results[i - 1] = v
                        completed.add(i)
                        self._done[i & 0xFFFF] = (
                            None if vector else np.asarray(v))
                    elif i <= int(step):
                        # inside the contiguous prefix: completed but
                        # undecided — do not re-run
                        completed.add(i)
                        self._done[i & 0xFFFF] = None
                log.info("node %d: resumed %d completed instance(s) from "
                         "%s", self.id, len(completed), checkpoint_dir)
        try:
            self._run_loop(instances, checkpoint_dir, results, completed,
                           next_admit)
            if linger_ms > 0:
                self._linger(linger_ms)
        finally:
            self._bank_pump_stats()
            self._fill_stats(stats_out)
        return results

    def _linger(self, linger_ms: int, max_ms: int = 120_000) -> None:
        """Keep ticking the now-empty lane table so a completed
        instance's NORMAL traffic is answered from the decision bank;
        every reply re-arms the idle window, hard-capped at ``max_ms``
        (round_tpu/runtime/lanes.py::LaneDriver._linger)."""
        window = linger_ms / 1000.0
        now = _time.monotonic()
        t_end = now + max_ms / 1000.0
        deadline = now + window
        mark = max(self._replied.values(), default=float("-inf"))
        while _time.monotonic() < min(deadline, t_end):
            self._tick(False)
            newest = max(self._replied.values(), default=float("-inf"))
            if newest > mark:
                mark = newest
                deadline = newest + window

    def _run_loop(self, instances: int, checkpoint_dir, results,
                  completed: set, next_admit: int) -> None:
        while len(completed) < instances:
            if self._admission is not None:
                self._admission_update()
            while next_admit <= instances and self.table.can_admit():
                if next_admit in completed:
                    next_admit += 1
                    continue
                if self._admission is not None \
                        and not self._admission.admit_ok():
                    now = _time.monotonic()
                    if self._admission.shed_started is None:
                        # defer first: overload is often a burst
                        self._admission.shed_started = now
                        break
                    if (now - self._admission.shed_started) * 1000.0 \
                            < self._admission.shed_deadline_ms:
                        break
                    # deadline-shed: refused outright — an explicit
                    # undecided entry + counters; its stash is purged so
                    # shedding frees its memory, and the budget is
                    # re-evaluated at once
                    inst = next_admit
                    completed.add(inst)
                    self._done[inst & 0xFFFF] = None
                    self._purge_stash(inst & 0xFFFF)
                    self.shed_instances += 1
                    self._admission.sheds += 1
                    _C_SHED_INSTANCES.inc()
                    if TRACE.enabled:
                        TRACE.emit("shed_instance", node=self.id,
                                   inst=inst)
                    next_admit += 1
                    self._admission_update()
                    continue
                self._admit(next_admit)
                next_admit += 1
            deferring = (self._admission is not None
                         and self._admission.shedding
                         and next_admit <= instances)
            for lane, decided, decision in self._tick(deferring):
                self._finish_lane(lane, decided, decision, results,
                                  checkpoint_dir, completed, instances)
            for lane in self._snap_flush():
                # snapshot 'shed': the violating instance retires
                # undecided now (halt raised inside the flush)
                self._finish_lane(
                    lane, False,
                    to_numpy(self.algo.decision(self._state_row(lane))),
                    results, checkpoint_dir, completed, instances)
        if self._snap is not None:
            # end of the schedule: resolve every pending part-cut and
            # audit the tail
            self._snap.flush(force=True)

    def _snap_flush(self, force: bool = False) -> List[int]:
        """Snapshot housekeeping: poll cut deadlines, run the batched
        audit and turn the policy's shed verdicts into LIVE lanes
        (round_tpu/runtime/lanes.py::LaneDriver._snap_flush).  A halt
        raises SnapViolation out of the flush itself."""
        if self._snap is None:
            return []
        lanes = []
        for iid in self._snap.flush(force=force):
            lane = self.table.lane_of(iid & 0xFFFF)
            if lane is not None and self._live[lane]:
                self.shed_instances += 1
                _C_SHED_INSTANCES.inc()
                lanes.append(lane)
        return lanes

    def _purge_stash(self, iid: int) -> None:
        """Drop the stashed peer frames of a shed instance, so shedding
        frees the bytes that count against the admission budget."""
        purged = self._stash.pop(iid, [])
        self._stash_count -= len(purged)
        self._stash_bytes -= sum(len(r[2]) for r in purged)
        _G_STASH_DEPTH.set(self._stash_count)

    def _tenant_instance_shed(self, tenant: int) -> None:
        ts = self._tenant_stats.setdefault(
            tenant, {"shed_frames": 0, "shed_instances": 0,
                     "nacks_sent": 0, "nacks_suppressed": 0})
        ts["shed_instances"] += 1
        _C_T_SHED_INSTANCES.inc()

    def _tenant_update(self) -> None:
        """Re-evaluate the per-tenant watermarks over each tenant's
        queued intake bytes, and deadline-shed a tenant that stayed over
        its share: only that tenant's backlog drains."""
        shedding = self._tenants.update(
            self.table.width, self._proposals.bytes_by_tenant(),
            backpressure=(self._admission is not None
                          and self._admission.shedding))
        _G_T_SHEDDING.set(len(shedding))
        now = _time.monotonic()
        for t in sorted(shedding):
            if not self._proposals.queued(t):
                continue
            started = self._tenants.shed_started.get(t)
            if started is None:
                self._tenants.shed_started[t] = now
            elif (now - started) * 1000.0 \
                    >= self._tenants.shed_deadline_ms:
                for iid, _io, sender in self._proposals.drain_tenant(t):
                    self._proposed.discard(iid)
                    self._client_of.pop(iid, None)
                    self.shed_instances += 1
                    self._tenants.sheds += 1
                    _C_SHED_INSTANCES.inc()
                    self._tenant_instance_shed(t)
                    self._shed_frame(sender, iid, tenant=t)
                _G_CLIENT_QUEUE.set(len(self._proposals))

    def _admit_proposals(self) -> None:
        """Admit queued client proposals into free lanes, under the same
        admission defer/shed discipline as the scheduled loop; with
        per-tenant metering the order is deficit-weighted round-robin
        across non-shedding tenants."""
        if self._tenants is not None:
            self._tenant_update()
        while self._proposals and self.table.can_admit():
            if self._admission is not None \
                    and not self._admission.admit_ok():
                now = _time.monotonic()
                if self._admission.shed_started is None:
                    self._admission.shed_started = now
                elif (now - self._admission.shed_started) * 1000.0 \
                        >= self._admission.shed_deadline_ms:
                    # deadline-shed the deferred backlog: every queued
                    # proposal gets an accounted NACK, and its stash is
                    # purged as the scheduled loop's shed purges it:
                    # peers' frames for a proposal that was never
                    # admitted would otherwise hold the queued bytes
                    # over the watermark, and the driver would shed
                    # every later proposal too
                    while self._proposals:
                        tenant, iid, _io, sender = \
                            self._proposals.pop_fifo()
                        self._purge_stash(iid)
                        self._proposed.discard(iid)
                        self._client_of.pop(iid, None)
                        self.shed_instances += 1
                        self._admission.sheds += 1
                        _C_SHED_INSTANCES.inc()
                        if self._tenants is not None:
                            self._tenant_instance_shed(tenant)
                            self._shed_frame(sender, iid, tenant=tenant)
                        else:
                            self._shed_frame(sender, iid)
                    _G_CLIENT_QUEUE.set(0)
                    self._admission_update()
                return
            if self._tenants is not None:
                t = self._tenants.next_tenant(
                    self._proposals.tenants_queued())
                if t is None:
                    return  # every queued tenant over budget: defer
                iid, io, sender = self._proposals.pop_tenant(t)
                self._tenants.note_admit(t)
            else:
                _t, iid, io, sender = self._proposals.pop_fifo()
            self._proposed.discard(iid)
            _G_CLIENT_QUEUE.set(len(self._proposals))
            if iid in self._done \
                    or self.table.lane_of(iid) is not None:
                continue
            try:
                self._admit(iid, io=io)
            except Exception:  # noqa: BLE001 — a garbage proposal must
                # not wedge the serving loop: counted, client told, and
                # the lane slot _admit claimed is RELEASED
                if self.table.lane_of(iid) is not None:
                    self.table.retire(iid)
                self._note_malformed(sender)
                self._client_of.pop(iid, None)
                self.transport.send(
                    sender, Tag(instance=iid, flag=FLAG_TOO_LATE))

    def _rv_fail_clients(self) -> None:
        """Best-effort client notification on an rv halt: FLAG_TOO_LATE
        for every queued proposal and live client instance (queued kv
        reads are refused too, and the lease dies with the shard)."""
        if self._kv is not None:
            self._kv.lease.revoke()
            self._kv_fail_reads()
        try:
            for iid, _io, sender in list(self._proposals.items()):
                self.transport.send(
                    sender, Tag(instance=iid, flag=FLAG_TOO_LATE))
            for lane in np.nonzero(self._live)[0]:
                iid = int(self._inst[int(lane)]) & 0xFFFF
                c = self._client_of.get(iid)
                targets = set(self._subscribers)
                if c is not None:
                    targets.add(c)
                for t in targets:
                    self.transport.send(
                        t, Tag(instance=iid, flag=FLAG_TOO_LATE))
        except Exception:  # noqa: BLE001 — the halt still propagates
            pass

    def serve(self, idle_ms: int = 4000, max_ms: int = 600_000,
              stop=None, stats_out: Optional[Dict[str, int]] = None,
              ) -> Dict[int, Optional[int]]:
        """CLIENT-DRIVEN serving (the fleet tier, runtime/fleet.py):
        instances are admitted from FLAG_PROPOSE frames sent by
        ``clients`` peers, each carrying the client's initial value;
        completed instances stream back as FLAG_DECISION /
        FLAG_TOO_LATE.  Runs until ``stop()`` returns True, ``max_ms``
        elapses, or the driver has been idle for ``idle_ms``.  Returns
        {instance: scalar decision-log entry} (None = undecided)."""
        results: Dict[int, Optional[int]] = {}
        try:
            self._serve_loop(results, idle_ms, max_ms, stop)
        finally:
            self._bank_pump_stats()
            self._fill_stats(stats_out)
        return results

    def _serve_loop(self, results: Dict[int, Optional[int]],
                    idle_ms: int, max_ms: int, stop) -> None:
        t_end = _time.monotonic() + max_ms / 1000.0
        last_active = _time.monotonic()
        while True:
            now = _time.monotonic()
            if now >= t_end or (stop is not None and stop()):
                break
            try:
                # admission replays stashed frames through _ingest, where
                # a halt can trip too: the whole serving step is covered
                if self._admission is not None:
                    self._admission_update()
                self._admit_proposals()
                deferring = (self._admission is not None
                             and self._admission.shedding
                             and bool(self._proposals))
                finished = self._tick(deferring)
            except RvViolation:
                # rv halt while client-serving: every proposer and
                # subscriber learns its in-flight instances are dead
                self._rv_fail_clients()
                raise
            for lane, decided, decision in finished:
                inst, raw = self._retire_lane(lane, decided, decision)
                iid = inst & 0xFFFF
                results[iid] = (decision_scalar(decision) if decided
                                else None)
                if self._kv is not None:
                    # apply IN DECISION ORDER before the decision
                    # streams: a client that sees its ack must find
                    # every replica's read view already reflecting it
                    self._kv.on_decision(iid, decided, raw)
                self._stream_decision(iid, decided, raw)
            if self._kv is not None:
                self._kv_tick()
            if self._snap is not None:
                try:
                    shed_lanes = self._snap_flush()
                except RvViolation:
                    # snap halt while client-serving: the same fail-fast
                    # contract as an rv halt
                    self._rv_fail_clients()
                    raise
                for lane in shed_lanes:
                    inst, _raw = self._retire_lane(lane, False, None)
                    iid = inst & 0xFFFF
                    results[iid] = None
                    if self._kv is not None:
                        self._kv.on_decision(iid, False, None)
                    self._stream_decision(iid, False, None)
            if finished or self.table.occupancy or self._proposals:
                last_active = _time.monotonic()
            elif _time.monotonic() - last_active >= idle_ms / 1000.0:
                break
        if self._snap is not None:
            try:
                # end of serving: resolve pending part-cuts, audit the tail
                self._snap.flush(force=True)
            except RvViolation:
                self._rv_fail_clients()
                raise


def run_instance_loop_lanes(
    algo: Algorithm,
    my_id: int,
    peers: Dict[int, Tuple[str, int]],
    transport,
    instances: int,
    lanes: int = 16,
    timeout_ms: int = 300,
    seed: int = 0,
    base_value: int = 0,
    max_rounds: int = 32,
    stats_out: Optional[Dict[str, int]] = None,
    nbr_byzantine: int = 0,
    value_schedule: str = "mixed",
    adaptive: Optional[AdaptiveTimeout] = None,
    checkpoint_dir: Optional[str] = None,
    wire: str = "binary",
    use_pump: bool = True,
    admission: Optional[AdmissionControl] = None,
    health=None,
    rv=None,
    snap=None,
    linger_ms: int = 0,
    device=None,
) -> List[Optional[int]]:
    """The lane-batched form of run_instance_loop
    (round_tpu/runtime/lanes.py::run_instance_loop_lanes): same schedule,
    same seeds, same decision-log shape — the work flows through one
    vmapped mega-step per round class on ``device`` instead of one Python
    round loop per instance.  ``use_pump=False`` pins the Python pump;
    ``admission``/``health`` opt in to the overload hardening;
    ``linger_ms`` answers laggards for an idle window after the schedule
    completes.  ``rv`` runs the fused monitors, ``snap`` the snapshot
    sampling and (on its collector replica) the cut audit."""
    driver = LaneDriver(
        algo, my_id, peers, transport, lanes=lanes, timeout_ms=timeout_ms,
        seed=seed, base_value=base_value, max_rounds=max_rounds,
        nbr_byzantine=nbr_byzantine, value_schedule=value_schedule,
        adaptive=adaptive, wire=wire, use_pump=use_pump,
        admission=admission, health=health, rv=rv, snap=snap,
        device=device,
    )
    return driver.run(instances, checkpoint_dir=checkpoint_dir,
                      stats_out=stats_out, linger_ms=linger_ms)
