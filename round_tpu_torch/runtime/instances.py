"""Instance multiplexing: many concurrent protocol instances as a batch axis.

Port of round_tpu/runtime/instances.py.  The reference runs one thread +
inbox per instance, routed by the 16-bit instance id of every packet
(InstanceDispatcher.scala:84-89) and recycled through a pool
(Algorithm.scala:59-86).  Here concurrent instances are a batch axis of ONE
program on the device: the dispatcher is a host-side slot table, and the
"pool" is the fixed window width (slots are recycled between run calls
just like pooled handlers).

round_tpu runs a window as ``jax.jit(jax.vmap(run_instance))``.  The port
runs it round by round, as the fuzzer runs a population
(fuzz/search.py): the window's state is ``[W, n, ...]``, each round's HO
masks come as ``[W, n, n]`` from one call of the sampler's window form
(``window_masks``) and its per-lane rng words as ``[W, n]`` from one call
of ``LocalTopology.lane_keys``, and ``executor.run_round`` runs once a
round under ``torch.func.vmap`` over the window.  The kernels launched per
window do not grow with W.  Instance ``iid`` of a window run under key
``key`` is the instance ``run_instance`` runs on ``instance_key(key,
iid)``.  The ios go to the device in one copy and the outcome comes back
in one (``utils.tree.tree_to``).

Keys are ``(salt0, salt1)`` pairs (engine/executor.py); where round_tpu
folds an id into a key (``jax.random.fold_in``), the port uses
``instance_key``, the scenario-key rule of ``executor.simulate``.

Instance ids live in the reference's 16-bit wrap-around space
(core.time.Instance); the decision log is keyed by instance id.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import vmap

from round_tpu_torch.core.algorithm import Algorithm
from round_tpu_torch.core.rounds import RoundCtx
from round_tpu_torch.engine import executor
from round_tpu_torch.engine.executor import LocalTopology
from round_tpu_torch.engine.scenarios import _key_salt, mix32_host
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.ops.fused import _GOLD
from round_tpu_torch.utils.device import resolve_device
from round_tpu_torch.utils.tree import tree_map, tree_to

MAX_INSTANCE = 1 << 16

# the lane-count buckets the lane-batched host driver pads to (runtime/
# lanes.py): a jitted mega-step is compiled per (round class, bucket, n),
# so admission/retire churn between dispatches NEVER recompiles — a new
# instance lands in a free padded slot, and only crossing a bucket
# boundary (a different --lanes request) costs a fresh trace.  Small set
# by design: each bucket is one more compile per round class.
LANE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def lane_bucket(k: int) -> int:
    """Smallest lane bucket >= k (capped at the largest bucket)."""
    if k < 1:
        raise ValueError(f"need k >= 1, got {k}")
    for b in LANE_BUCKETS:
        if b >= k:
            return b
    return LANE_BUCKETS[-1]


class AdmissionControl:
    """Per-driver admission budget + load-shedding policy (the overload
    half of docs/HOST_FAULT_MODEL.md).

    The budget is ``live_lanes × high_bytes_per_lane`` over the driver's
    QUEUED bytes — future-instance stash, per-lane pending buffers, and
    the native inbox backlog — with hysteresis (shedding starts at the
    high watermark and ends at ``low_frac`` of it, so the driver does not
    flap at the boundary).  While shedding:

      * new instances are NOT admitted (``admit_ok`` is False); an
        instance whose admission has been deferred longer than
        ``shed_deadline_ms`` is SHED — recorded undecided + counted,
        never silently retried forever;
      * future-instance frames are REFUSED with a FLAG_NACK reply
        (runtime/oob.py) instead of stashed — the sender learns its frame
        was shed, not lost, and the driver's memory stays bounded.

    Deliberately DUMB: pure watermark arithmetic, no wall-clock inside —
    the driver feeds it observed byte counts between dispatches and reads
    back one bit.  Disabled (None) everywhere by default; the hardened
    serving path opts in (host_replica --admission)."""

    __slots__ = ("high_bytes_per_lane", "low_frac", "shed_deadline_ms",
                 "shedding", "shed_started", "sheds", "_high", "_low")

    def __init__(self, high_bytes_per_lane: int = 256 << 10,
                 low_frac: float = 0.5, shed_deadline_ms: int = 2000):
        if high_bytes_per_lane <= 0:
            raise ValueError("high_bytes_per_lane must be > 0")
        if not 0.0 < low_frac < 1.0:
            raise ValueError(f"low_frac must be in (0, 1), got {low_frac}")
        self.high_bytes_per_lane = high_bytes_per_lane
        self.low_frac = low_frac
        self.shed_deadline_ms = shed_deadline_ms
        self.shedding = False
        self.shed_started: Optional[float] = None  # driver-stamped
        self.sheds = 0
        self._high = self._low = 0

    def update(self, live_lanes: int, queued_bytes: int,
               backpressure: bool = False) -> bool:
        """Re-evaluate the watermark; returns the (possibly new) shedding
        state.  ``backpressure`` (the transport's inbox watermark) forces
        shedding regardless of the driver-visible bytes — the native
        inbox IS queued memory the driver has not drained yet."""
        self._high = max(1, live_lanes) * self.high_bytes_per_lane
        self._low = int(self._high * self.low_frac)
        if not self.shedding:
            self.shedding = backpressure or queued_bytes >= self._high
        else:
            self.shedding = backpressure or queued_bytes > self._low
        if not self.shedding:
            self.shed_started = None
        return self.shedding

    def admit_ok(self) -> bool:
        return not self.shedding


class TenantAdmission:
    """Per-tenant weighted-fair admission: AdmissionControl's watermark
    arithmetic metered PER TENANT over the client intake queue
    (docs/SERVING.md "per-tenant admission").

    The driver-wide AdmissionControl budget cannot attribute pressure —
    one hot tenant's backlog trips the shared watermark and the NACKs
    land on everyone.  This meter namespaces the intake queue by the
    tenant id each client frame carries (the Tag.call_stack byte, free
    on FLAG_PROPOSE/FLAG_TXN/FLAG_READ — runtime/oob.py) and gives each
    tenant its own watermark pair over its own queued bytes:

        share_t = live_lanes × bytes_per_lane × w_t / Σw

    with the same high/low hysteresis as the global meter.  A tenant at
    3× its weighted share sheds against its OWN budget; a tenant inside
    its share is never shed by a neighbour's backlog (pinned by
    tests/test_control.py and the fleet-autoscale soak rung).  Under
    driver-wide ``backpressure`` (the global meter tripped, or the
    native inbox watermark), only tenants already ABOVE their low
    watermark join the shed — an in-envelope tenant keeps admitting.

    Admission ORDER is deficit-weighted round-robin: ``next_tenant``
    picks the queued, non-shedding tenant with the lowest
    weight-normalized admit count, so lane slots divide in weight
    proportion when several tenants contend.

    Like AdmissionControl, deliberately DUMB: no wall clock inside —
    the driver stamps ``shed_started`` per tenant and owns the
    deadline-shed policy."""

    __slots__ = ("bytes_per_lane", "low_frac", "shed_deadline_ms",
                 "weights", "default_weight", "shedding", "shed_started",
                 "sheds", "_admitted", "_share")

    def __init__(self, bytes_per_lane: int = 64 << 10,
                 weights: Optional[Dict[int, float]] = None,
                 low_frac: float = 0.5, shed_deadline_ms: int = 2000,
                 default_weight: float = 1.0):
        if bytes_per_lane <= 0:
            raise ValueError("bytes_per_lane must be > 0")
        if not 0.0 < low_frac < 1.0:
            raise ValueError(f"low_frac must be in (0, 1), got {low_frac}")
        if default_weight <= 0:
            raise ValueError("default_weight must be > 0")
        self.bytes_per_lane = bytes_per_lane
        self.low_frac = low_frac
        self.shed_deadline_ms = shed_deadline_ms
        self.weights: Dict[int, float] = dict(weights or {})
        for t, w in self.weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t} weight must be > 0, got {w}")
        self.default_weight = default_weight
        self.shedding: Dict[int, bool] = {}
        self.shed_started: Dict[int, float] = {}  # driver-stamped
        self.sheds = 0
        self._admitted: Dict[int, int] = {}
        self._share: Dict[int, int] = {}

    def weight(self, tenant: int) -> float:
        return float(self.weights.get(tenant, self.default_weight))

    def share_bytes(self, tenant: int, live_lanes: int,
                    present=None) -> int:
        """This tenant's high-watermark byte share of the intake budget
        (``present`` = the tenants sharing it; configured ∪ queued)."""
        if present is None:
            present = set(self.weights) | {tenant}
        total = max(1, live_lanes) * self.bytes_per_lane
        wsum = sum(self.weight(t) for t in present) or 1.0
        return max(1, int(total * self.weight(tenant) / wsum))

    def update(self, live_lanes: int, queued_by_tenant: Dict[int, int],
               backpressure: bool = False) -> set:
        """Re-evaluate every tenant's watermark; returns the set of
        shedding tenants.  Pure arithmetic, same hysteresis discipline
        as AdmissionControl.update."""
        present = set(self.weights) | set(queued_by_tenant)
        out = set()
        for t in sorted(present):
            q = int(queued_by_tenant.get(t, 0))
            high = self.share_bytes(t, live_lanes, present)
            low = int(high * self.low_frac)
            now = (q > low) if self.shedding.get(t, False) else (q >= high)
            if backpressure and q > low:
                # global pressure attributes to the tenants already over
                # their low watermark; an in-envelope tenant never sheds
                # for a neighbour's backlog
                now = True
            self.shedding[t] = now
            self._share[t] = high
            if now:
                out.add(t)
            else:
                self.shed_started.pop(t, None)
        return out

    def is_shedding(self, tenant: int) -> bool:
        return self.shedding.get(tenant, False)

    def next_tenant(self, queued_tenants) -> Optional[int]:
        """Deficit-weighted round-robin pick: the non-shedding queued
        tenant with the lowest weight-normalized admit count (ties break
        on the lower tenant id, deterministically).  None = every queued
        tenant is shedding (the caller defers)."""
        best = None
        best_c = None
        for t in sorted(queued_tenants):
            if self.is_shedding(t):
                continue
            c = self._admitted.get(t, 0) / self.weight(t)
            if best_c is None or c < best_c:
                best, best_c = t, c
        return best

    def note_admit(self, tenant: int) -> None:
        self._admitted[tenant] = self._admitted.get(tenant, 0) + 1


class LaneTable:
    """Slot table mapping live instance ids onto lane indices — the
    dispatcher role of InstanceMux (InstanceDispatcher.scala:84-89) turned
    into lane admission for the lane-batched driver: ``admit`` hands a new
    instance the lowest free padded slot, ``retire`` frees it between
    dispatches, and the padded width (``lane_bucket``) is what keeps the
    compiled mega-step signature stable across churn.

    Deterministic by construction (lowest-free-slot, no hashing): lane
    placement never affects per-instance math, but determinism keeps runs
    reproducible and the equivalence suite's failures replayable.

    ``limit`` is the REQUESTED concurrency and ``width`` the padded
    compile width: a ``lanes=5`` request compiles an 8-wide mega-step but
    admits at most 5 instances in flight — what the harness reports as
    "lanes=5" is what actually ran (padding slots stay masked-inactive).
    A request above the largest bucket is clamped to it."""

    __slots__ = ("width", "limit", "_free", "_lane_of", "_inst_of")

    def __init__(self, lanes: int):
        self.width = lane_bucket(lanes)
        self.limit = min(lanes, self.width)
        self._free = list(range(self.width - 1, -1, -1))  # pop() -> lowest
        self._lane_of: Dict[int, int] = {}
        self._inst_of: List[Optional[int]] = [None] * self.width

    @property
    def occupancy(self) -> int:
        return self.width - len(self._free)

    def can_admit(self) -> bool:
        return bool(self._free) and self.occupancy < self.limit

    def admit(self, instance_id: int) -> int:
        iid = instance_id % MAX_INSTANCE
        if iid in self._lane_of:
            raise ValueError(f"instance {iid} already admitted")
        if not self._free:
            raise ValueError("no free lane")
        lane = self._free.pop()
        self._lane_of[iid] = lane
        self._inst_of[lane] = iid
        return lane

    def retire(self, instance_id: int) -> int:
        iid = instance_id % MAX_INSTANCE
        lane = self._lane_of.pop(iid)
        self._inst_of[lane] = None
        self._free.append(lane)
        # keep pop() == lowest free slot after arbitrary churn
        self._free.sort(reverse=True)
        return lane

    def lane_of(self, instance_id: int) -> Optional[int]:
        return self._lane_of.get(instance_id % MAX_INSTANCE)

    def instance_of(self, lane: int) -> Optional[int]:
        return self._inst_of[lane]

    def live_instances(self) -> List[int]:
        return sorted(self._lane_of)


def instance_key(key, iid: int) -> Tuple[int, int]:
    """The key of instance ``iid`` under ``key``: ``(mix32(salt0 + iid·GOLD),
    salt1)``, the rule by which ``executor.simulate`` derives scenario keys
    (round_tpu folds the id in: ``jax.random.fold_in(key, iid)``)."""
    k0, k1 = _key_salt(key)
    return (mix32_host(k0 + int(iid) * _GOLD), k1)


def window_masks(sampler: Callable, keys: Sequence[Tuple[int, int]],
                 salts: Tuple[torch.Tensor, torch.Tensor], r: int
                 ) -> torch.Tensor:
    """``[W, n, n]`` HO masks of round r for W instance keys: one call of
    the sampler's window form (``sampler.window(salt0, salt1, r)`` over the
    ``[W]`` int64 salts, engine/scenarios.py) where it has one, row w
    bit-equal to ``sampler(keys[w], r)``; else one call per key, stacked."""
    window = getattr(sampler, "window", None)
    if window is not None:
        return window(salts[0], salts[1], r)
    return torch.stack([sampler(k, r) for k in keys])


@dataclasses.dataclass
class InstanceResult:
    """Outcome of one multiplexed instance."""

    instance_id: int
    decided: np.ndarray        # [n] bool per lane
    decision: np.ndarray       # [n] values per lane
    decided_round: np.ndarray  # [n] int32
    value: Any                 # the instance's agreed value (first decided
    # lane's decision; None if no lane decided)


class InstancePool:
    """Run up to ``window`` concurrent instances per step, batched on device.

    Mirrors the reference's processPool/rate-limited in-flight window
    (RuntimeOptions.scala:27 processPool=16; BatchingClient RateLimiting):
    ``submit`` queues (instance_id, io); ``run_pending`` executes up to
    ``window`` of them as one batched program (module docstring) and folds
    the results into the decision log.  ``ho_sampler`` must give its masks
    on ``device`` (the card unless the caller passes another).
    """

    def __init__(
        self,
        algo: Algorithm,
        n: int,
        ho_sampler: Callable,
        max_phases: int,
        window: int = 16,
        device=None,
    ):
        self.algo = algo
        self.n = n
        self.ho_sampler = ho_sampler
        self.max_phases = max_phases
        self.window = window
        self.device = resolve_device(device)
        self._pending: List[Tuple[int, Any]] = []
        self._running: set = set()
        self.decision_log: Dict[int, InstanceResult] = {}

    def _run_window(self, ios, keys, salts):
        """The batched program: ``[W]`` instances of ``run_instance`` as one
        round loop.  Returns ``(decided, decision, decided_round)``, each
        ``[W, n, ...]`` on the device."""
        algo, n, dev = self.algo, self.n, self.device
        topo = LocalTopology(n, dev)
        ids = topo.lane_ids()
        r0 = torch.zeros((), dtype=torch.int32, device=dev)

        def _init(i, io_lane):
            return algo.make_init_state(RoundCtx(id=i, n=n, r=r0), io_lane)

        state = vmap(vmap(_init), in_dims=(None, 0))(ids, ios)
        W = len(keys)
        done = torch.zeros((W, n), dtype=torch.bool, device=dev)
        dround = torch.full((W, n), -1, dtype=torch.int32, device=dev)
        k_rounds = algo.rounds_per_phase
        for phase in range(self.max_phases):
            for j, rnd in enumerate(algo.rounds):
                r = phase * k_rounds + j
                ho = window_masks(self.ho_sampler, keys, salts, r)
                words = topo.lane_keys(salts, r)

                def step(st, dn, h, w, rnd=rnd, r=r):
                    return executor.run_round(rnd, st, dn, r, h, None, topo,
                                              lane_words=w)

                state, done = vmap(step)(state, done, ho, words)
                dec = executor._decided_or_false(algo, state, n, dev)
                dround = torch.where(dec & (dround < 0), r, dround)
        return algo.decided(state), algo.decision(state), dround

    # -- dispatcher surface (InstanceDispatcher.scala add/remove/dispatch) --

    def can_start(self, instance_id: int) -> bool:
        iid = instance_id % MAX_INSTANCE
        return iid not in self._running and iid not in self.decision_log

    def is_running(self, instance_id: int) -> bool:
        return (instance_id % MAX_INSTANCE) in self._running

    def submit(self, instance_id: int, io: Any) -> None:
        """Queue an instance (Algorithm.startInstance's intake)."""
        iid = instance_id % MAX_INSTANCE
        if not self.can_start(iid):
            raise ValueError(f"instance {iid} already running or decided")
        self._running.add(iid)
        self._pending.append((iid, io))

    def stop(self, instance_id: int) -> None:
        """Drop a queued/running instance (Algorithm.stopInstance)."""
        iid = instance_id % MAX_INSTANCE
        self._running.discard(iid)
        self._pending = [(i, io) for i, io in self._pending if i != iid]

    def run_pending(self, key) -> List[InstanceResult]:
        """Execute up to ``window`` queued instances in one batched call.
        ``key`` is a ``(salt0, salt1)`` pair; instance ``iid`` runs on
        ``instance_key(key, iid)``."""
        if not self._pending:
            return []
        batch, self._pending = (
            self._pending[: self.window],
            self._pending[self.window:],
        )
        ids = [iid for iid, _ in batch]
        keys = [instance_key(key, iid) for iid in ids]
        # the ios (on the host, as callers build them) and the salts go to
        # the device in one copy
        ios = tree_map(lambda *xs: torch.stack([torch.as_tensor(x)
                                                for x in xs]),
                       *[io for _, io in batch])
        ios, salts = tree_to((ios, torch.tensor(keys, dtype=torch.int64)),
                             self.device)
        # no compile step here: every window, the first included, is timed
        # as engine.run; the copy out ends the timed region
        with METRICS.timer("engine.run"):
            out = tree_to(self._run_window(ios, keys, (salts[:, 0],
                                                       salts[:, 1])),
                          "cpu")
        decided, decision, dec_round = (t.numpy() for t in out)
        METRICS.counter("engine.instances").inc(len(ids))
        out = []
        for b, iid in enumerate(ids):
            first = int(np.argmax(decided[b])) if decided[b].any() else -1
            res = InstanceResult(
                instance_id=iid,
                decided=decided[b],
                decision=decision[b],
                decided_round=dec_round[b],
                value=None if first < 0 else decision[b][first],
            )
            self.decision_log[iid] = res
            self._running.discard(iid)
            out.append(res)
        return out

    def run_all(self, key) -> List[InstanceResult]:
        """Drain the queue, window by window (window ``step`` on
        ``instance_key(key, step)``)."""
        out = []
        step = 0
        while self._pending:
            out.extend(self.run_pending(instance_key(key, step)))
            step += 1
        return out

    # -- recovery surface (Recovery.scala askDecision/sendRecoveryInfo) ----

    def get_decision(self, instance_id: int) -> Optional[InstanceResult]:
        return self.decision_log.get(instance_id % MAX_INSTANCE)

    def adopt_decision(self, instance_id: int, value: Any) -> bool:
        """Record a decision learned out-of-band (a FLAG_DECISION message —
        PerfTest.onDecision, PerfTest.scala:64-84): stop any local run and
        log the value.  Returns False if we already had it (the reference's
        getDec(inst).isEmpty guard)."""
        iid = instance_id % MAX_INSTANCE
        if iid in self.decision_log:
            return False
        if isinstance(value, np.ndarray):
            # wire decisions decode ZERO-COPY (runtime/codec.py): the array
            # is a view into a receive-drain buffer, and a decision log is
            # long-lived — own the 4 bytes instead of pinning the drain
            value = np.array(value)
        self.decision_log[iid] = InstanceResult(
            instance_id=iid,
            decided=np.ones((self.n,), dtype=bool),
            decision=np.full((self.n,), value),
            decided_round=np.full((self.n,), -1, dtype=np.int32),
            value=value,
        )
        self.stop(iid)
        return True

    def recover_from(self, peer: "InstancePool", instance_id: int) -> bool:
        """Direct-call shortcut over the Decision flag path; the
        message-driven surface is runtime/oob.py (PoolNode/LocalBus).
        Returns True if the peer had it."""
        iid = instance_id % MAX_INSTANCE
        got = peer.get_decision(iid)
        if got is None:
            return False
        self.decision_log[iid] = got
        self._running.discard(iid)
        return True
