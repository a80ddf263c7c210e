"""The monitor compiler: a protocol's Spec → lane monitors.

Port of round_tpu/rv/compile.py.  What is soundly checkable AT A REPLICA
differs from what is checkable over a recorded full-system trace
(docs/RUNTIME_VERIFICATION.md "monitor semantics"):

  * The full-state formulas (invariants, safety_predicate,
    round_invariants) quantify over all n processes' state, which no
    single replica holds.  They stay with the offline/engine surface and
    the compiler classifies them (``MonitorProgram.offline``).

  * The decision-plane properties (Agreement, Validity, Irrevocability)
    have exact locally checkable forms over what a replica observes: its
    own decision history (one carried (prior decided, prior decision)
    pair per lane), the instance's initial-value vector (validity's
    witness set) and peer decisions learned over the wire (agreement's
    channel).  They compile into a term of plain tensor code over the
    lanes' decision planes, which ``engine/executor.py::LaneStep`` reads
    inside its update's ``torch.func.vmap`` and checks in the same
    mega-step (one more output, no second dispatch; ``check_lane`` is
    the per-lane form, vmappable); the numpy twin (``InstanceMonitor``)
    drives the host runner, so both drivers report the same verdict
    vector under the same labels.

Labels and order come from the one shared enumeration
(``spec/check.py::spec_formulas``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# the decision-plane monitor slots in verdict-vector order: a formula is
# a wire monitor iff spec_formulas labels it scope "live"
from round_tpu_torch.spec.check import (  # noqa: F401 — re-export
    WIRE_MONITORS, SpecFormula, spec_formulas,
)


@dataclasses.dataclass(frozen=True)
class MonitorProgram:
    """One algorithm's compiled monitor set at group size ``n``
    (round_tpu/rv/compile.py::MonitorProgram).

    labels:        verdict-vector labels, index-aligned with ``ok[F]``.
    slots:         the WIRE_MONITORS slot each verdict implements.
    offline:       the Spec formulas NOT live-checkable at a replica.
    decision_*:    shape/numpy dtype of ``algo.decision``.
    init_*:        shape/numpy dtype of one process's initial value.
    check_lane:    branch-free per-lane tensor term
                   (state_row, prev_dec, prev_val, ext_dec, ext_val,
                   init_vals) -> (ok[F] bool, decided, decision),
                   vmappable over the lane axis.
    verdicts:      the same term over a leading lane axis of decision
                   planes (decided[L], decision[L, ...], ..., active=)
                   -> ok[L, F]: LaneStep reads the planes inside its
                   update's vmap and runs this once, batched.
    """

    algo: Any
    n: int
    labels: Tuple[str, ...]
    slots: Tuple[str, ...]
    offline: Tuple[SpecFormula, ...]
    decision_shape: Tuple[int, ...]
    decision_dtype: Any
    init_shape: Tuple[int, ...]
    init_dtype: Any
    validity_comparable: bool = True
    check_lane: Callable = dataclasses.field(repr=False, default=None)
    verdicts: Callable = dataclasses.field(repr=False, default=None)

    @property
    def n_monitors(self) -> int:
        return len(self.labels)

    def slot_index(self, slot: str) -> Optional[int]:
        try:
            return self.slots.index(slot)
        except ValueError:
            return None

    def zeros(self, lanes: int):
        """Fresh carried monitor state for ``lanes`` slots, as host
        arrays: (prev_decided, prev_decision, ext_decided, ext_decision,
        init_values)."""
        return (
            np.zeros((lanes,), dtype=bool),
            np.zeros((lanes,) + self.decision_shape,
                     dtype=self.decision_dtype),
            np.zeros((lanes,), dtype=bool),
            np.zeros((lanes,) + self.decision_shape,
                     dtype=self.decision_dtype),
            np.zeros((lanes, self.n) + self.init_shape,
                     dtype=self.init_dtype),
        )


def _plane(algo, state) -> Tuple[bool, np.ndarray]:
    """(decided, decision) of one state as host values, in one copy."""
    from round_tpu_torch.runtime.host import to_numpy

    decided, decision = to_numpy((algo.decided(state),
                                  algo.decision(state)))
    return bool(np.asarray(decided).reshape(())), np.asarray(decision)


def _probe_shapes(algo, n: int):
    """(decision shape/dtype, init shape/dtype) from one init-state probe
    on the CPU — the instance_io contract both host loops build from."""
    from round_tpu_torch.runtime.host import instance_io, lane_init_state

    io = instance_io(algo, 0)
    iv = np.asarray(io["initial_value"])
    st = lane_init_state(algo, 0, n, io, "cpu")
    _decided, dec = _plane(algo, st)
    return (tuple(dec.shape), dec.dtype, tuple(iv.shape), iv.dtype)


def monitor_program(algo, n: int) -> Optional[MonitorProgram]:
    """Compile ``algo``'s monitor set, or None when there is nothing to
    soundly monitor: no decision plane, or a Spec that names none of the
    decision-plane properties (round_tpu/rv/compile.py::monitor_program).
    A wire monitor compiles ONLY for the slots the algorithm's own Spec
    names: what the Spec does not claim, the wire does not check."""
    try:
        dshape, ddtype, ishape, idtype = _probe_shapes(algo, n)
    except Exception:  # noqa: BLE001 — no decision plane, no monitors
        return None

    enum = spec_formulas(algo.spec) if getattr(algo, "spec", None) \
        else ()
    by_name: Dict[str, SpecFormula] = {
        e.name.lower(): e for e in enum if e.scope == "live"}
    named = [slot for slot in WIRE_MONITORS if slot in by_name]
    if not named:
        return None
    labels = [by_name[slot].label for slot in named]
    # validity compares decision and initial values only where their
    # shapes are identical (else the slot is vacuously true), so the fused
    # term and the numpy twin give the same verdicts
    validity_comparable = dshape == ishape
    decided_fn, decision_fn = algo.decided, algo.decision
    cmp_validity = "validity" in named and validity_comparable

    def verdicts(decided, decision, prev_dec, prev_val, ext_dec, ext_val,
                 init_vals, active=None):
        # over a leading lane axis: the decision against every value it
        # must equal in ONE comparison (peer decision, prior decision,
        # witness rows, in slot order), each slot an implication
        # cond -> then, the verdicts one ``<=`` of two stacked vectors;
        # inactive lanes' conditions are false (vacuously ok)
        lanes = decided.shape[0]
        flat = decision.reshape(lanes, 1, -1)
        cands = []
        for slot in named:
            if slot == "agreement":
                cands.append(ext_val.reshape(lanes, 1, -1))
            elif slot == "irrevocability":
                cands.append(prev_val.reshape(lanes, 1, -1))
            elif cmp_validity:
                cands.append(init_vals.reshape(lanes, n, -1))
        eq = None
        if cands:
            eq = torch.cat(cands, 1) == flat
            eq = eq[..., 0] if eq.shape[2] == 1 else eq.all(2)
        conds, thens, k = [], [], 0
        for slot in named:
            if slot == "agreement":
                conds.append(decided & ext_dec)
                thens.append(eq[:, k])
                k += 1
            elif slot == "validity":
                if cmp_validity:
                    conds.append(decided)
                    thens.append(eq[:, k:k + n].any(1))
                    k += n
                else:  # incomparable: vacuously true
                    conds.append(decided & False)
                    thens.append(decided)
            else:  # irrevocability
                conds.append(prev_dec)
                thens.append(decided & eq[:, k])
                k += 1
        cond = torch.stack(conds, 1)
        if active is not None:
            cond = cond & active[:, None]
        return cond <= torch.stack(thens, 1)

    def check_lane(state_row, prev_dec, prev_val, ext_dec, ext_val,
                   init_vals):
        decided = decided_fn(state_row).reshape(())
        decision = decision_fn(state_row)
        one = (lambda x: x.unsqueeze(0))
        ok = verdicts(one(decided), one(decision), one(prev_dec),
                      one(prev_val), one(ext_dec), one(ext_val),
                      one(init_vals))
        return ok[0], decided, decision

    offline = tuple(e for e in enum if e.scope != "live")
    return MonitorProgram(
        algo=algo, n=n, labels=tuple(labels), slots=tuple(named),
        offline=offline, decision_shape=dshape, decision_dtype=ddtype,
        init_shape=ishape, init_dtype=idtype,
        validity_comparable=validity_comparable, check_lane=check_lane,
        verdicts=verdicts)


def schedule_init_values(algo, n: int, value_schedule: str,
                         base_value: int, inst: int) -> np.ndarray:
    """The [n, *init_shape] initial-value matrix of one SCHEDULED
    instance, deterministic in (schedule, base, pid, inst)
    (round_tpu/rv/compile.py::schedule_init_values)."""
    from round_tpu_torch.runtime.host import _schedule_value, instance_io

    rows = [np.asarray(instance_io(
        algo, _schedule_value(value_schedule, base_value, pid, inst)
    )["initial_value"]) for pid in range(n)]
    return np.stack(rows)


def plane_verdicts(p: MonitorProgram, decided: bool, decision, prev_dec,
                   prev_val, ext_dec, ext_val, init_vals) -> List[int]:
    """The tripped indices of the verdict vector for one lane's decision
    plane (decided, decision) already on the host: the fused term's
    comparisons, slot for slot, in numpy."""
    decision = np.asarray(decision)
    same = np.array_equal
    ok = []
    for slot in p.slots:
        if slot == "agreement":
            ok.append(not (decided and ext_dec)
                      or same(decision, ext_val))
        elif slot == "validity":
            ok.append((not decided) or not p.validity_comparable
                      or bool(np.any([same(decision, iv)
                                      for iv in init_vals])))
        else:  # irrevocability
            ok.append((not prev_dec)
                      or (decided and same(decision, prev_val)))
    return [i for i in range(p.n_monitors) if not ok[i]]


def eager_verdicts(p: MonitorProgram, state, prev_dec, prev_val,
                   ext_dec, ext_val, init_vals):
    """Numpy evaluation of the verdict vector on ONE lane/instance
    (round_tpu/rv/compile.py::eager_verdicts), for the cold paths that
    never reach an update dispatch.  Returns (tripped indices, decided,
    decision)."""
    decided, decision = _plane(p.algo, state)
    return (plane_verdicts(p, decided, decision, prev_dec, prev_val,
                           ext_dec, ext_val, init_vals), decided, decision)


class InstanceMonitor:
    """The host-path monitor: one instance, one lane, numpy evaluation of
    exactly the fused term's math (round_tpu/rv/compile.py::
    InstanceMonitor)."""

    __slots__ = ("program", "prev_dec", "prev_val", "ext_dec", "ext_val",
                 "init_vals")

    def __init__(self, program: MonitorProgram, init_values: np.ndarray):
        self.program = program
        self.prev_dec = False
        self.prev_val = np.zeros(program.decision_shape,
                                 dtype=program.decision_dtype)
        self.ext_dec = False
        self.ext_val = np.zeros_like(self.prev_val)
        self.init_vals = np.asarray(init_values)

    def note_ext(self, value) -> None:
        """Record a peer decision learned over the wire."""
        try:
            v = np.asarray(value, dtype=self.prev_val.dtype).reshape(
                self.prev_val.shape)
        except Exception:  # noqa: BLE001 — a garbage decision frame is
            return         # the transport's problem, not the monitor's
        self.ext_dec = True
        self.ext_val = v

    def check_plane(self, decided: bool, decision) -> List[int]:
        """Evaluate the verdict vector on a post-update decision plane;
        returns the TRIPPED indices and advances the carried pair."""
        decision = np.asarray(decision)
        tripped = plane_verdicts(
            self.program, decided, decision, self.prev_dec, self.prev_val,
            self.ext_dec, self.ext_val, self.init_vals)
        self.prev_dec, self.prev_val = decided, decision
        return tripped

    def check(self, state) -> List[int]:
        """``check_plane`` on a post-update state."""
        return self.check_plane(*_plane(self.program.algo, state))


class HostRv:
    """One instance's monitor driver for the sequential host runner
    (round_tpu/rv/compile.py::HostRv): the numpy twin of the fused lane
    term plus the violation-policy glue.  ``values`` is the artifact
    proposals row the dump pipeline records."""

    __slots__ = ("rt", "program", "inst", "values", "mon", "shed",
                 "just_decided", "gossip")

    def __init__(self, runtime, program: MonitorProgram, inst: int,
                 init_values: np.ndarray, values, gossip: bool = True):
        self.rt = runtime
        self.program = program
        self.inst = inst
        self.values = list(values)
        self.mon = InstanceMonitor(program, init_values)
        self.shed = False
        self.just_decided = False
        self.gossip = gossip

    def _act(self, tripped: List[int], r: int, where: str) -> None:
        for fidx in tripped:
            observed = {
                "decided": bool(self.mon.prev_dec),
                "decision": _scalar(self.mon.prev_val),
                "ext_decided": bool(self.mon.ext_dec),
                "ext_decision": _scalar(self.mon.ext_val),
            }
            # violate() raises RvViolation itself under the halt policy
            action = self.rt.violate(
                inst=self.inst, round_=r,
                label=self.program.labels[fidx], values=self.values,
                observed=observed, where=where)
            if action == "shed":
                self.shed = True

    def after_plane(self, decided: bool, decision, r: int) -> None:
        """One completed round's verdicts from its decision plane, which
        the runner fetched with the round's exit flag."""
        was = self.mon.prev_dec
        self.rt.note_checks(self.program.n_monitors)
        tripped = self.mon.check_plane(decided, decision)
        self.just_decided = self.mon.prev_dec and not was
        self._act(tripped, r, "round")

    def after_update(self, state, r: int) -> None:
        """One completed round's verdicts (the fused term's site)."""
        self.after_plane(*_plane(self.program.algo, state), r)

    def on_decision_frame(self, state, payload, r: int) -> None:
        """A FLAG_DECISION arrived mid-instance: record it for the
        agreement term and re-check NOW, before adoption overwrites the
        state the conflict lives in."""
        self.mon.note_ext(payload)
        self._act(self.mon.check(state), r, "decision-adopt")


def _scalar(v) -> int:
    from round_tpu_torch.runtime.host import decision_scalar

    return decision_scalar(np.asarray(v))


# -- leader-lease staleness bounds (docs/KV.md) -----------------------------


def lease_bound_ms(timeout_ms: float, rounds: int = 2) -> float:
    """The lease validity window in wall time: ``rounds`` round deadlines
    (round_tpu/rv/compile.py::lease_bound_ms)."""
    return float(rounds) * float(timeout_ms)


class LeaseClock:
    """Quorum-heard staleness clock for lease reads, one per driver
    (round_tpu/rv/compile.py::LeaseClock).  ``note_peer(pid)`` records
    round traffic from a consensus peer; the lease is VALID while at
    least ``quorum`` distinct peers (self included) have been heard
    within ``bound_ms``.  ``revoke()`` kills the lease for good."""

    def __init__(self, n: int, my_id: int, bound_ms: float,
                 quorum: Optional[int] = None):
        import time as _time

        self.n = n
        self.id = my_id
        self.bound_ms = float(bound_ms)
        self.quorum = quorum if quorum is not None else n // 2 + 1
        self._now = _time.monotonic
        self._heard: Dict[int, float] = {my_id: self._now()}
        self._last_quorum = float("-inf")
        self.revoked = False
        self.refusals = 0
        self.grants = 0

    def note_peer(self, pid: int) -> None:
        if 0 <= pid < self.n:
            self._heard[pid] = self._now()

    def note_quorum(self) -> None:
        """A round advanced by threshold: the driver heard >= n-f
        distinct peers inside one round trip."""
        self._last_quorum = self._now()

    def valid(self, now: Optional[float] = None) -> bool:
        """One lease check, counted as a grant or a refusal."""
        if self.revoked:
            self.refusals += 1
            return False
        t = self._now() if now is None else now
        self._heard[self.id] = t  # self is always current
        horizon = t - self.bound_ms / 1000.0
        fresh = sum(1 for ts in self._heard.values() if ts >= horizon)
        if fresh >= self.quorum or self._last_quorum >= horizon:
            self.grants += 1
            return True
        self.refusals += 1
        return False

    def revoke(self) -> None:
        self.revoked = True
