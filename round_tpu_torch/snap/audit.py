"""Batched full-state auditing: the offline formulas, pointed at
production cuts.

Port of round_tpu/snap/audit.py.  The slots, their labels, the probe's
classification and the verdicts are round_tpu's; the batched evaluator is
``torch.func.vmap`` of the per-cut term over a power-of-two padded batch
of cuts on ``device``, cached per padded size as round_tpu caches its
jitted evaluators, with the batch going up in one copy and the verdicts
coming back in one.  The probe evaluates each formula under that vmap on
a zero state (round_tpu traces it with ``jax.eval_shape``).

The monitor compiler deliberately classifies the full-state Spec
formulas (invariants, safety_predicate, round_invariants — everything
``spec_formulas`` scopes "offline") OUT of the live lane monitors: no
single replica can evaluate a formula that quantifies over all n
processes' state.  A round-consistent cut (snap/collect.py) IS that
global state, so this module compiles the offline formulas into ONE
vmapped evaluator over batches of cuts — the fuzz-evaluator trick
(evaluate a population per dispatch) pointed at live serving state
instead of fuzz genomes.

What is auditable on a single cut is narrower than on a recorded trace,
and the compiler is explicit about the split (the rv/compile.py
discipline):

  * formulas over ``state`` (+ ``init``, reconstructed below) — YES:
    the invariant chain, offline safety properties (OTR's Integrity);
  * formulas needing ``old`` (the previous round's state) or the HO
    matrix (safety_predicate constrains the executing round's HO) — NO:
    a cut holds one instant; these stay with check_trace and the fuzz
    objectives, and the program records each exclusion with its reason
    (``AuditProgram.skipped``) so docs and stats can say exactly what a
    clean audit does NOT cover.

``init`` reconstruction: the init snapshot is deterministic in the
proposal row every sample carries (the same determinism the rv validity
witness and the chaos harness lean on) — ``make_init_state`` per pid,
cached per proposal row, so formulas like OTR's ``keep_init`` audit
without any extra wire traffic.

The invariant chain audits as ONE slot — the disjunction, matching
check_trace's ``any_invariant`` steady state (chain progress means
individual invariants legitimately fail; NO invariant holding is the
violation).  Verdicts are pinned against the eager reference twin
``spec/check.py:check_cut`` in tests/test_snap.py.

Violations flow through the rv pipeline (rv/dump.py): a fuzz-replay
artifact with ``meta.rv`` naming the formula — ``fuzz_cli replay``
reproduces it bit-exactly — plus the digest-trajectory forensics block,
honoring the same halt | shed | log policies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime.log import get_logger
from round_tpu_torch.rv.dump import (
    POLICIES, RvConfig, RvViolation, dump_violation,
)
from round_tpu_torch.spec.check import _eval_formula, spec_formulas
from round_tpu_torch.spec.dsl import Env
from round_tpu_torch.utils.tree import tree_flatten, tree_unflatten

log = get_logger("snap")

_C_AUDITED = METRICS.counter("snap.cuts_audited")
_C_DISPATCHES = METRICS.counter("snap.audit_dispatches")
_C_VIOLATIONS = METRICS.counter("snap.violations")
_C_DUMPS = METRICS.counter("snap.dumps")
_C_CHECKS = METRICS.counter("snap.checks")


class SnapViolation(RvViolation):
    """A full-state formula failed on a live cut under the ``halt``
    policy.  Subclasses RvViolation so every existing halt surface
    (host_replica's exit-3 path, the fleet's failure drain) handles a
    snapshot halt identically."""


@dataclasses.dataclass
class SnapConfig:
    """Driver-facing snapshot switches (host_replica --snap /
    fleet serve --snap).

    policy:     halt | shed | log — what a cut violation does (the rv
                vocabulary; shed retires the violating instance on the
                collector replica, where the verdict lives).
    protocol:   selector name, so violation artifacts replay
                (None = events/counters only).
    dump_dir:   artifact directory (None = no artifacts).
    schedule_path: the --chaos-schedule artifact in force, copied into
                dumps so replays run the same wire (rv/dump.py).
    every_k:    sampling period in rounds (snap/sample.py policy).
    collector:  the pid that assembles and audits cuts (its own samples
                join locally; everyone else ships FLAG_SNAP frames).
    budget_bytes_per_s: sample-traffic token bucket (0 = unbudgeted).
    cut_deadline_ms: how long a part-cut waits for missing contributors
                before the envelope tolerance resolves it.
    bank_dir:   directory for banked ``.snapcut`` files (offline audit
                via apps/snap_cli.py; None = no banking).
    bank_engine: record expected.engine into violation artifacts at
                dump time (the rv bank_engine semantics).
    max_dumps:  artifact cap per driver.
    """

    policy: str = "log"
    protocol: Optional[str] = None
    dump_dir: Optional[str] = None
    schedule_path: Optional[str] = None
    every_k: int = 4
    collector: int = 0
    budget_bytes_per_s: int = 256 << 10
    cut_deadline_ms: int = 3000
    bank_dir: Optional[str] = None
    bank_engine: bool = True
    max_dumps: int = 8

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"snap policy must be one of {POLICIES}, "
                f"got {self.policy!r}")
        if self.every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {self.every_k}")

    def rv_dump_config(self) -> RvConfig:
        """The dump-pipeline view of this config: snap shares rv's
        artifact writer verbatim (ONE schema, ONE replay path)."""
        return RvConfig(
            policy="log",  # the POLICY is acted on here, never in dump
            protocol=self.protocol, dump_dir=self.dump_dir,
            schedule_path=self.schedule_path,
            bank_engine=self.bank_engine, max_dumps=self.max_dumps)


@dataclasses.dataclass(frozen=True)
class _Slot:
    """One audit verdict slot: the chain disjunction, one offline
    property, or one round-invariant group (phase-gated)."""

    label: str
    kind: str            # "chain" | "property" | "round_invariant"
    formulas: Tuple
    group: int = -1


@dataclasses.dataclass
class AuditProgram:
    """One algorithm's compiled cut-audit set at group size ``n``:
    verdict slots + the exclusions, the state treedef the cut leaves
    unflatten through, and whether any slot needs the reconstructed
    init snapshot."""

    algo: Any
    n: int
    rounds_per_phase: int
    treedef: Any
    n_leaves: int
    slots: Tuple[_Slot, ...]
    skipped: Dict[str, str]
    needs_init: bool
    device: Any = None
    _jit_cache: Dict[int, Callable] = dataclasses.field(
        default_factory=dict, repr=False)
    _init_cache: Dict[Tuple, List[np.ndarray]] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def labels(self) -> List[str]:
        return [s.label for s in self.slots]

    # -- evaluation --------------------------------------------------------

    def _check_one(self, state_tree, init_tree, r):
        """ok[F] on ONE cut — the verdict term the batched evaluator
        vmaps (the same comparisons as the eager spec/check.py:check_cut,
        slot for slot)."""
        env = Env(state=state_tree, n=self.n, old=None, init0=init_tree,
                  ho=None, r=r + 1)
        oks = []
        for s in self.slots:
            if s.kind == "chain":
                oks.append(torch.stack([
                    _eval_formula(f, env, lab)
                    for lab, f in s.formulas]).any())
            elif s.kind == "round_invariant":
                applies = (r % self.rounds_per_phase) == s.group
                ok = torch.stack([
                    _eval_formula(f, env, lab)
                    for lab, f in s.formulas]).all()
                oks.append(torch.where(applies, ok, True))
            else:
                lab, f = s.formulas[0]
                oks.append(_eval_formula(f, env, lab))
        return torch.stack(oks)

    def _batch_fn(self, c: int) -> Callable:
        """The evaluator for a pow2-padded batch of ``c`` cuts: ONE
        vmapped program audits every formula over every cut, cached per
        padded size (round_tpu caches its jitted evaluators the same
        way)."""
        fn = self._jit_cache.get(c)
        if fn is None:
            def one(leaves, inits, r):
                st = tree_unflatten(list(leaves), self.treedef)
                init = (tree_unflatten(list(inits), self.treedef)
                        if self.needs_init else None)
                return self._check_one(st, init, r)

            fn = self._jit_cache[c] = vmap(one)
        return fn

    def init_rows(self, values: np.ndarray) -> List[np.ndarray]:
        """The [n, ...] init snapshot reconstructed from one proposal
        row (deterministic; cached per row — schedules draw from a tiny
        domain and fleet clients propose uniformly)."""
        from round_tpu_torch.runtime.host import (
            instance_io, lane_init_state, to_numpy,
        )

        key = tuple(int(v) for v in values)
        got = self._init_cache.get(key)
        if got is None:
            if len(self._init_cache) >= 256:
                self._init_cache.clear()
            rows = [to_numpy(tree_flatten(lane_init_state(
                self.algo, pid, self.n,
                instance_io(self.algo, int(values[pid])), "cpu"))[0])
                for pid in range(self.n)]
            got = [np.stack([rows[p][i] for p in range(self.n)])
                   for i in range(len(rows[0]))]
            self._init_cache[key] = got
        return got

    def check_batch(self, states: List[List[np.ndarray]],
                    inits: List[Optional[List[np.ndarray]]],
                    rs: List[int]) -> np.ndarray:
        """ok[C, F] over ``C`` cuts in one (pow2-padded) dispatch on the
        program's device: the batch up in one copy, the verdicts back in
        one."""
        from round_tpu_torch.runtime.host import to_device, to_numpy

        c = len(states)
        pad = 1
        while pad < c:
            pad *= 2
        idx = list(range(c)) + [0] * (pad - c)
        stacked = [np.stack([states[i][leaf] for i in idx])
                   for leaf in range(self.n_leaves)]
        if self.needs_init:
            init_stacked = [np.stack([inits[i][leaf] for i in idx])
                            for leaf in range(self.n_leaves)]
        else:
            # zero-footprint placeholder: the evaluator never reads it
            init_stacked = [np.zeros((pad, 0)) for _ in
                            range(self.n_leaves)]
        r_arr = np.asarray([rs[i] for i in idx], dtype=np.int32)
        st, ini, r_d = to_device((stacked, init_stacked, r_arr),
                                 self.device)
        ok = to_numpy(self._batch_fn(pad)(tuple(st), tuple(ini), r_d))
        _C_DISPATCHES.inc()
        return np.asarray(ok)[:c]


def audit_program(algo, n: int, device=None) -> Optional[AuditProgram]:
    """Compile ``algo``'s cut-audit program for ``device`` (the card when
    None), or None when there is nothing to audit (no Spec, or no offline formula is cut-evaluable —
    lvb's spec=None byte workload still gets the digest/divergence layer,
    just no formula dispatch).

    Classification is by PROBE: each offline formula is evaluated under
    the evaluator's vmap on a zero [n, ...] state — a formula that reaches for ``old`` or the HO matrix raises
    the dsl's explicit ValueError and is excluded WITH its reason; one
    that reaches for ``init`` is retried with the reconstructed init
    snapshot and marks the program ``needs_init``."""
    spec = getattr(algo, "spec", None)
    if spec is None:
        return None
    enum = spec_formulas(spec)
    offline = [e for e in enum if e.scope == "offline"
               and e.kind != "safety_predicate"]
    skipped: Dict[str, str] = {}
    for e in enum:
        if e.kind == "safety_predicate":
            # constrains the EXECUTING round's HO (check_trace evaluates
            # it against the pre-state and that round's matrix): not a
            # statement about one instant, never cut-evaluable
            skipped[e.label] = "safety_predicate constrains the " \
                "executing round's HO matrix (trace-only)"
    if not offline:
        return None
    try:
        state_abs, treedef, n_leaves = _abstract_state(algo, n)
    except Exception as e:  # noqa: BLE001 — no probeable state, no audit
        log.warning("snap: cannot probe %s state for auditing: %s",
                    type(algo).__name__, e)
        return None

    def probe(e) -> Tuple[bool, bool, str]:
        """(auditable, needs_init, reason)."""
        for with_init in (False, True):
            try:
                vmap(lambda st, r: _eval_formula(
                    e.formula,
                    Env(state=st, n=n, old=None,
                        init0=st if with_init else None, ho=None, r=r + 1),
                    e.label))(state_abs, torch.zeros(1, dtype=torch.int32))
                return True, with_init, ""
            except ValueError as err:
                if not with_init and "init snapshot" in str(err):
                    continue  # retry with the reconstructed init
                return False, False, str(err)
            except Exception as err:  # noqa: BLE001 — field typos etc.
                return False, False, str(err)
        return False, False, "unreachable"

    slots: List[_Slot] = []
    needs_init = False
    inv = [e for e in offline if e.kind == "invariant"]
    if inv:
        probes = [probe(e) for e in inv]
        if all(p[0] for p in probes):
            needs_init |= any(p[1] for p in probes)
            slots.append(_Slot(
                label="invariants (chain)", kind="chain",
                formulas=tuple((e.label, e.formula) for e in inv)))
        else:
            why = next(p[2] for p in probes if not p[0])
            skipped["invariants (chain)"] = (
                f"chain member not cut-evaluable: {why}")
    for e in offline:
        if e.kind == "property":
            ok, ni, why = probe(e)
            if ok:
                needs_init |= ni
                slots.append(_Slot(label=e.label, kind="property",
                                   formulas=((e.label, e.formula),)))
            else:
                skipped[e.label] = why
    groups = sorted({e.group for e in offline
                     if e.kind == "round_invariant"})
    for g in groups:
        members = [e for e in offline
                   if e.kind == "round_invariant" and e.group == g]
        probes = [probe(e) for e in members]
        if all(p[0] for p in probes):
            needs_init |= any(p[1] for p in probes)
            slots.append(_Slot(
                label=f"round_invariants[{g}]", kind="round_invariant",
                formulas=tuple((e.label, e.formula) for e in members),
                group=g))
        else:
            why = next(p[2] for p in probes if not p[0])
            skipped[f"round_invariants[{g}]"] = why
    if not slots:
        return None
    from round_tpu_torch.utils.device import resolve_device

    return AuditProgram(
        algo=algo, n=n, rounds_per_phase=algo.rounds_per_phase,
        treedef=treedef, n_leaves=n_leaves, slots=tuple(slots),
        skipped=skipped, needs_init=needs_init,
        device=resolve_device(device))


def _abstract_state(algo, n: int):
    """A zero [1, n, ...] global state (one cut of a batch) + treedef +
    leaf count from one init-state probe on the CPU (the instance_io
    contract, rv/compile._probe_shapes' sibling)."""
    from round_tpu_torch.runtime.host import instance_io, lane_init_state

    st = lane_init_state(algo, 0, n, instance_io(algo, 0), "cpu")
    leaves, treedef = tree_flatten(st)
    zero = [torch.zeros((1, n) + tuple(x.shape), dtype=x.dtype)
            for x in leaves]
    return tree_unflatten(zero, treedef), treedef, len(leaves)


class SnapRuntime:
    """Per-driver violation bookkeeping for the snapshot tier — the
    RvRuntime shape under the snap.* vocabulary, sharing rv/dump.py's
    artifact writer (ONE schema, ONE replay path, meta.rv naming the
    formula with a snapshot ``surface`` marker and the digest-trajectory
    forensics block)."""

    def __init__(self, cfg: SnapConfig, *, node: int, n: int, seed: int,
                 max_rounds: int, device=None):
        self.cfg = cfg
        self.device = device
        self.dump_cfg = cfg.rv_dump_config()
        self.node, self.n = node, n
        self.seed, self.max_rounds = seed, max_rounds
        self.checks = 0
        self.violations: List[Dict[str, Any]] = []
        self.artifacts: List[str] = []
        self._dumped: set = set()

    def note_checks(self, k: int) -> None:
        self.checks += k
        _C_CHECKS.inc(k)

    def violate(self, *, inst: int, round_: int, label: str,
                values: List[int], observed: Dict[str, Any]) -> str:
        """Record one failed cut formula; raises SnapViolation under
        ``halt`` (artifact attached), else returns 'shed' | 'log'."""
        _C_VIOLATIONS.inc()
        rec = {"inst": int(inst), "round": int(round_), "formula": label,
               "where": "snapshot-audit", "policy": self.cfg.policy}
        if TRACE.enabled:
            TRACE.emit("snap_violation", node=self.node, inst=int(inst),
                       round=int(round_), formula=label,
                       policy=self.cfg.policy)
        log.error("node %d: SNAP VIOLATION inst=%d round=%d %s",
                  self.node, inst, round_, label)
        key = (int(inst), label)
        artifact = None
        if key not in self._dumped and len(self.artifacts) \
                < self.cfg.max_dumps:
            self._dumped.add(key)
            artifact = dump_violation(
                self.dump_cfg, n=self.n, seed=self.seed,
                rounds=self.max_rounds, values=values, node=self.node,
                inst=inst, round_=round_, label=label, observed=observed,
                device=self.device)
            if artifact is not None:
                rec["artifact"] = artifact
                self.artifacts.append(artifact)
                _C_DUMPS.inc()
        self.violations.append(rec)
        if self.cfg.policy == "halt":
            raise SnapViolation(
                label, inst, round_,
                artifact if artifact is not None
                else (self.artifacts[-1] if self.artifacts else None))
        return self.cfg.policy

    def fill_stats(self, stats_out: Optional[Dict[str, Any]]) -> None:
        if stats_out is None:
            return
        stats_out["snap_checks"] = stats_out.get("snap_checks", 0) \
            + self.checks
        stats_out.setdefault("snap_violations", []).extend(
            self.violations)
        stats_out.setdefault("snap_artifacts", []).extend(self.artifacts)


class CutAuditor:
    """Drain assembled cuts through the batched evaluator and act on
    failures.  ``audit`` returns the instance ids the caller must SHED
    (the policy verdicts it cannot act on itself); halt raises out of
    the runtime."""

    def __init__(self, program: Optional[AuditProgram],
                 runtime: SnapRuntime, collector):
        self.program = program
        self.rt = runtime
        self.collector = collector
        self.cuts_audited = 0

    def audit(self, cuts: List) -> List[int]:
        shed: List[int] = []
        if not cuts:
            return shed
        from round_tpu_torch.snap.collect import _C_PARTIAL_UNAUDITED

        full = [c for c in cuts if c.full]
        for c in cuts:
            # every consumed cut counts — partial cuts engage the
            # digest/divergence layer even though the formula dispatch
            # must skip them (collect.py module docstring)
            self.cuts_audited += 1
            _C_AUDITED.inc()
            if not c.full:
                _C_PARTIAL_UNAUDITED.inc()
        if not full or self.program is None:
            return shed
        prog = self.program
        states, inits, rs, kept = [], [], [], []
        for c in full:
            if len(c.state) != prog.n_leaves or c.n != prog.n:
                continue  # alien geometry (a pre-resize leftover that
                # outlived the epoch fence): not auditable
            states.append(c.state)
            inits.append(prog.init_rows(c.values)
                         if prog.needs_init else None)
            rs.append(c.round)
            kept.append(c)
        if not kept:
            return shed
        ok = prog.check_batch(states, inits, rs)
        self.rt.note_checks(ok.size)
        for c, row in zip(kept, ok):
            for fidx in np.nonzero(~row)[0]:
                observed = {
                    "surface": "snapshot-audit",
                    "epoch": c.epoch,
                    "digests": {str(i): (d.hex() if d else None)
                                for i, d in enumerate(c.digests)},
                    "divergence": self.collector.digest_history(c.inst)
                    if self.collector is not None else [],
                }
                action = self.rt.violate(
                    inst=c.inst, round_=c.round,
                    label=prog.labels[int(fidx)],
                    values=[int(v) for v in c.values],
                    observed=observed)
                if action == "shed":
                    shed.append(c.inst)
        return shed
