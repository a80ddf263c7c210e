"""Delta-debugging a winning schedule down to a minimal reproducer.

Port of round_tpu/fuzz/minimize.py.  Three shrinking stages, all batching
EVERY candidate of an iteration into one evaluation (FuzzTarget.evaluate /
evaluate_schedules — the minimizer never runs one candidate at a time):

  1. genome-level: drop or halve whole fault families (omission off,
     partition healed earlier, fewer crashed processes, byz cleared,
     value adversary cleared / de-intensified...) while the predicate
     still reproduces — big strides first;
  2. link-level ddmin: materialize the explicit [T, n, n] deliver
     schedule and re-enable chunks of dropped (round, dst, src) link
     events, halving chunk size down to singletons;
  3. VALUE-event ddmin (round_tpu/byz): materialize the explicit
     [T, n, n] substitution plan and remove chunks of (round, dst, src,
     claimed-value) equivocation/stale events the same way — the result
     is 1-MINIMAL over BOTH event kinds: re-enabling any single dropped
     link or retracting any single lie loses the finding (verified by
     one final batched pass).

The minimal (schedule, value plan) pair names exactly the links that
matter and exactly the lies that matter.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from round_tpu_torch.byz.adversary import VP_NONE, plan_is_trivial
from round_tpu_torch.fuzz import genome
from round_tpu_torch.fuzz.search import FuzzTarget
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE

Predicate = Callable[[Dict[str, np.ndarray]], np.ndarray]


@dataclasses.dataclass
class MinimizeResult:
    """round_tpu/fuzz/minimize.py::MinimizeResult."""

    schedule: np.ndarray            # [T, n, n] bool deliver — minimal
    outcome: Dict[str, np.ndarray]  # its engine outcome (per-process)
    dropped_initial: int            # dropped off-diagonal link events before
    dropped_final: int              # ... and after shrinking
    genome_row: Dict[str, np.ndarray]   # the family-shrunk genome
    iterations: int
    value_plan: Optional[np.ndarray] = None  # [T, n, n] int32, or None
    value_initial: int = 0          # substitution events before shrinking
    value_final: int = 0            # ... and after


def _family_candidates(row: Dict[str, np.ndarray]) -> List[Dict]:
    """Simplification moves, simplest-first: each candidate removes or
    halves one fault family of the genome.
    (round_tpu/fuzz/minimize.py::_family_candidates)."""
    cands = []

    def variant(**patch):
        c = {k: np.array(v, copy=True) for k, v in row.items()}
        c.update({k: np.asarray(v) for k, v in patch.items()})
        return c

    if row["p8"] > 0:
        cands.append(variant(p8=np.int32(0)))
        cands.append(variant(p8=np.int32(int(row["p8"]) // 2)))
    if row["crashed"].any():
        cands.append(variant(crashed=np.zeros_like(row["crashed"])))
        fewer = np.array(row["crashed"], copy=True)
        fewer[np.argmax(fewer)] = False
        cands.append(variant(crashed=fewer))
    if row["heal_round"] > 0:
        cands.append(variant(heal_round=np.int32(0),
                             side=np.zeros_like(row["side"])))
        cands.append(variant(heal_round=np.int32(
            int(row["heal_round"]) // 2)))
    if row["rotate_down"] > 0:
        cands.append(variant(rotate_down=np.int32(0)))
    if row["byz"].any():
        cands.append(variant(byz=np.zeros_like(row["byz"])))
    if row["byz_value"].any():
        # value adversary off entirely, then fewer liars, then gentler
        cands.append(variant(byz_value=np.zeros_like(row["byz_value"]),
                             equiv_p8=np.int32(0), stale_p8=np.int32(0)))
        fewer = np.array(row["byz_value"], copy=True)
        fewer[np.argmax(fewer)] = False
        cands.append(variant(byz_value=fewer))
        if row["stale_p8"] > 0:
            cands.append(variant(stale_p8=np.int32(0)))
        if row["equiv_p8"] > 0:
            cands.append(variant(equiv_p8=np.int32(
                int(row["equiv_p8"]) // 2)))
    return cands


def shrink_genome(target: FuzzTarget, row: Dict[str, np.ndarray],
                  predicate: Predicate, max_iters: int = 32
                  ) -> Dict[str, np.ndarray]:
    """Greedy family-level shrink to a fixed point: per iteration, batch
    every one-family simplification into one dispatch and adopt the FIRST
    (simplest-first order) that still reproduces.
    (round_tpu/fuzz/minimize.py::shrink_genome)."""
    row = genome._fill_value_fields(
        {k: np.asarray(v) for k, v in row.items()})
    for _ in range(max_iters):
        cands = _family_candidates(row)
        if not cands:
            break
        pop = genome.Population.from_rows(cands)
        ok = predicate(target.evaluate(pop))
        METRICS.counter("fuzz.minimize_dispatches").inc()
        hit = np.flatnonzero(ok)
        if hit.size == 0:
            break
        row = cands[int(hit[0])]
    return row


def _dropped_events(schedule: np.ndarray) -> np.ndarray:
    """[D, 3] int (r, dst, src) of every OFF-diagonal undelivered link
    event — the atoms ddmin shrinks over (self-delivery is pinned True by
    the engine convention and never counted).
    (round_tpu/fuzz/minimize.py::_dropped_events)."""
    miss = ~schedule
    T, n, _ = schedule.shape
    eye = np.eye(n, dtype=bool)
    miss = miss & ~eye[None, :, :]
    return np.argwhere(miss)


def _with_events(base: np.ndarray, events: np.ndarray) -> np.ndarray:
    """Full-delivery schedule with exactly `events` (r, dst, src) dropped
    (round_tpu/fuzz/minimize.py::_with_events)."""
    out = np.ones_like(base)
    if events.size:
        out[events[:, 0], events[:, 1], events[:, 2]] = False
    return out


def value_events_of(plan: Optional[np.ndarray]) -> np.ndarray:
    """[E, 4] int (r, dst, src, op) of every substitution event of a
    value plan (op >= 0 claimed value, op == VP_STALE stale replay) —
    the atoms the value ddmin shrinks over.
    (round_tpu/fuzz/minimize.py::value_events_of)."""
    if plan is None:
        return np.zeros((0, 4), dtype=np.int64)
    coords = np.argwhere(np.asarray(plan) != VP_NONE)
    ops = np.asarray(plan)[coords[:, 0], coords[:, 1], coords[:, 2]]
    return np.concatenate([coords, ops[:, None]], axis=1)


def plan_with_events(shape, events: np.ndarray) -> np.ndarray:
    """Truthful plan with exactly ``events`` (r, dst, src, op) applied
    (round_tpu/fuzz/minimize.py::plan_with_events)."""
    out = np.full(shape, VP_NONE, dtype=np.int32)
    if events.size:
        out[events[:, 0], events[:, 1], events[:, 2]] = events[:, 3]
    return out


def _ddmin(events: np.ndarray, rebuild, oracle, max_batch: int,
           max_iters: int, iters0: int = 0):
    """The shared complement-testing loop: repeatedly try REMOVING chunks
    of ``events`` (rebuild(kept_events) -> candidate; oracle(stack) ->
    [K] bool reproduces), halving chunk size to 1.  Returns (events,
    iterations).
    (round_tpu/fuzz/minimize.py::_ddmin)."""
    chunk = max(1, events.shape[0] // 2)
    iters = iters0
    while iters < max_iters:
        D = events.shape[0]
        if D == 0:
            break
        chunk = min(chunk, D)
        starts = list(range(0, D, chunk))
        adopted = False
        for b in range(0, len(starts), max_batch):
            if iters >= max_iters:
                break
            window = starts[b:b + max_batch]
            keep_sets = [np.concatenate([events[:s], events[s + chunk:]])
                         for s in window]
            ok = oracle(np.stack([rebuild(k) for k in keep_sets]))
            METRICS.counter("fuzz.minimize_dispatches").inc()
            iters += 1
            hit = np.flatnonzero(ok)
            if hit.size:
                events = keep_sets[int(hit[0])]
                adopted = True
                break
        if adopted:
            continue  # retry at the same granularity over the new set
        if chunk == 1:
            break
        chunk = max(1, chunk // 2)
    return events, iters


def shrink_schedule(target: FuzzTarget, schedule: np.ndarray,
                    predicate: Predicate, max_batch: int = 64,
                    max_iters: int = 200,
                    value_plan: Optional[np.ndarray] = None) -> tuple:
    """Link-level ddmin: repeatedly try re-ENABLING chunks of the dropped
    link events (complement testing, chunk size halving to 1), batching
    all of an iteration's candidates into one dispatch.  A fixed
    ``value_plan`` rides along on every candidate (the oracle evaluates
    links UNDER the lies in force).  Returns (schedule, outcome,
    iterations) with the schedule 1-minimal under the predicate.
    (round_tpu/fuzz/minimize.py::shrink_schedule)."""
    schedule = np.asarray(schedule, dtype=bool)

    def oracle(cands):
        vp = None if value_plan is None else np.repeat(
            value_plan[None], cands.shape[0], axis=0)
        return predicate(target.evaluate_schedules(cands, vp))

    events, iters = _ddmin(
        _dropped_events(schedule),
        lambda kept: _with_events(schedule, kept), oracle,
        max_batch, max_iters)
    minimal = _with_events(schedule, events)
    vp1 = None if value_plan is None else value_plan[None]
    out = target.evaluate_schedules(minimal[None], vp1)
    outcome = {k: v[0] for k, v in out.items()}
    return minimal, outcome, iters


def shrink_value_plan(target: FuzzTarget, schedule: np.ndarray,
                      value_plan: np.ndarray, predicate: Predicate,
                      max_batch: int = 64, max_iters: int = 200) -> tuple:
    """VALUE-event ddmin over a fixed schedule: remove chunks of
    substitution events while the predicate still reproduces.  Returns
    (plan, outcome, iterations), 1-minimal over the lie events.
    (round_tpu/fuzz/minimize.py::shrink_value_plan)."""
    schedule = np.asarray(schedule, dtype=bool)
    value_plan = np.asarray(value_plan, dtype=np.int32)
    K_shape = value_plan.shape

    def oracle(plans):
        scheds = np.repeat(schedule[None], plans.shape[0], axis=0)
        return predicate(target.evaluate_schedules(scheds, plans))

    events, iters = _ddmin(
        value_events_of(value_plan),
        lambda kept: plan_with_events(K_shape, kept), oracle,
        max_batch, max_iters)
    minimal = plan_with_events(K_shape, events)
    out = target.evaluate_schedules(schedule[None], minimal[None])
    outcome = {k: v[0] for k, v in out.items()}
    return minimal, outcome, iters


def verify_one_minimal(target: FuzzTarget, schedule: np.ndarray,
                       predicate: Predicate,
                       value_plan: Optional[np.ndarray] = None) -> bool:
    """True iff re-enabling ANY single dropped link — and retracting ANY
    single value-substitution event — loses the finding: one batched
    pass over all singles per event kind (the ddmin postcondition).
    (round_tpu/fuzz/minimize.py::verify_one_minimal)."""
    schedule = np.asarray(schedule, dtype=bool)
    events = _dropped_events(schedule)
    if events.shape[0]:
        cands = []
        for i in range(events.shape[0]):
            keep = np.delete(events, i, axis=0)
            cands.append(_with_events(schedule, keep))
        vp = None if value_plan is None else np.repeat(
            value_plan[None], len(cands), axis=0)
        ok = predicate(target.evaluate_schedules(np.stack(cands), vp))
        if bool(np.any(ok)):
            return False
    vev = value_events_of(value_plan)
    if vev.shape[0]:
        plans = []
        for i in range(vev.shape[0]):
            keep = np.delete(vev, i, axis=0)
            plans.append(plan_with_events(value_plan.shape, keep))
        scheds = np.repeat(schedule[None], len(plans), axis=0)
        ok = predicate(target.evaluate_schedules(scheds, np.stack(plans)))
        if bool(np.any(ok)):
            return False
    return True


def minimize(target: FuzzTarget, row: Dict[str, np.ndarray],
             predicate: Predicate,
             log_fn: Optional[Callable[[str], None]] = None
             ) -> MinimizeResult:
    """The full pipeline: family shrink -> materialize -> link ddmin ->
    value-event ddmin.

    Raises ValueError if `row` does not reproduce under `predicate` to
    begin with (a minimizer fed a non-finding would silently 'minimize'
    to the empty schedule).
    (round_tpu/fuzz/minimize.py::minimize)."""
    row = genome._fill_value_fields(
        {k: np.asarray(v) for k, v in row.items()})
    pop = genome.Population.from_rows([row])
    if not bool(predicate(target.evaluate(pop))[0]):
        raise ValueError(
            f"genome does not reproduce under {getattr(predicate, '__name__', predicate)!r}; "
            "nothing to minimize")
    shrunk = shrink_genome(target, row, predicate)
    sched0 = genome.row_schedule(shrunk, target.horizon,
                                 device=target.device)
    vplan0 = genome.row_value_plan(shrunk, target.horizon,
                                   target.value_domain,
                                   device=target.device)
    has_values = not plan_is_trivial(vplan0)
    vp_arg = vplan0 if has_values else None
    d0 = int(_dropped_events(sched0).shape[0])
    v0 = int(value_events_of(vp_arg).shape[0])
    minimal, outcome, iters = shrink_schedule(
        target, sched0, predicate, value_plan=vp_arg)
    vplan = vp_arg
    if has_values:
        vplan, outcome, it2 = shrink_value_plan(
            target, minimal, vp_arg, predicate)
        iters += it2
        if plan_is_trivial(vplan):
            vplan = None
    d1 = int(_dropped_events(minimal).shape[0])
    v1 = int(value_events_of(vplan).shape[0])
    if log_fn:
        log_fn(f"minimized: {d0} -> {d1} dropped link events, "
               f"{v0} -> {v1} value events ({iters} ddmin iterations)")
    if TRACE.enabled:
        TRACE.emit("fuzz_minimize", dropped_initial=d0, dropped_final=d1,
                   value_initial=v0, value_final=v1, iterations=iters)
    return MinimizeResult(
        schedule=minimal, outcome=outcome, dropped_initial=d0,
        dropped_final=d1, genome_row=shrunk, iterations=iters,
        value_plan=vplan, value_initial=v0, value_final=v1)
