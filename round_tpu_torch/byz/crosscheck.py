"""The proof/fuzzer cross-check: envelopes as falsifiable runtime claims.

Port of round_tpu/byz/crosscheck.py.  Every sweep runs the port's batched
evaluator on ``device`` (the card unless the caller passes another).
The seed genomes of ``liar_rows`` take their liar set, intensities and
stale share from numpy's generator as round_tpu's do; their fault
families come from the port's ``genome.seed_population``, which draws
from a ``torch.Generator`` (a listed divergence), so the search visits
other schedules than round_tpu's and the verdicts, not the counts, are
what the two packages share.

The verifier proves quorum lemmas under a declared ``n > K·f`` envelope; this
harness turns each proof into something the fuzzer can FALSIFY.  Per
protocol it runs two evolved-adversary sweeps:

  * IN-envelope — the adversary the proof admits.  For a BENIGN-model
    protocol (OTR, LastVoting: ``adversary_model == "benign"``) that is
    the full omission/crash/partition genome with the value-adversary
    family capped at ZERO liars; for a BYZANTINE-model protocol (the
    PBFT family) the cap is the proved ``f_max = (n-1)//K`` and the
    sweep is SEEDED with liar genomes (byz/adversary.py equivocation,
    stale replay, well-formed corruption) so the search starts inside
    the adversary class rather than having to rediscover it.  The claim:
    ZERO safety violations over at least ``min_schedules`` evaluated
    schedules.  A hit here means the proof and the engine disagree —
    the cross-check's whole reason to exist — so the sweep stops on it
    and reports the offending genome.

  * PAST-envelope — one notch beyond what the proof covers: a benign
    protocol faces ONE value adversary (a liar is outside its fault
    model at any f), a byzantine protocol is shrunk to ``n = K·f`` (the
    classic n = 3f boundary).  For benign protocols the claim is that
    the search FINDS a safety violation and ddmin banks a 1-minimal
    equivocation counterexample (fuzz/minimize.py shrinks over lie
    events exactly as it shrinks dropped links).

The byzantine past-envelope sweep claims LIVENESS damage, not a safety
counterexample, and the asymmetry is the measured headline: the 3-phase
commit's ``> 2n/3`` quorums stay safe under equivocation at ANY f —
two conflicting quorums intersect in ``> n/3`` senders, more than the
liars, so an honest process would have had to broadcast two digests in
one round — while what ``n > 3f`` buys is termination-with-a-decision.
The fuzzer demonstrates both halves: in-envelope PBFT decides through
its liars; at ``n = 3f`` the evolved equivocator drives honest lanes
into null-decide/undecided mass, and no safety violation exists to be
found (tests/test_byz.py pins the sweep, docs/FUZZING.md the claim).

Counters (OBSERVABILITY.md): ``byz.sweeps``, ``byz.sweep_schedules``,
``byz.violations``, ``byz.counterexamples`` — the harness half of the
``byz.*`` vocabulary; the host wire's injection half is
``chaos.byz_equivocate`` / ``chaos.byz_stale`` (runtime/chaos.py).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from round_tpu_torch.fuzz import genome
from round_tpu_torch.fuzz import minimize as fmin
from round_tpu_torch.fuzz import replay as freplay
from round_tpu_torch.fuzz.objectives import safety_violated
from round_tpu_torch.fuzz.search import FuzzTarget, make_target, search
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.rv.license import parse_envelope

_C_SWEEPS = METRICS.counter("byz.sweeps")
_C_SCHEDULES = METRICS.counter("byz.sweep_schedules")
_C_VIOLATIONS = METRICS.counter("byz.violations")
_C_BANKED = METRICS.counter("byz.counterexamples")

#: evaluator reuse across sweep arms: a benign crosscheck runs its in-
#: and past-envelope sweeps and its banking target at the same (n,
#: horizon, seed), so one target serves all three.  Keyed by everything
#: the target holds; FIFO-capped.
_TARGET_CACHE: Dict[tuple, FuzzTarget] = {}


def cached_target(protocol: str, n: int, horizon: int,
                  seed: int = 0, device=None) -> FuzzTarget:
    """make_target memoized per (protocol, n, horizon, seed, device)
    (round_tpu/byz/crosscheck.py::cached_target; default values and
    value_domain only — the sweep()/crosscheck() call shape)."""
    from round_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    key = (protocol, n, horizon, seed, str(dev))
    t = _TARGET_CACHE.get(key)
    if t is None:
        if len(_TARGET_CACHE) >= 16:
            _TARGET_CACHE.pop(next(iter(_TARGET_CACHE)))
        t = make_target(protocol, n, horizon, seed=seed, device=dev)
        _TARGET_CACHE[key] = t
    return t


def early_victim_split():
    """Predicate: all lanes decide, exactly ONE lane (the victim)
    disagrees, and the victim decided STRICTLY BEFORE every other lane.
    The host-deterministic counterexample shape for the rv-under-lies
    workout: on real wire the victim's decision precedes any honest
    decision gossip, so a monitor on the victim observes the conflict
    from a position no catch-up adoption can erase (tests/test_byz.py;
    the otr_equivocation_victim.json regression)."""

    def pred(out):
        dec = np.asarray(out["decided"])
        val = np.asarray(out["decision"])
        dr = np.asarray(out["decided_round"])
        P, n = dec.shape
        ok = np.zeros(P, dtype=bool)
        for p in range(P):
            if not dec[p].all():
                continue
            vals, counts = np.unique(val[p], return_counts=True)
            if len(vals) != 2 or counts.min() != 1:
                continue
            victim = int(np.flatnonzero(
                val[p] == vals[np.argmin(counts)])[0])
            others = np.delete(np.arange(n), victim)
            ok[p] = dr[p, victim] < dr[p, others].min()
        return ok

    pred.__name__ = "early_victim_split()"
    return pred


def adversary_budget(algo, n: int) -> tuple:
    """(f_env, in_cap): the proved fault budget at n, and how many VALUE
    adversaries the in-envelope sweep may breed — ``f_env`` for a
    byzantine-model protocol, 0 for a benign one (a liar is outside the
    benign model at any f; core/algorithm.py Algorithm.adversary_model)."""
    envelope = getattr(algo, "fault_envelope", None)
    if not envelope:
        raise ValueError(
            f"{type(algo).__name__} declares no fault_envelope; the "
            "cross-check needs one (core/algorithm.py)")
    f_env = max(0, (n - 1) // parse_envelope(envelope))
    byz = getattr(algo, "adversary_model", "benign") == "byzantine"
    return f_env, (f_env if byz else 0)


def liar_rows(n: int, horizon: int, liars: int, seed: int = 0,
              count: int = 8) -> List[Dict[str, np.ndarray]]:
    """Hand-picked seed genomes with the liar set already in place:
    ``liars`` equivocators at high intensity over fresh salts.  The
    search's selection pressure can then explore FACES (salt rerolls
    move lie_pair and the per-link face draw) instead of having to
    evolve the family from zero across a flat fitness landscape —
    essential for past-envelope sweeps where every benign schedule
    scores identically."""
    rows = []
    for c in range(count):
        rng = np.random.default_rng((seed << 8) ^ c)
        pop = genome.seed_population(int(rng.integers(2**31)), 1, n,
                                     horizon)
        row = {f: np.asarray(getattr(pop, f)[0]) for f in genome._FIELDS}
        bv = np.zeros(n, dtype=bool)
        bv[rng.choice(n, size=min(liars, n), replace=False)] = True
        row["byz_value"] = bv
        row["equiv_p8"] = np.int32(rng.integers(96, genome.P8_CAP + 1))
        # stale replay on a minority of seeds: the families compose, but
        # equivocation is the primary past-envelope weapon
        row["stale_p8"] = np.int32(rng.integers(0, 49) if c % 4 == 3
                                   else 0)
        rows.append(row)
    return rows


@dataclasses.dataclass
class SweepResult:
    """One evolved-adversary sweep at a fixed (protocol, n, liar cap)."""

    protocol: str
    n: int
    in_envelope: bool
    f_env: int                      # proved fault budget at this n
    value_cap: int                  # liars the gene pool may hold
    evaluated: int
    generations: int
    schedules_per_sec: float
    wall_s: float
    violation: bool                 # any safety hit over the sweep
    best_outcome: Dict[str, float]
    timeboxed: bool = False         # time_box_s expired before budget
    best_row: Optional[Dict[str, np.ndarray]] = None

    def record(self) -> Dict[str, Any]:
        """The SOAK.jsonl-shaped summary (no arrays)."""
        return {
            "protocol": self.protocol, "n": self.n,
            "in_envelope": self.in_envelope, "f_env": self.f_env,
            "value_cap": self.value_cap, "evaluated": self.evaluated,
            "generations": self.generations,
            "schedules_per_sec": round(self.schedules_per_sec, 1),
            "wall_s": round(self.wall_s, 2),
            "violation": self.violation,
            "timeboxed": self.timeboxed,
            "best_outcome": self.best_outcome,
        }


def _default_horizon(n: int) -> int:
    """The sweep horizon: 12 rounds for every realistic n (make_target
    rounds it up to whole phases, so 3-round Bcp and 6-round
    PbftViewChange both land on 12)."""
    return 4 * max(1, min(3, n))


def sweep(protocol: str, n: int, *, in_envelope: bool,
          min_schedules: int = 10_000, pop_size: int = 512,
          horizon: Optional[int] = None, seed: int = 0,
          time_box_s: Optional[float] = None,
          log_fn: Optional[Callable[[str], None]] = None,
          device=None) -> SweepResult:
    """One envelope sweep.  In-envelope: the proof's adversary (benign →
    value family OFF; byzantine → ``f_env`` liars, liar-seeded), run to
    ``min_schedules`` unless a safety hit falsifies the proof first.
    Past-envelope: one value adversary past the proof (benign → 1 liar;
    byzantine callers pass the shrunk ``n = K·f`` and get ``f_env + 1``
    liars), stopped at the first safety hit."""
    target = cached_target(protocol, n,
                           horizon if horizon is not None
                           else _default_horizon(n), seed=seed,
                           device=device)
    f_env, in_cap = adversary_budget(target.algo, n)
    # past-envelope: one notch beyond the proof — a benign protocol
    # faces its FIRST liar (in_cap 0 -> 1), a byzantine one gets one
    # liar past the (possibly zero, at n = K·f) proved budget
    cap = in_cap if in_envelope else in_cap + 1
    seeds = (liar_rows(n, target.horizon, cap, seed=seed)
             if cap > 0 else None)
    generations = max(1, -(-min_schedules // pop_size))
    t0 = time.perf_counter()
    res = search(target, pop_size=pop_size, generations=generations,
                 seed=seed, stop_when=safety_violated(), value_cap=cap,
                 seed_rows=seeds, time_box_s=time_box_s, log_fn=log_fn)
    wall = time.perf_counter() - t0
    hit = bool(res.best_outcome and
               (res.best_outcome["agreement_viol"]
                + res.best_outcome["validity_viol"]) > 0)
    _C_SWEEPS.inc()
    _C_SCHEDULES.inc(res.evaluated)
    if hit:
        _C_VIOLATIONS.inc()
    return SweepResult(
        protocol=protocol, n=n, in_envelope=in_envelope, f_env=f_env,
        value_cap=cap, evaluated=res.evaluated,
        generations=res.generations,
        schedules_per_sec=res.schedules_per_sec, wall_s=wall,
        violation=hit, best_outcome=res.best_outcome,
        timeboxed=(time_box_s is not None and not hit
                   and res.evaluated < min_schedules
                   and wall >= time_box_s),
        best_row=res.best_row if hit else None)


def bank_counterexample(target: FuzzTarget, row: Dict[str, np.ndarray],
                        path: Optional[str] = None, *,
                        host_record: bool = False, timeout_ms: int = 400,
                        meta: Optional[Dict[str, Any]] = None,
                        log_fn: Optional[Callable[[str], None]] = None
                        ) -> Dict[str, Any]:
    """Minimize a safety-violating genome to a 1-minimal (schedule,
    value plan) pair and bank it as a v2 artifact: ddmin over dropped
    links AND lie events (fuzz/minimize.py), the 1-minimality
    postcondition verified, the engine outcome recorded (and the
    host-wire outcome with ``host_record`` — an in-process socket
    cluster with the forged frames on the real wire)."""
    pred = safety_violated()
    mr = fmin.minimize(target, row, pred, log_fn=log_fn)
    assert fmin.verify_one_minimal(target, mr.schedule, pred,
                                   value_plan=mr.value_plan), \
        "ddmin postcondition failed: result is not 1-minimal"
    art = freplay.make_artifact(
        protocol=target.name, schedule=mr.schedule,
        values=target.init_values, seed=target.seed,
        value_plan=mr.value_plan,
        meta={"objective": "safety_violated()",
              "value_events": {"initial": mr.value_initial,
                               "minimal": mr.value_final},
              "dropped_links": {"initial": mr.dropped_initial,
                                "minimal": mr.dropped_final},
              **(meta or {})})
    art["expected"]["engine"] = freplay.replay_engine(
        art, device=target.device)
    if host_record:
        art["expected"]["host"] = freplay.replay_host_threads(
            art, timeout_ms=timeout_ms, device=target.device)
    if path:
        freplay.dump_artifact(path, art)
    _C_BANKED.inc()
    return art


@dataclasses.dataclass
class CrosscheckResult:
    """In + past envelope sweeps for one protocol, with the claims
    evaluated.  ``ok`` is the cross-check verdict: the proof's envelope
    held in-envelope AND the past-envelope sweep behaved as its model
    predicts (benign: safety counterexample found; byzantine: none
    exists, the liars' damage is liveness-shaped)."""

    protocol: str
    inside: SweepResult
    past: SweepResult
    min_schedules: int
    artifact: Optional[Dict[str, Any]] = None
    artifact_path: Optional[str] = None
    evaluator_reused: bool = False      # past arm ran on the in arm's target

    @property
    def in_ok(self) -> bool:
        """True when the in-envelope claim HELD: no safety violation,
        over the full schedule budget — or over however many schedules
        the wall-clock box allowed (a time-box cutoff is an unfinished
        sweep, not a falsified proof; ``inside.timeboxed`` records it,
        and callers that need the full budget — the acceptance test —
        assert ``inside.evaluated >= N`` themselves)."""
        return (not self.inside.violation
                and (self.inside.evaluated >= self.min_schedules
                     or self.inside.timeboxed))

    @property
    def past_ok(self) -> bool:
        """Benign model: the expected safety break was found (or the
        time box expired before the search could finish looking — an
        unfinished sweep is inconclusive, not a refuted claim; the
        acceptance tests assert ``past.violation`` and the banked
        artifact directly).  Byzantine model: NO safety break exists to
        find, so any hit fails regardless of the box."""
        if self._expect_safety_break():
            return self.past.violation or self.past.timeboxed
        return not self.past.violation

    def _expect_safety_break(self) -> bool:
        from round_tpu_torch.apps.selector import select

        return getattr(select(self.protocol), "adversary_model",
                       "benign") == "benign"

    @property
    def ok(self) -> bool:
        return self.in_ok and self.past_ok

    def record(self) -> Dict[str, Any]:
        rec = {
            "protocol": self.protocol, "ok": self.ok,
            "in_ok": self.in_ok, "past_ok": self.past_ok,
            "expect_past_safety_break": self._expect_safety_break(),
            "evaluator_reused": self.evaluator_reused,
            "inside": self.inside.record(), "past": self.past.record(),
        }
        if self.artifact is not None:
            rec["artifact"] = {
                "path": self.artifact_path,
                "value_subs": len(self.artifact.get("value_subs", [])),
                "stale_subs": len(self.artifact.get("stale_subs", [])),
                "drops": len(self.artifact.get("drops", [])),
            }
        return rec


def crosscheck(protocol: str, n: int, *, min_schedules: int = 10_000,
               pop_size: int = 512, seed: int = 0,
               time_box_s: Optional[float] = None,
               bank_dir: Optional[str] = None,
               host_record: bool = False,
               log_fn: Optional[Callable[[str], None]] = None,
               device=None) -> CrosscheckResult:
    """The full cross-check for one protocol: in-envelope sweep at
    ``n``, past-envelope sweep (benign → same n + 1 liar; byzantine →
    shrunk to ``n = K·f`` with the liar budget one past the shrunk
    envelope), and — when the past-envelope sweep finds the expected
    safety violation — a minimized counterexample banked under
    ``bank_dir`` as ``<protocol>_equivocation_<n>.json``."""
    from round_tpu_torch.apps.selector import select

    algo = select(protocol)
    inside = sweep(protocol, n, in_envelope=True,
                   min_schedules=min_schedules, pop_size=pop_size,
                   seed=seed, time_box_s=time_box_s, log_fn=log_fn,
                   device=device)
    if getattr(algo, "adversary_model", "benign") == "byzantine":
        # shrink to the classic boundary n = K·f (n > K·f just fails)
        k = parse_envelope(algo.fault_envelope)
        f_env, _ = adversary_budget(algo, n)
        n_past = k * max(1, f_env)
    else:
        n_past = n
    past = sweep(protocol, n_past, in_envelope=False,
                 min_schedules=min_schedules, pop_size=pop_size,
                 seed=seed, time_box_s=time_box_s, log_fn=log_fn,
                 device=device)
    out = CrosscheckResult(protocol=protocol, inside=inside, past=past,
                           min_schedules=min_schedules,
                           # benign protocols keep (n, horizon): the past
                           # sweep reran on the in sweep's target
                           evaluator_reused=n_past == n)
    if past.violation and past.best_row is not None and bank_dir:
        # the banking target must match the past sweep's exactly — the
        # winning row's hash draws are (n, horizon, value_domain)-keyed
        # (cached_target: this IS the past sweep's target)
        target = cached_target(protocol, n_past, _default_horizon(n_past),
                               seed=seed, device=device)
        path = os.path.join(
            bank_dir, f"{protocol}_equivocation_{n_past}.json")
        out.artifact = bank_counterexample(
            target, past.best_row, path, host_record=host_record,
            meta={"crosscheck": {"n_in": n, "n_past": n_past,
                                 "search_seed": seed}},
            log_fn=log_fn)
        out.artifact_path = path
    return out
