"""The generational loop: the batched engine as a search engine.

Port of round_tpu/fuzz/search.py.  One generation = ONE batched
evaluation of the whole population: every round runs the general engine's
``executor.run_round`` under ``torch.func.vmap`` over the population axis,
on ``[P, n, n]`` HO masks from ``engine.fast.mix_ho`` (ANDed with the
batched byzantine silence) and ``[P, n, n]`` value events from
``byz.adversary.value_events``.  The Python round loop therefore takes
``horizon`` steps a generation whatever P is, and nothing inside it goes
back to the host: the genome leaves are staged on the device in one copy,
the outcome dict comes back in one (``genome.stage``/``genome.fetch``).
Coverage cells, which (round, link-pattern)
signatures a schedule exercises, are computed in the same loop; a global
coverage map feeds a novelty bonus between generations (numpy).

round_tpu jits the evaluation and donates its buffers; the port runs it
eagerly on ``device`` (``cuda`` unless the caller passes another).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import vmap

from round_tpu_torch.byz.adversary import (
    VP_NONE, ValueAdversary, lie_pair, plan_events, value_events,
)
from round_tpu_torch.engine import executor, fast
from round_tpu_torch.engine.executor import LocalTopology, init_lanes
from round_tpu_torch.fuzz import genome, objectives
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.utils.device import resolve_device
from round_tpu_torch.utils.tree import tree_map

# coverage quantization: per round, 3 min-mailbox buckets (below n/3 /
# below 2n/3 / quorum-safe) x 4 delivered-link-density quarters
_MH_BUCKETS = 3
_DB_BUCKETS = 4
CELLS_PER_ROUND = _MH_BUCKETS * _DB_BUCKETS


@dataclasses.dataclass
class FuzzTarget:
    """One protocol wired for batched genome evaluation
    (round_tpu/fuzz/search.py::FuzzTarget).

    ``evaluate(pop)`` runs every genome as a population lane;
    ``evaluate_schedules(schedules)`` runs explicit [K, T, n, n] HO
    schedules (the minimizer's oracle) through the same engine and key, so
    the two are bit-comparable.  Both return numpy outcome dicts.  The
    genome's byz_value/equiv_p8/stale_p8 fields drive per-(round, src,
    dst) payload substitution through the protocol's lie model;
    ``evaluate_schedules(scheds, value_plans=...)`` is the explicit-plan
    twin.  ``value_domain`` is the claimed-value range; safety objectives
    are scoped to honest lanes."""

    name: str
    algo: Any
    n: int
    horizon: int                       # rounds simulated (phases * k)
    phases: int
    rounds_per_phase: int
    init_values: np.ndarray            # [n] proposals
    seed: int
    value_domain: int = 0              # claimed-value range for lies
    device: Optional[torch.device] = None
    _init_dev: Optional[torch.Tensor] = dataclasses.field(
        repr=False, default=None)

    @property
    def n_cells(self) -> int:
        return self.horizon * CELLS_PER_ROUND

    @property
    def init_dev(self) -> torch.Tensor:
        """The proposals on the device, copied there once."""
        if self._init_dev is None:
            self._init_dev = torch.as_tensor(self.init_values,
                                             device=self.device)
        return self._init_dev

    @property
    def lie(self):
        from round_tpu_torch.byz.lies import lie_for

        return lie_for(self.name)

    # -- batched evaluation -------------------------------------------------

    def evaluate(self, pop: genome.Population) -> Dict[str, np.ndarray]:
        """Outcomes of every genome of ``pop``: one batched evaluation."""
        sev = genome.severity(pop, self.horizon)
        # one copy in (the leaves and the float32 severity), one copy out
        staged = genome.stage({**pop.arrays(),
                               "severity": sev.astype(np.float32)},
                              self.device)
        out = self._eval_genomes(staged, staged["severity"])
        METRICS.counter("fuzz.dispatches").inc()
        METRICS.counter("fuzz.candidates").inc(pop.size)
        res = genome.fetch(out)
        res["severity"] = sev
        return res

    def evaluate_schedules(self, schedules: np.ndarray,
                           value_plans: Optional[np.ndarray] = None
                           ) -> Dict[str, np.ndarray]:
        """Outcomes of explicit deliver schedules [K, T, n, n] bool, each
        optionally paired with a value-substitution plan [K, T, n, n]
        int32 (byz/adversary.py opcodes).  K is padded up to a power of
        two (repeating the last row), as round_tpu pads it."""
        schedules = np.asarray(schedules, dtype=bool)
        K, T = schedules.shape[0], schedules.shape[1]
        if T != self.horizon:
            raise ValueError(
                f"schedule length {T} != target horizon {self.horizon}")
        if value_plans is not None:
            value_plans = np.asarray(value_plans, dtype=np.int32)
            if value_plans.shape != schedules.shape:
                raise ValueError(
                    f"value plans {value_plans.shape} != schedules "
                    f"{schedules.shape}")
        K_pad = 1 << max(0, (K - 1).bit_length())
        if K_pad != K:
            pad = np.repeat(schedules[-1:], K_pad - K, axis=0)
            schedules = np.concatenate([schedules, pad], axis=0)
            if value_plans is not None:
                vpad = np.repeat(value_plans[-1:], K_pad - K, axis=0)
                value_plans = np.concatenate([value_plans, vpad], axis=0)
        arrays = {"schedules": schedules}
        if value_plans is not None:
            arrays["plans"] = value_plans
        staged = genome.stage(arrays, self.device)
        out = self._eval_schedules(staged["schedules"], staged.get("plans"))
        METRICS.counter("fuzz.dispatches").inc()
        METRICS.counter("fuzz.candidates").inc(int(schedules.shape[0]))
        return {k: v[:K] for k, v in genome.fetch(out).items()}

    # -- the batched program -------------------------------------------------

    def _run(self, P: int, ho_fn, events_fn=None, coverage: bool = False):
        """Run P candidates through the general engine at once: each round
        is ONE ``executor.run_round`` under ``vmap`` over the population
        axis.  ``ho_fn(r)`` gives the round's ``[P, n, n]`` HO masks,
        ``events_fn(r)`` (or None: no adversary) its ``[P, n, n]`` value
        events.  Returns (state, decided_round, coverage or None)."""
        n, k, dev = self.n, self.rounds_per_phase, self.device
        algo = self.algo
        topo = LocalTopology(n, dev)
        io = {"initial_value": self.init_dev}
        state0 = init_lanes(algo, io, n, topo)
        # the words of round_tpu's jax.random.PRNGKey(seed): one key for the
        # whole population
        key = (0, self.seed)

        def batch(x):
            return x.expand((P,) + tuple(x.shape)).contiguous()

        state = tree_map(batch, state0)
        prev = None
        if events_fn is not None:
            prev = [tree_map(batch, p) for p in executor.adversary_prev0(
                algo, state0, topo, ValueAdversary(n, k, None))]
        done = torch.zeros((P, n), dtype=torch.bool, device=dev)
        dround = torch.full((P, n), -1, dtype=torch.int32, device=dev)
        cells = []
        lie = self.lie
        for phase in range(self.phases):
            for j, rnd in enumerate(algo.rounds):
                r = phase * k + j
                ho = ho_fn(r)
                if events_fn is None:
                    def step(st, dn, h):
                        return executor.run_round(rnd, st, dn, r, h, key,
                                                  topo)

                    state, done = vmap(step)(state, done, ho)
                else:
                    def step(st, dn, h, sv, sl, pv):
                        adv = ValueAdversary(n, k, lambda _r: (sv, sl),
                                             lie=lie)
                        return executor.run_round(
                            rnd, st, dn, r, h, key, topo, adversary=adv,
                            adv_class=j, adv_prev=pv)

                    state, done, prev[j] = vmap(step)(
                        state, done, ho, *events_fn(r), prev[j])
                dec = executor._decided_or_false(algo, state, n, dev)
                dround = torch.where(dec & (dround < 0), r, dround)
                if coverage:
                    cells.append(self._cells(ho))
        cov = torch.stack(cells, dim=1).reshape(P, -1) if coverage else None
        return state, dround, cov

    def _cells(self, ho: torch.Tensor) -> torch.Tensor:
        """[P, CELLS_PER_ROUND] bool: the round's cell per candidate, (min-
        mailbox bucket, density quarter) (round_tpu/fuzz/search.py::
        FuzzTarget._coverage_bits, one round of it)."""
        n = self.n
        heard = ho.to(torch.int32).sum(dim=-1)              # [P, n]
        mh = heard.min(dim=-1).values
        links = ho.to(torch.int64).sum(dim=(-2, -1))
        mh_b = torch.where(mh * 3 <= n, 0, torch.where(mh * 3 <= 2 * n, 1, 2))
        db = torch.clamp((links * _DB_BUCKETS) // (n * n + 1), 0,
                         _DB_BUCKETS - 1)
        cell = mh_b * _DB_BUCKETS + db
        return cell[:, None] == torch.arange(CELLS_PER_ROUND,
                                             device=ho.device)

    def _outcome(self, st, dround, honest=None, claimed_fn=None):
        decided = self.algo.decided(st)
        decision = torch.as_tensor(self.algo.decision(st))
        # lie-sourced decisions are valid inputs (objectives extra_valid)
        extra_valid = None if claimed_fn is None else claimed_fn(decision)
        obj = objectives.lane_objectives(
            decided, decision, dround, self.init_dev, self.horizon,
            honest=honest,
            null_value=getattr(self.algo, "decision_null", None),
            extra_valid=extra_valid)
        return {
            "decided": decided,
            "decision": decision,
            "decided_round": dround,
            **obj,
        }

    def _eval_genomes(self, t: Dict[str, torch.Tensor],
                      sev: torch.Tensor) -> Dict[str, torch.Tensor]:
        """round_tpu/fuzz/search.py::FuzzTarget._make_genome_eval, over the
        staged population leaves ``t``."""
        n = self.n
        P = t["crashed"].shape[0]
        mix = fast.FaultMix(**{f: t[f] for f in genome._FIELDS
                               if f != "byz"})

        def ho_fn(r):
            return fast.mix_ho(mix, r) & ~genome.byz_silence(
                t["byz"], t["salt0"], t["salt1"], r, n)

        def events_fn(r):
            return value_events(t["byz_value"], t["equiv_p8"], t["stale_p8"],
                                t["salt0"], t["salt1"], r, n,
                                self.value_domain)

        st, dround, cov = self._run(P, ho_fn, events_fn, coverage=True)
        byz_value, equiv_p8 = t["byz_value"], t["equiv_p8"]
        # honest = cannot lie: safety objectives are scoped to
        # non-value-adversary lanes
        honest = ~(byz_value & ((equiv_p8 > 0) | (t["stale_p8"] > 0))[:, None])
        # an active equivocator's two faces are lie-sourced inputs:
        # deciding one is not a validity bug
        equiv_active = byz_value.any(dim=1) & (equiv_p8 > 0)
        va, vb = lie_pair(t["salt0"], t["salt1"], self.value_domain)

        def claimed(decision):
            hit = (decision == va[:, None]) | (decision == vb[:, None])
            return equiv_active[:, None] & hit

        out = self._outcome(st, dround, honest=honest, claimed_fn=claimed)
        out["coverage"] = cov
        out["score"] = objectives.combined_score(out, sev, self.horizon)
        return out

    def _eval_schedules(self, scheds: torch.Tensor,
                        plans: Optional[torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """round_tpu/fuzz/search.py::FuzzTarget._make_schedule_eval:
        schedules [K, T, n, n] (rounds past T clamp to the last row), with
        or without plans."""
        K, T = scheds.shape[0], scheds.shape[1]

        def ho_fn(r):
            return scheds[:, min(r, T - 1)]

        events_fn = None
        if plans is not None:
            def events_fn(r):
                return plan_events(plans[:, min(r, T - 1)])

        st, dround, _ = self._run(K, ho_fn, events_fn)
        if plans is None:
            return self._outcome(st, dround)
        # honest = senders the plan never substitutes for
        honest = ~(plans != VP_NONE).any(dim=1).any(dim=1)

        def claimed(decision):
            # a decision equal to any value the plan claims is excused from
            # the validity count, as on the genome path
            sub = plans[:, :, :, :, None]
            hit = (sub == decision[:, None, None, None, :]) & (sub >= 0)
            return hit.flatten(1, 3).any(dim=1)

        return self._outcome(st, dround, honest=honest, claimed_fn=claimed)


def make_target(algo_name: str, n: int, horizon: int, seed: int = 0,
                values: Optional[np.ndarray] = None,
                algo_options: Optional[dict] = None,
                value_domain: Optional[int] = None,
                device=None) -> FuzzTarget:
    """Build a FuzzTarget for a selector-registered protocol on ``device``
    (round_tpu/fuzz/search.py::make_target).

    ``horizon`` is rounded UP to whole phases.  Default proposals are the
    "mixed" shape (i % 4) so agreement is non-trivial; pass ``values`` to
    pin them.  ``value_domain`` bounds the values a lie can claim
    (default: the proposal range plus one fabricable non-proposal)."""
    from round_tpu_torch.apps.selector import select

    algo = select(algo_name, algo_options or {})
    k = algo.rounds_per_phase
    phases = max(1, -(-horizon // k))
    if values is None:
        values = (np.arange(n, dtype=np.int32) % 4).astype(np.int32)
    else:
        values = np.asarray(values, dtype=np.int32)
        if values.shape != (n,):
            raise ValueError(f"values must be [n={n}], got {values.shape}")
    if value_domain is None:
        value_domain = int(values.max(initial=0)) + 2
    return FuzzTarget(name=algo_name, algo=algo, n=n, horizon=phases * k,
                      phases=phases, rounds_per_phase=k,
                      init_values=values, seed=seed,
                      value_domain=int(value_domain),
                      device=resolve_device(device))


# ---------------------------------------------------------------------------
# The generational loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FuzzResult:
    """round_tpu/fuzz/search.py::FuzzResult."""

    target: FuzzTarget
    population: genome.Population
    outcome: Dict[str, np.ndarray]      # last generation's batched outcome
    best_row: Dict[str, np.ndarray]     # best genome ever seen
    best_score: float
    best_outcome: Dict[str, float]      # its scalar objective components
    coverage_map: np.ndarray            # [n_cells] bool, global
    generations: int
    evaluated: int
    wall_s: float
    history: List[Dict[str, float]]

    @property
    def schedules_per_sec(self) -> float:
        return self.evaluated / self.wall_s if self.wall_s > 0 else 0.0


def _scalar_outcome(out: Dict[str, np.ndarray], i: int) -> Dict[str, float]:
    return {
        "undecided": float(out["undecided"][i]),
        "decide_round": int(out["decide_round"][i]),
        "agreement_viol": int(out["agreement_viol"][i]),
        "validity_viol": int(out["validity_viol"][i]),
        "score": float(out["score"][i]),
        "severity": float(out["severity"][i]),
    }


def search(target: FuzzTarget, pop_size: int, generations: int, *,
           seed: int = 0, elite_frac: float = 0.125, tournament: int = 3,
           novelty_weight: float = 0.5, time_box_s: Optional[float] = None,
           stop_when: Optional[Callable[[Dict[str, np.ndarray]],
                                        np.ndarray]] = None,
           value_cap: Optional[int] = None,
           seed_rows: Optional[List[Dict[str, np.ndarray]]] = None,
           log_fn: Optional[Callable[[str], None]] = None) -> FuzzResult:
    """Evolve ``pop_size`` fault schedules for up to ``generations``
    generations, or until ``time_box_s`` runs out, or some candidate
    satisfies ``stop_when`` (round_tpu/fuzz/search.py::search).

    Selection pressure = combined score + novelty_weight x the fraction of
    a candidate's coverage cells the global map had not seen.  Elites
    survive verbatim; the rest is family-block crossover of tournament
    winners plus per-family point mutations.  ``value_cap`` None keeps the
    value adversary off (opt-in with ``value_cap >= 1``); ``seed_rows``
    splices hand-picked genomes over the seed population's head."""
    rng = np.random.default_rng(seed)
    pop = genome.seed_population(seed, pop_size, target.n, target.horizon)
    if seed_rows:
        rows = [genome._fill_value_fields(dict(r)) for r in seed_rows]
        for i, row in enumerate(rows[:pop.size]):
            for f in genome._FIELDS:
                getattr(pop, f)[i] = np.asarray(row[f])
    n_elite = max(1, int(pop_size * elite_frac))
    coverage = np.zeros(target.n_cells, dtype=bool)
    best_score, best_row, best_out = -np.inf, None, None
    history: List[Dict[str, float]] = []
    evaluated = 0
    t0 = time.perf_counter()
    gen = 0
    out = None
    for gen in range(1, generations + 1):
        out = target.evaluate(pop)
        evaluated += pop.size
        METRICS.counter("fuzz.generations").inc()

        cov = out["coverage"]                       # [P, C] bool
        new_cells = (cov & ~coverage[None, :]).sum(axis=1)
        novelty = new_cells / max(1, CELLS_PER_ROUND)
        coverage |= cov.any(axis=0)
        METRICS.gauge("fuzz.coverage_cells").set(int(coverage.sum()))

        score = out["score"].astype(np.float64)
        sel_score = score + novelty_weight * novelty

        gi = int(np.argmax(score))
        if score[gi] > best_score:
            best_score = float(score[gi])
            best_row = pop.row(gi)
            best_out = _scalar_outcome(out, gi)
        rec = {
            "gen": gen,
            "best": round(float(score.max()), 4),
            "mean": round(float(score.mean()), 4),
            "best_ever": round(best_score, 4),
            "coverage_cells": int(coverage.sum()),
            "new_cells": int(new_cells.sum()),
        }
        history.append(rec)
        if TRACE.enabled:
            TRACE.emit("fuzz_gen", **rec)
        if log_fn:
            log_fn(f"gen {gen}: best {rec['best']} mean {rec['mean']} "
                   f"coverage {rec['coverage_cells']}/{target.n_cells}")

        hit = stop_when is not None and bool(np.any(stop_when(out)))
        out_of_time = (time_box_s is not None
                       and time.perf_counter() - t0 > time_box_s)
        if hit or out_of_time or gen == generations:
            break

        # -- selection ------------------------------------------------------
        order = np.argsort(-sel_score)
        elites = pop.take(order[:n_elite])
        n_child = pop_size - n_elite
        # tournament over the whole population, novelty included
        cand = rng.integers(0, pop_size, (2, n_child, tournament))
        pa = cand[0][np.arange(n_child),
                     np.argmax(sel_score[cand[0]], axis=1)]
        pb = cand[1][np.arange(n_child),
                     np.argmax(sel_score[cand[1]], axis=1)]
        children = genome.mutate(
            rng, genome.crossover(rng, pop, pa, pb), target.horizon,
            value_cap=0 if value_cap is None else value_cap)
        pop = genome.Population(**{
            f: np.concatenate([getattr(elites, f), getattr(children, f)])
            for f in genome._FIELDS})

    wall = time.perf_counter() - t0
    return FuzzResult(
        target=target, population=pop, outcome=out,
        best_row=best_row, best_score=best_score, best_outcome=best_out,
        coverage_map=coverage, generations=gen, evaluated=evaluated,
        wall_s=wall, history=history)
