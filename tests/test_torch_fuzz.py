"""Port parity of the fault-schedule fuzzer (round_tpu_torch/fuzz).

Mirrors the non-host tests of tests/test_fuzz.py and holds the port
against round_tpu bit for bit (tolerance 0; the float32 scores in raw
bits): the genetic operators under one ``np.random.Generator`` seed,
``row_schedule`` and the ``mix_ho`` pin, the objectives on crafted and
random outcomes, ``FuzzTarget.evaluate`` on round_tpu's own seed
populations (OTR, LastVoting, PBFT with value fields set, and PBFT-VC),
``evaluate_schedules`` with and without plans, one whole ``search``
trajectory and one ``minimize`` result.  ``seed_population`` draws through
the port's ``standard_mix`` (a torch.Generator), so the tests feed
round_tpu's seed populations through numpy.  Ben-Or draws coins from the
update key, which the port hashes where round_tpu splits threefry keys:
its genome evaluation is held against its own schedule evaluation, and
against round_tpu only by decided fractions.

The evaluator is one batched program: ``run_round`` runs ``horizon`` times
per evaluation whatever P is, and torch's vmap fallback warning is an
error in every evaluation here."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.fuzz import genome as jgenome
from round_tpu.fuzz import minimize as jmin
from round_tpu.fuzz import objectives as jobj
from round_tpu.fuzz.search import make_target as jmake_target
from round_tpu.fuzz.search import search as jsearch
from round_tpu_torch.byz.adversary import VP_NONE, VP_STALE
from round_tpu_torch.engine import executor as texec
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.fuzz import genome as tgenome
from round_tpu_torch.fuzz import minimize as tmin
from round_tpu_torch.fuzz import objectives as tobj
from round_tpu_torch.fuzz.search import make_target as tmake_target
from round_tpu_torch.fuzz.search import search as tsearch
from round_tpu_torch.obs.metrics import METRICS

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
OUT_KEYS = ("decided", "decision", "decided_round", "undecided",
            "decide_round", "agreement_viol", "validity_viol")

BAD = {
    "crashed": np.zeros(4, bool), "crash_round": np.int32(0),
    "side": np.array([0, 0, 1, 1], np.int32),
    "heal_round": np.int32(8), "rotate_down": np.int32(0),
    "p8": np.int32(128), "salt0": np.int32(77), "salt1": np.int32(88),
    "byz": np.zeros(4, bool),
}


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    """torch's "performance drop" warning (an op with no batching rule run
    as a Python loop) is an error in every test of this file."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


def _port_pop(jpop) -> tgenome.Population:
    return tgenome.Population(**{f: np.array(getattr(jpop, f))
                                 for f in jgenome._FIELDS})


def _same_bits(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _same_outcome(got, want, keys):
    for k in keys:
        _same_bits(got[k], want[k], k)


# ---------------------------------------------------------------------------
# genome: operators + engine/schedule equivalence
# ---------------------------------------------------------------------------

def test_genome_operators_preserve_shapes_and_bounds():
    """test_fuzz.py's bounds, and every mutate/crossover equal to round_tpu's
    under the same np.random.Generator seed."""
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    jpop = jgenome.seed_population(seed=1, P=32, n=5, horizon=10)
    pop = _port_pop(jpop)
    assert pop.size == 32 and pop.n == 5
    mut, jmut = pop, jpop
    for _ in range(8):
        mut = tgenome.mutate(rng, mut, horizon=10, value_cap=1)
        jmut = jgenome.mutate(jrng, jmut, horizon=10, value_cap=1)
        for f in tgenome._FIELDS:
            _same_bits(getattr(mut, f), getattr(jmut, f), f)
    assert (mut.p8 >= 0).all() and (mut.p8 <= tgenome.P8_CAP).all()
    assert (mut.heal_round >= 0).all() and (mut.heal_round <= 10).all()
    assert (mut.crashed.sum(axis=1) <= max(1, 5 // 3)).all()
    assert (mut.byz.sum(axis=1) <= max(1, 5 // 3)).all()
    assert not pop.byz.any()                       # operators return copies

    perm = rng.permutation(32)
    jrng.permutation(32)
    child = tgenome.crossover(rng, mut, np.arange(32), perm)
    jchild = jgenome.crossover(jrng, jmut, np.arange(32), perm)
    for f in tgenome._FIELDS:
        _same_bits(getattr(child, f), getattr(jchild, f), f)
    _same_bits(tgenome.severity(child, 10), jgenome.severity(jchild, 10))


def test_port_seed_population_structure():
    """The port's own seed population: standard_mix's four families, byz
    off, every 8th row fault-free."""
    pop = tgenome.seed_population(seed=1, P=32, n=5, horizon=10)
    assert pop.size == 32 and pop.n == 5
    assert not pop.byz.any() and not pop.byz_value.any()
    clean = np.arange(32) % 8 == 7
    assert (pop.p8[clean] == 0).all() and not pop.crashed[clean].any()
    assert (pop.heal_round[2::4][~clean[2::4]] == 5).all()


@pytest.mark.parametrize("n", [4, 5, 7])
def test_row_schedule_and_value_plan_match_round_tpu(n):
    jpop = jgenome.seed_population(seed=n, P=6, n=n, horizon=12)
    rng = np.random.default_rng(n)
    jpop.byz[:] = rng.random(jpop.byz.shape) < 0.3
    jpop.byz_value[:] = rng.random(jpop.byz_value.shape) < 0.4
    jpop.equiv_p8[:] = rng.integers(0, 233, 6)
    jpop.stale_p8[:] = rng.integers(0, 233, 6)
    for s in range(6):
        row = jpop.row(s)
        _same_bits(tgenome.row_schedule(row, 12, device=CPU),
                   jgenome.row_schedule(row, 12), ("schedule", s))
        _same_bits(tgenome.row_value_plan(row, 12, 5, device=CPU),
                   jgenome.row_value_plan(row, 12, 5), ("plan", s))


def test_genome_matches_fused_engine_mix_ho():
    """The genome's mask formula (byz off) IS the fused engine's hash-mode
    link formula: row_schedule == fast.mix_ho row for row, in the port."""
    pop = tgenome.seed_population(seed=3, P=6, n=5, horizon=7)
    mix = pop.mix(CPU)
    for r in (0, 3, 6):
        ho = tfast.mix_ho(mix, r).numpy()
        for s in range(pop.size):
            sched = tgenome.row_schedule(pop.row(s), 7, device=CPU)
            np.testing.assert_array_equal(sched[r], ho[s],
                                          err_msg=f"{r}/{s}")


def test_genome_eval_matches_schedule_eval_bit_exact():
    """A genome evaluated directly and through its materialized schedule
    gives the identical outcome (test_fuzz.py's portability pin)."""
    t = tmake_target("otr", n=4, horizon=8, seed=0, device=CPU)
    pop = tgenome.seed_population(seed=7, P=8, n=4, horizon=8)
    pop.byz[1, 0] = True                       # byz-silence in play too
    out_g = t.evaluate(pop)
    scheds = np.stack([tgenome.row_schedule(pop.row(i), t.horizon,
                                            device=CPU)
                       for i in range(pop.size)])
    out_s = t.evaluate_schedules(scheds)
    _same_outcome(out_g, out_s, ("decided", "decision", "decided_round"))


def test_stage_and_fetch_round_trip():
    """One copy each way: every supported dtype and shape comes back
    equal, floats in raw bits; a 64-bit array is refused, not truncated."""
    rng = np.random.default_rng(9)
    arrays = {"b": rng.random((6, 4)) < 0.5,
              "i8": rng.integers(-128, 128, (6, 2, 3)).astype(np.int8),
              "u8": rng.integers(0, 256, (6,)).astype(np.uint8),
              "i32": rng.integers(-2**31, 2**31, (6, 5)).astype(np.int32),
              "f32": rng.standard_normal((6, 3)).astype(np.float32)}
    staged = tgenome.stage(arrays, CPU)
    for k, a in arrays.items():
        assert tuple(staged[k].shape) == a.shape, k
    back = tgenome.fetch(staged)
    for k, a in arrays.items():
        _same_bits(back[k], a, k)
    with pytest.raises(TypeError, match="int64"):
        tgenome.stage({"x": np.zeros((2, 2), np.int64)}, CPU)
    with pytest.raises(TypeError, match="int64"):
        tgenome.fetch({"x": torch.zeros((2, 2), dtype=torch.int64)})


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def test_lane_objectives_on_crafted_outcomes():
    decided = torch.tensor([[True, True, False], [True, True, True]])
    decision = torch.tensor([[2, 2, -1], [2, 3, 9]], dtype=torch.int32)
    dround = torch.tensor([[1, 2, -1], [0, 0, 1]], dtype=torch.int32)
    init = torch.tensor([2, 3, 1], dtype=torch.int32)
    obj = {k: v.numpy() for k, v in tobj.lane_objectives(
        decided, decision, dround, init, horizon=10).items()}
    # the bits of round_tpu's compiled program: 1 - 3·f32(1/3) = -2^-25,
    # one float32 rounding of the fused multiply-add (module docstring of
    # fuzz/objectives.py); within 1e-7 of the exact fractions
    want = jax.jit(lambda *a: jobj.lane_objectives(*a, horizon=10))(
        *[jnp.asarray(x.numpy()) for x in (decided, decision, dround, init)])
    for k in want:
        _same_bits(obj[k], np.asarray(want[k]), k)
    np.testing.assert_allclose(obj["undecided"], [1 / 3, 0.0], atol=1e-7)
    np.testing.assert_array_equal(obj["decide_round"], [10, 1])
    np.testing.assert_array_equal(obj["agreement_viol"], [0, 3])
    np.testing.assert_array_equal(obj["validity_viol"], [0, 1])
    score = tobj.combined_score(
        {k: torch.as_tensor(v) for k, v in obj.items()},
        torch.tensor([0.0, 2.0]), horizon=10).numpy()
    assert score[1] > score[0] + 50


@pytest.mark.parametrize("n,horizon", [(3, 9), (4, 12), (5, 10), (7, 12)])
def test_objectives_match_round_tpu_compiled(n, horizon):
    """lane_objectives + combined_score against round_tpu's, compiled as
    its search compiles them, raw bits, with the honest / null / extra-valid
    scopes in play."""
    rng = np.random.default_rng(n * 100 + horizon)
    P = 2048
    decided = rng.random((P, n)) < 0.6
    decision = rng.integers(-1, 5, (P, n)).astype(np.int32)
    dround = np.where(decided, rng.integers(0, horizon, (P, n)),
                      -1).astype(np.int32)
    init = (np.arange(n) % 4).astype(np.int32)
    honest = rng.random((P, n)) < 0.8
    extra = rng.random((P, n)) < 0.2
    sev = rng.random(P) * 3

    def jf(decided, decision, dround, honest, extra, sev):
        o = jobj.lane_objectives(decided, decision, dround,
                                 jnp.asarray(init), horizon, honest=honest,
                                 null_value=-1, extra_valid=extra)
        o["score"] = jobj.combined_score(o, sev, horizon)
        return o

    want = jax.jit(jf)(decided, decision, dround, honest, extra,
                       jnp.asarray(sev, jnp.float32))
    t = [torch.as_tensor(x) for x in (decided, decision, dround, honest,
                                      extra)]
    got = tobj.lane_objectives(t[0], t[1], t[2], torch.as_tensor(init),
                               horizon, honest=t[3], null_value=-1,
                               extra_valid=t[4])
    got["score"] = tobj.combined_score(
        got, torch.as_tensor(sev).to(torch.float32), horizon)
    for k in want:
        _same_bits(got[k].numpy(), np.asarray(want[k]), k)
    _same_bits(tobj.kv_stream_viol(t[0], t[1], 2).numpy(),
               np.asarray(jobj.kv_stream_viol(decided, decision, 2)))


def test_spec_formula_as_objective():
    """A spec/dsl.py formula evaluates batched over the final states: the
    Agreement formula flags exactly the violating candidate."""
    from round_tpu_torch.spec.dsl import implies
    from round_tpu_torch.utils.tree import struct

    @struct
    class St:
        decided: torch.Tensor
        decision: torch.Tensor

    def agreement(e):
        P = e.P
        return P.forall(lambda i: P.forall(lambda j: implies(
            i.decided & j.decided, i.decision == j.decision)))

    st = St(decided=torch.tensor([[True, True], [True, True], [True, False]]),
            decision=torch.tensor([[4, 4], [4, 5], [4, 5]]))
    ok = tobj.spec_holds(agreement, st, n=2).numpy()
    np.testing.assert_array_equal(ok, [True, False, True])


def test_predicates_match_round_tpu():
    rng = np.random.default_rng(2)
    out = {"decided": rng.random((16, 4)) < 0.5,
           "decision": rng.integers(0, 3, (16, 4)).astype(np.int32),
           "decide_round": rng.integers(0, 12, 16).astype(np.int32),
           "agreement_viol": rng.integers(0, 2, 16).astype(np.int32),
           "validity_viol": rng.integers(0, 2, 16).astype(np.int32)}
    for tp, jp in ((tobj.undecided_at_horizon(2), jobj.undecided_at_horizon(2)),
                   (tobj.decision_delayed(6), jobj.decision_delayed(6)),
                   (tobj.safety_violated(), jobj.safety_violated()),
                   (tobj.kv_stream_violated(1), jobj.kv_stream_violated(1))):
        _same_bits(tp(out), jp(out), tp.__name__)
        assert tp.__name__ == jp.__name__


# ---------------------------------------------------------------------------
# the batched evaluator against round_tpu
# ---------------------------------------------------------------------------

def _value_pop(proto_seed, P, n, horizon, liars: bool):
    jpop = jgenome.seed_population(proto_seed, P, n, horizon)
    if liars:
        rng = np.random.default_rng(proto_seed)
        jpop.byz_value[:] = rng.random(jpop.byz_value.shape) < 0.3
        jpop.equiv_p8[:] = rng.integers(0, 233, P)
        jpop.stale_p8[:] = rng.integers(0, 233, P)
        jpop.byz[:] = rng.random(jpop.byz.shape) < 0.15
    return jpop


@pytest.mark.parametrize("proto,liars", [("otr", False), ("lastvoting", False),
                                         ("pbft", True), ("pbft-vc", True)])
def test_evaluate_matches_round_tpu(proto, liars):
    """FuzzTarget.evaluate on round_tpu's seed population (value fields set
    for the PBFT family): every integer and bool field, the coverage bits
    and the float32 score in raw bits."""
    n, horizon, P = 4, 12, 64
    jt = jmake_target(proto, n, horizon, seed=0)
    t = tmake_target(proto, n, horizon, seed=0, device=CPU)
    jpop = _value_pop(len(proto), P, n, t.horizon, liars)
    want = jt.evaluate(jpop)
    got = t.evaluate(_port_pop(jpop))
    _same_outcome(got, want, OUT_KEYS + ("coverage", "score", "severity"))
    if liars:  # active liars were in the population
        assert (jpop.byz_value.any(axis=1) & (jpop.equiv_p8 > 0)).sum() > 8


def test_evaluate_schedules_match_round_tpu():
    """evaluate_schedules with and without plans, K = 5 (padded to 8), on
    schedules and plans round_tpu materializes from liar-bearing genomes."""
    n, horizon = 4, 12
    jt = jmake_target("otr", n, horizon, seed=2)
    t = tmake_target("otr", n, horizon, seed=2, device=CPU)
    jpop = _value_pop(5, 5, n, horizon, liars=True)
    scheds = np.stack([jgenome.row_schedule(jpop.row(i), horizon)
                       for i in range(5)])
    plans = np.stack([jgenome.row_value_plan(jpop.row(i), horizon,
                                             jt.value_domain)
                      for i in range(5)])
    plans[0, 3, 1, 0] = VP_STALE
    assert (plans >= 0).any()
    _same_outcome(t.evaluate_schedules(scheds), jt.evaluate_schedules(scheds),
                  OUT_KEYS)
    _same_outcome(t.evaluate_schedules(scheds, plans),
                  jt.evaluate_schedules(scheds, plans), OUT_KEYS)


def test_benor_genome_vs_schedule_and_decided_fraction():
    """Ben-Or draws coins from the update key (a hash in the port, threefry
    splits in round_tpu): its genome evaluation equals its own schedule
    evaluation bit for bit, and its decided fraction stays near round_tpu's
    on the same population (within 0.15 over 64 x 4 lanes)."""
    n, horizon, P = 4, 12, 64
    t = tmake_target("benor", n, horizon, seed=0, device=CPU)
    jt = jmake_target("benor", n, horizon, seed=0)
    jpop = jgenome.seed_population(4, P, n, t.horizon)
    pop = _port_pop(jpop)
    got = t.evaluate(pop)
    scheds = np.stack([tgenome.row_schedule(pop.row(i), t.horizon,
                                            device=CPU) for i in range(P)])
    _same_outcome(got, t.evaluate_schedules(scheds),
                  ("decided", "decision", "decided_round"))
    want = jt.evaluate(jpop)
    assert abs(got["decided"].mean() - want["decided"].mean()) <= 0.15


# ---------------------------------------------------------------------------
# one batched program per generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [8, 64])
def test_one_batched_program_per_evaluation(monkeypatch, P):
    """run_round runs `horizon` times per evaluation (the population is a
    vmapped axis, never a Python loop), and search makes one evaluation
    per generation."""
    steps = []
    inner = texec.run_round

    def counting(*a, **kw):
        steps.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(texec, "run_round", counting)
    t = tmake_target("lastvoting", n=4, horizon=12, seed=0, device=CPU)
    pop = tgenome.seed_population(seed=1, P=P, n=4, horizon=12)
    t.evaluate(pop)
    assert len(steps) == t.horizon
    steps.clear()
    t.evaluate_schedules(np.stack([tgenome.row_schedule(
        pop.row(0), t.horizon, device=CPU)] * 3))
    assert len(steps) == t.horizon
    steps.clear()
    d0 = METRICS.counter("fuzz.dispatches").value
    g0 = METRICS.counter("fuzz.generations").value
    res = tsearch(t, pop_size=P, generations=3, seed=2)
    assert res.generations == 3
    assert METRICS.counter("fuzz.dispatches").value - d0 == 3
    assert METRICS.counter("fuzz.generations").value - g0 == 3
    assert len(steps) == 3 * t.horizon


# ---------------------------------------------------------------------------
# search and minimize: whole trajectories against round_tpu
# ---------------------------------------------------------------------------

def test_search_trajectory_matches_round_tpu(monkeypatch):
    """A whole search (otr, n=4, horizon 8, pop 64, 3 generations) on
    round_tpu's seed population: history, best row, best outcome and
    coverage map equal round_tpu's."""
    monkeypatch.setattr(tgenome, "seed_population", lambda *a, **kw: _port_pop(
        jgenome.seed_population(*a, **kw)))
    jt = jmake_target("otr", n=4, horizon=8, seed=0)
    t = tmake_target("otr", n=4, horizon=8, seed=0, device=CPU)
    want = jsearch(jt, pop_size=64, generations=3, seed=11)
    got = tsearch(t, pop_size=64, generations=3, seed=11)
    assert got.history == want.history
    assert got.best_outcome == want.best_outcome
    np.testing.assert_array_equal(got.coverage_map, want.coverage_map)
    for f in tgenome._FIELDS:
        _same_bits(got.best_row[f], want.best_row[f], f)
        _same_bits(getattr(got.population, f), getattr(want.population, f), f)
    _same_outcome(got.outcome, want.outcome, OUT_KEYS + ("score",))


def test_fuzz_smoke_search_runs_and_minimizes():
    """test_fuzz.py's tier-1 smoke on the port: one evaluation per
    generation, finite scores, coverage; the known-bad genome minimizes
    to the same result as round_tpu's."""
    t = tmake_target("otr", n=4, horizon=8, seed=0, device=CPU)
    d0 = METRICS.counter("fuzz.dispatches").value
    c0 = METRICS.counter("fuzz.candidates").value
    res = tsearch(t, pop_size=64, generations=2, seed=11)
    assert res.generations == 2 and res.evaluated == 128
    assert METRICS.counter("fuzz.dispatches").value - d0 == 2
    assert METRICS.counter("fuzz.candidates").value - c0 == 128
    assert np.isfinite(res.best_score)
    assert 0 < int(res.coverage_map.sum()) <= t.n_cells
    assert len(res.history) == 2

    pred = tobj.undecided_at_horizon(min_lanes=4)
    mr = tmin.minimize(t, BAD, pred)
    assert mr.dropped_final < mr.dropped_initial
    assert (~mr.outcome["decided"]).all()
    assert tgenome.severity(
        tgenome.Population.from_rows([mr.genome_row]), 8)[0] <= \
        tgenome.severity(tgenome.Population.from_rows([BAD]), 8)[0]
    want = jmin.minimize(jmake_target("otr", n=4, horizon=8, seed=0), BAD,
                         jobj.undecided_at_horizon(min_lanes=4))
    assert (mr.dropped_initial, mr.dropped_final, mr.iterations) == (
        want.dropped_initial, want.dropped_final, want.iterations)
    np.testing.assert_array_equal(mr.schedule, want.schedule)
    for f in want.genome_row:
        _same_bits(mr.genome_row[f], want.genome_row[f], f)
    assert mr.value_plan is None and want.value_plan is None


def test_minimize_rejects_non_finding():
    t = tmake_target("otr", n=4, horizon=8, seed=0, device=CPU)
    clean = dict(BAD, side=np.zeros(4, np.int32), heal_round=np.int32(0),
                 p8=np.int32(0), salt0=np.int32(1), salt1=np.int32(2))
    with pytest.raises(ValueError, match="does not reproduce"):
        tmin.minimize(t, clean, tobj.undecided_at_horizon(4))


def test_minimize_value_plan_shrinks_lies():
    """The value-event ddmin on a one-liar LastVoting genome that breaks
    agreement: the minimal (schedule, plan) pair is 1-minimal over both
    event kinds under the port, holds one lie where the genome drew 11,
    and gives the same outcome through round_tpu's schedule evaluator."""
    t = tmake_target("lastvoting", 4, 8, seed=1, device=CPU)
    row = dict(BAD, side=np.zeros(4, np.int32), heal_round=np.int32(0),
               p8=np.int32(0), byz_value=np.array([True, False, False,
                                                   False]),
               equiv_p8=np.int32(230), stale_p8=np.int32(0))
    pred = tobj.safety_violated()
    assert bool(pred(t.evaluate(tgenome.Population.from_rows([row])))[0])
    mr = tmin.minimize(t, row, pred)
    assert (mr.value_initial, mr.value_final) == (11, 1)
    assert (mr.value_plan != VP_NONE).sum() == mr.value_final
    assert tmin.verify_one_minimal(t, mr.schedule, pred,
                                   value_plan=mr.value_plan)
    want = jmake_target("lastvoting", 4, 8, seed=1).evaluate_schedules(
        mr.schedule[None], mr.value_plan[None])
    _same_outcome({k: v[None] for k, v in mr.outcome.items()}, want,
                  OUT_KEYS)


def test_fuzz_end_to_end_finds_and_minimizes():
    """The sim half of test_fuzz.py's end-to-end demo on the port's own
    seed population: the fuzzer finds a schedule that leaves every OTR
    process undecided at the horizon, and minimizes it to a 1-minimal link
    set (the artifact export is round_tpu's fuzz/replay.py, not ported)."""
    t = tmake_target("otr", n=4, horizon=10, seed=0, device=CPU)
    pred = tobj.undecided_at_horizon(min_lanes=4)
    res = tsearch(t, pop_size=256, generations=12, seed=3, stop_when=pred)
    assert bool(np.any(pred(res.outcome)))
    assert res.best_outcome["undecided"] == 1.0
    mr = tmin.minimize(t, res.best_row, pred)
    assert mr.dropped_final < mr.dropped_initial
    assert tmin.verify_one_minimal(t, mr.schedule, pred)
