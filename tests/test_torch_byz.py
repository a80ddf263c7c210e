"""Port parity of the value adversaries (round_tpu_torch/byz), the general
engine's adversary hook and the byzantine payload transform.

Mirrors the non-host tests of tests/test_byz.py and holds the port against
round_tpu bit for bit (tolerance 0: every output is an integer or a bool):
the three lie models at every round class on random payloads, the link
hash, the lie palette, the value events and the explicit plan at n = 4, 5
and 7 over 12 rounds with negative salts, and ``run_phases`` under a
hash-mode and an explicit-plan adversary for OTR, LastVoting, PBFT and
PBFT with view change (every state leaf, ``done`` and ``decided_round``).
Inputs are made with numpy from a seed; round_tpu runs on the CPU.
``corrupt_payloads`` / ``AdversarialRound`` are held by properties: their
byzantine set is the port's ``byzantine_silence`` set, by design not
round_tpu's threefry draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.byz import adversary as jadv
from round_tpu.byz import lies as jlies
from round_tpu.engine import executor as jexec
from round_tpu.engine import scenarios as jscen
from round_tpu.fuzz import genome as jgenome
from round_tpu.fuzz.search import make_target as jmake_target
from round_tpu.fuzz.search import search as jsearch
from round_tpu.models.pbft import digest as jdigest
from round_tpu_torch.apps.selector import select as tselect
from round_tpu_torch.byz import adversary as tadv
from round_tpu_torch.byz import lies as tlies
from round_tpu_torch.byz.adversary import VP_NONE, VP_STALE
from round_tpu_torch.engine import executor as texec
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.fuzz import genome as tgenome
from round_tpu_torch.fuzz import minimize as tmin
from round_tpu_torch.fuzz.objectives import safety_violated
from round_tpu_torch.fuzz.search import make_target as tmake_target
from round_tpu_torch.fuzz.search import search as tsearch
from round_tpu_torch.models.pbft import digest as tdigest
from round_tpu_torch.utils.tree import tree_leaves

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
LOOP_VALUES = np.array([1, 3, 0, 2], dtype=np.int32)


def _port_pop(jpop) -> tgenome.Population:
    return tgenome.Population(**{f: np.array(getattr(jpop, f))
                                 for f in jgenome._FIELDS})


def _same_bits(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def _salts(rng, shape=()):
    """uint32 salts as int32 bit patterns, half of them negative."""
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(
        np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# lie models
# ---------------------------------------------------------------------------

def _payloads(proto, k, rng, B, n):
    """B random payloads of round class k of `proto` (numpy leaves with the
    protocol's own dtypes and per-lane shapes)."""
    i32 = lambda *s: rng.integers(-2**31, 2**31, (B,) + s,  # noqa: E731
                                  dtype=np.int64).astype(np.int32)
    b = lambda *s: rng.random((B,) + s) < 0.5  # noqa: E731
    if proto == "generic":
        return {"x": i32(), "ok": b(), "ts": i32(n),
                "byte": rng.integers(0, 256, (B, 3)).astype(np.uint8),
                "small": rng.integers(-128, 128, (B,)).astype(np.int8)}
    if proto == "pbft":
        return ({"req": i32(), "dig": i32()}, {"dig": i32(), "ok": b()},
                i32())[k]
    return ({"req": i32(), "dig": i32(), "view": i32()},
            {"dig": i32(), "ok": b(), "view": i32()},
            {"dig": i32(), "view": i32()},
            {"nv": i32(), "pr": i32(), "pv": i32()},
            {"nv": i32(), "ackd": i32(n)},
            {"nv": i32(), "sel": i32()})[k]


@pytest.mark.parametrize("proto,k", [("generic", 0)]
                         + [("pbft", k) for k in range(3)]
                         + [("pbft-vc", k) for k in range(6)])
def test_lie_models_match_round_tpu(proto, k):
    """Each lie model, batched over 64 random payloads and claimed values
    (negative and past int32 range included), gives round_tpu's forgery
    leaf for leaf, in dtype, shape and bits."""
    rng = np.random.default_rng(k + 17 * len(proto))
    B, n = 64, 5
    payload = _payloads(proto, k, rng, B, n)
    v = rng.integers(-2**33, 2**33, (B,), dtype=np.int64)
    v[:8] = [0, 1, 2, 3, -1, -2, 2**31, 255]
    jl = jlies.generic_lie if proto == "generic" else jlies.lie_for(proto)
    tl = tlies.generic_lie if proto == "generic" else tlies.lie_for(proto)
    want = jax.vmap(lambda p, vv: jl(k, p, vv))(
        jax.tree_util.tree_map(jnp.asarray, payload),
        jnp.asarray(v.astype(np.int32)))
    got = torch.func.vmap(lambda p, vv: tl(k, p, vv))(
        jax.tree_util.tree_map(torch.as_tensor, payload),
        torch.as_tensor(v.astype(np.int32)))
    # dict leaves in sorted-key order on both sides
    wl, gl = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        _same_bits(g.numpy(), np.asarray(w), (proto, k))


def test_forge_payload_matches_engine_lie():
    """forge_payload (host: numpy in, numpy out) gives exactly the values
    the torch lie model computes, dtype- and shape-preserving, and equal
    to round_tpu's forge_payload (test_byz.py's pin, twinned)."""
    cases = [
        ("otr", 0, np.int32(7)),
        ("lastvoting", 1, {"x": np.int32(3), "ts": np.int32(1)}),
        ("pbft", 0, {"req": np.int32(5),
                     "dig": np.asarray(tdigest(torch.tensor(5))).astype(
                         np.int32)}),
        ("pbft", 1, {"dig": np.int32(11), "ok": np.bool_(False)}),
        ("pbft", 2, np.int32(9)),
        ("pbft-vc", 3, {"nv": np.int32(1), "pr": np.int32(2),
                        "pv": np.int32(0)}),
    ]
    for proto, k, payload in cases:
        v = 2
        host = tlies.forge_payload(proto, k, payload, v)
        eng = tlies.lie_for(proto)(k, jax.tree_util.tree_map(
            torch.as_tensor, payload), v)
        ref = jlies.forge_payload(proto, k, payload, v)
        for pl, hl, el, rl in zip(jax.tree_util.tree_leaves(payload),
                                  jax.tree_util.tree_leaves(host),
                                  jax.tree_util.tree_leaves(eng),
                                  jax.tree_util.tree_leaves(ref)):
            hl = np.asarray(hl)
            assert hl.dtype == np.asarray(pl).dtype, (proto, k)
            assert hl.shape == np.shape(pl), (proto, k)
            assert np.array_equal(hl, el.numpy()), (proto, k)
            _same_bits(hl, np.asarray(rl), (proto, k))


def test_pbft_lie_is_digest_consistent():
    """The forged pre-prepare ships the digest of the lie, in the digest's
    own representation: the receiver's recheck passes."""
    forged = tlies.forge_payload(
        "pbft", 0, {"req": np.int32(5),
                    "dig": tdigest(torch.tensor(5)).numpy()}, 3)
    assert int(forged["req"]) == 3
    assert int(forged["dig"]) == int(tdigest(torch.tensor(3)))
    assert int(forged["dig"]) == int(np.asarray(jdigest(jnp.int32(3))))


# ---------------------------------------------------------------------------
# hash draws: link hash, lie palette, value events, value plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 5, 7])
def test_value_draws_match_round_tpu(n):
    rng = np.random.default_rng(n)
    P, T, V = 16, 12, 5
    s0, s1 = _salts(rng, (P,)), _salts(rng, (P,))
    assert (s0 < 0).any() and (s1 < 0).any()
    byz = rng.random((P, n)) < 0.5
    eq = rng.integers(0, 257, P).astype(np.int32)
    st = rng.integers(0, 257, P).astype(np.int32)
    for stream in (jadv.STREAM_BYZ_VAL, jadv.STREAM_BYZ_STALE,
                   jadv.STREAM_BYZ_FACE):
        for r in (0, 5, 11):
            got = tadv._link_u32(torch.as_tensor(s0), torch.as_tensor(s1),
                                 r, n, stream)
            want = jax.vmap(lambda a, b: jadv._link_u32(a, b, r, n, stream))(
                jnp.asarray(s0), jnp.asarray(s1))
            _same_bits(got.numpy().astype(np.uint32), np.asarray(want))
    got_a, got_b = tadv.lie_pair(torch.as_tensor(s0), torch.as_tensor(s1), V)
    want_a, want_b = jadv.lie_pair(jnp.asarray(s0), jnp.asarray(s1), V)
    _same_bits(got_a.numpy(), np.asarray(want_a))
    _same_bits(got_b.numpy(), np.asarray(want_b))
    t = [torch.as_tensor(x) for x in (byz, eq, st, s0, s1)]
    for r in range(T):
        sub_v, stale = tadv.value_events(*t, r, n, V)
        want_v, want_s = jax.vmap(
            lambda *a: jadv.value_events(*a, r, n, V))(
            *[jnp.asarray(x) for x in (byz, eq, st, s0, s1)])
        _same_bits(sub_v.numpy(), np.asarray(want_v), ("sub_v", r))
        _same_bits(stale.numpy(), np.asarray(want_s), ("stale", r))
    for p in range(4):
        row = {"byz_value": byz[p], "equiv_p8": eq[p], "stale_p8": st[p],
               "salt0": s0[p], "salt1": s1[p]}
        _same_bits(tadv.value_plan(row, T, V, device=CPU),
                   jadv.value_plan(row, T, V), ("plan", p))


def test_value_plan_diagonal_and_pr8_rows():
    """The plan never lies on the diagonal, and a row dict without value
    fields stays valid currency (zero-filled: the truthful adversary)."""
    t = tmake_target("otr", 4, 12, seed=9, values=LOOP_VALUES, device=CPU)
    pop = _port_pop(jgenome.seed_population(3, 1, 4, t.horizon))
    row = {f: np.asarray(getattr(pop, f)[0]) for f in tgenome._FIELDS}
    row["byz_value"] = np.ones(4, dtype=bool)
    row["equiv_p8"] = np.int32(232)
    row["stale_p8"] = np.int32(232)
    vplan = tgenome.row_value_plan(row, t.horizon, t.value_domain,
                                   device=CPU)
    eye = np.eye(4, dtype=bool)
    assert (vplan[:, eye] == VP_NONE).all()
    assert (vplan == VP_STALE).any() and (vplan >= 0).any()

    legacy = {f: row[f] for f in tgenome._FIELDS
              if f not in tgenome._VALUE_FIELDS}
    assert not (tgenome.row_value_plan(legacy, t.horizon, t.value_domain,
                                       device=CPU) != VP_NONE).any()
    assert not tgenome.Population.from_rows([legacy]).byz_value.any()


def test_value_plan_bit_identical_hash_vs_schedule():
    """One liar-bearing genome row through the batched population path and
    through (row_schedule, row_value_plan) + evaluate_schedules gives the
    identical outcome, and both equal round_tpu's (PBFT, n = 3)."""
    t = tmake_target("pbft", 3, 9, seed=1, device=CPU)
    jt = jmake_target("pbft", 3, 9, seed=1)
    jpop = jgenome.seed_population(0, 2, 3, t.horizon)
    row = {f: np.asarray(getattr(jpop, f)[0]) for f in jgenome._FIELDS}
    row["byz_value"] = np.array([True, False, False])
    row["equiv_p8"] = np.int32(200)
    row["stale_p8"] = np.int32(40)

    o1 = t.evaluate(tgenome.Population.from_rows([row]))
    sched = tgenome.row_schedule(row, t.horizon, device=CPU)
    vplan = tgenome.row_value_plan(row, t.horizon, t.value_domain, device=CPU)
    assert (vplan != VP_NONE).any(), "row drew no value events at all"
    o2 = t.evaluate_schedules(sched[None], vplan[None])
    want = jt.evaluate(jgenome.Population.from_rows([row]))
    for k in ("decided", "decision", "decided_round"):
        assert np.array_equal(o1[k][0], o2[k][0]), k
        _same_bits(o1[k], want[k], k)


# ---------------------------------------------------------------------------
# run_phases under an adversary
# ---------------------------------------------------------------------------

ADV_PROTOS = ("otr", "lastvoting", "pbft", "pbft-vc")


@pytest.mark.parametrize("kind", ["hash", "plan"])
@pytest.mark.parametrize("proto", ADV_PROTOS)
def test_run_phases_adversary_matches_round_tpu(proto, kind):
    """One instance through both general engines at n = 4 over a random
    12-round schedule, under a hash-mode or an explicit-plan adversary
    (equivocation and stale replay both in play): every state leaf,
    ``done`` and ``decided_round`` bit for bit."""
    from round_tpu.apps.selector import select as jselect

    n, horizon = 4, 12
    rng = np.random.default_rng(len(proto) * 7 + (kind == "plan"))
    jalgo, talgo = jselect(proto), tselect(proto)
    k = jalgo.rounds_per_phase
    phases = -(-horizon // k)
    T = phases * k
    sched = rng.random((T, n, n)) < 0.85
    sched |= np.eye(n, dtype=bool)[None]
    values = rng.integers(0, 4, n).astype(np.int32)
    V = 6
    lie_j, lie_t = jlies.lie_for(proto), tlies.lie_for(proto)
    if kind == "hash":
        leaves = (np.array([False, True, False, True]), np.int32(150),
                  np.int32(90), _salts(rng), _salts(rng))
        jadv_ = jadv.hash_adversary(n, k, *[jnp.asarray(x) for x in leaves],
                                    V, lie=lie_j)
        tadv_ = tadv.hash_adversary(
            n, k, *[torch.as_tensor(np.asarray(x)) for x in leaves], V,
            lie=lie_t)
    else:
        plan = np.full((T, n, n), VP_NONE, dtype=np.int32)
        pick = rng.random((T, n, n)) < 0.25
        plan[pick] = rng.integers(-2, V, pick.sum())
        plan[:, np.eye(n, dtype=bool)] = VP_NONE
        plan[1, 0, 1], plan[2, 2, 3] = VP_STALE, 1  # both kinds in play
        jadv_ = jadv.plan_adversary(n, k, plan, lie=lie_j)
        tadv_ = tadv.plan_adversary(n, k, plan, lie=lie_t, device=CPU)

    jtopo = jexec.LocalTopology(n)
    jstate0 = jexec.init_lanes(jalgo, {"initial_value": jnp.asarray(values)},
                               n, jtopo)
    want = jexec.run_phases(jalgo, jstate0, jax.random.PRNGKey(3),
                            jscen.from_schedule(jnp.asarray(sched)), phases,
                            jtopo, adversary=jadv_)
    ttopo = texec.LocalTopology(n, CPU)
    tstate0 = texec.init_lanes(talgo, {"initial_value": values}, n, ttopo)
    got = texec.run_phases(talgo, tstate0, (0, 3),
                           tscen.from_schedule(torch.as_tensor(sched)),
                           phases, ttopo, adversary=tadv_)
    gl = tree_leaves(got[0]) + [got[1], got[2]]
    wl = jax.tree_util.tree_leaves(want[0]) + [want[1], want[2]]
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        _same_bits(g.numpy(), np.asarray(w), (proto, kind, i))
    # the data put lies on the wire: some round drew a substitution
    events = [tadv_.events_fn(r) for r in range(T)]
    assert any(bool((sv >= 0).any()) for sv, _ in events)


def test_run_round_without_adversary_is_unchanged():
    """adversary=None keeps run_round's two-tuple; an adversary with no
    events gives the same state as none at all."""
    n = 4
    algo = tselect("otr")
    topo = texec.LocalTopology(n, CPU)
    st = texec.init_lanes(algo, {"initial_value": np.arange(n) % 3}, n, topo)
    done = torch.zeros(n, dtype=torch.bool)
    ho = torch.ones((n, n), dtype=torch.bool)
    out = texec.run_round(algo.rounds[0], st, done, 0, ho, (0, 1), topo)
    assert len(out) == 2
    adv = tadv.plan_adversary(n, 1, np.full((1, n, n), VP_NONE, np.int32),
                              device=CPU)
    prev = texec.adversary_prev0(algo, st, topo, adv)[0]
    out2 = texec.run_round(algo.rounds[0], st, done, 0, ho, (0, 1), topo,
                           adversary=adv, adv_class=0, adv_prev=prev)
    assert len(out2) == 3
    for a, b in zip(tree_leaves(out[0]) + [out[1]],
                    tree_leaves(out2[0]) + [out2[1]]):
        assert torch.equal(a, b)
    assert out2[2][0].all()  # every lane sent: the stale carry is valid


# ---------------------------------------------------------------------------
# genome envelope caps and severity
# ---------------------------------------------------------------------------

def test_mutate_value_cap_bounds_membership():
    """The caps of test_byz.py, and each mutate equal to round_tpu's under
    the same np.random.Generator."""
    jpop = jgenome.seed_population(1, 64, 7, 12)
    rng0 = np.random.default_rng(0)
    jpop.byz_value[:] = rng0.random(jpop.byz_value.shape) < 0.5
    jpop.equiv_p8[:] = 100
    pop = _port_pop(jpop)
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for cap in (2, 0, None):
        out = tgenome.mutate(rng, pop, 12, value_cap=cap)
        want = jgenome.mutate(jrng, jpop, 12, value_cap=cap)
        for f in tgenome._FIELDS:
            _same_bits(getattr(out, f), getattr(want, f), (cap, f))
        if cap == 0:
            assert not out.byz_value.any()
            assert (out.equiv_p8 == 0).all() and (out.stale_p8 == 0).all()
        else:
            assert (out.byz_value.sum(axis=1) <= 2).all()
    assert tgenome.value_cap_default(7) == 2


def test_severity_prices_value_adversary():
    pop = _port_pop(jgenome.seed_population(0, 2, 4, 12))
    for f in tgenome._FIELDS:
        getattr(pop, f)[:] = 0
    pop.byz_value[1, 0] = True
    pop.equiv_p8[1] = 128
    sev = tgenome.severity(pop, 12)
    assert sev[1] > sev[0]


# ---------------------------------------------------------------------------
# the equivocation smoke and the banked fixture
# ---------------------------------------------------------------------------

def test_equivocation_search_smoke(monkeypatch):
    """A past-envelope OTR sweep (one liar, liar-seeded) finds a safety
    violation within a few generations, the same trajectory as
    round_tpu's on round_tpu's seed population."""
    from round_tpu.byz.crosscheck import liar_rows
    from round_tpu.fuzz.objectives import safety_violated as jsafety

    monkeypatch.setattr(tgenome, "seed_population", lambda *a, **kw: _port_pop(
        jgenome.seed_population(*a, **kw)))
    jt = jmake_target("otr", 4, 12, seed=9, values=LOOP_VALUES)
    t = tmake_target("otr", 4, 12, seed=9, values=LOOP_VALUES, device=CPU)
    rows = liar_rows(4, t.horizon, 1, seed=4)
    kw = dict(pop_size=256, generations=15, seed=4, value_cap=1,
              seed_rows=rows)
    res = tsearch(t, stop_when=safety_violated(), **kw)
    want = jsearch(jt, stop_when=jsafety(), **kw)
    viol = (res.best_outcome["agreement_viol"]
            + res.best_outcome["validity_viol"])
    assert viol > 0, res.best_outcome
    assert res.best_row["byz_value"].any()
    assert res.history == want.history
    assert res.best_outcome == want.best_outcome
    for f in tgenome._FIELDS:
        _same_bits(res.best_row[f], want.best_row[f], f)


def test_banked_fixture_replays_and_is_one_minimal():
    """The banked equivocation counterexample (loaded through round_tpu's
    replay module, here only) gives round_tpu's recorded outcome through
    the port's evaluate_schedules(value_plans=...), and is 1-minimal over
    both event kinds under the port."""
    import os

    from round_tpu.byz.crosscheck import early_victim_split
    from round_tpu.fuzz import replay

    art = replay.load_artifact(os.path.join(
        os.path.dirname(__file__), "regressions",
        "otr_equivocation_victim.json"))
    t = tmake_target("otr", 4, 12, seed=9, values=LOOP_VALUES, device=CPU)
    sched = replay.schedule_from_artifact(art)
    vplan = replay.value_plan_from_artifact(art)
    assert vplan is not None and (vplan >= 0).sum() >= 1
    out = t.evaluate_schedules(sched[None], vplan[None])
    exp = art["expected"]["engine"]
    for k in ("decided", "decision", "decided_round"):
        assert out[k][0].tolist() == exp[k], k
    pred = early_victim_split()
    assert bool(pred(out)[0])
    assert tmin.verify_one_minimal(t, sched, pred, value_plan=vplan)
    truthful = np.full_like(vplan, VP_NONE)
    assert not bool(pred(t.evaluate_schedules(sched[None],
                                              truthful[None]))[0])


# ---------------------------------------------------------------------------
# utils/byzantine.py: corrupt_payloads / AdversarialRound
# ---------------------------------------------------------------------------

def test_corrupt_payloads_set_is_byzantine_silence_set():
    """The corrupted lanes are exactly the set byzantine_silence silences
    for the same key (its senders never heard by some receiver), the other
    lanes' payload leaves are untouched, and the garbage varies with the
    round."""
    from round_tpu_torch.utils.byzantine import corrupt_payloads, round_key

    n, f = 7, 2
    garbage = lambda rk, leaf: torch.full_like(  # noqa: E731
        leaf, int(rk[0] % 1000) + 1000)
    tf = corrupt_payloads(garbage, f)
    for key in ((0, 1), (5, 9), (123, 4567)):
        silence = tscen.byzantine_silence(n, f, device=CPU)
        muted = torch.zeros(n, dtype=torch.bool)
        for r in range(40):
            muted |= ~silence(key, r).all(dim=0)
        payload = {"x": torch.arange(n, dtype=torch.int32),
                   "v": torch.arange(2 * n, dtype=torch.int32).reshape(n, 2)}
        outs = []
        for r in (0, 1):
            out = tf(key, round_key(key, torch.tensor(r)), payload, n)
            bad = out["x"] != payload["x"]
            assert torch.equal(bad, muted), key
            assert bad.sum() == f
            assert torch.equal(out["v"][~bad], payload["v"][~bad])
            outs.append(out["x"][bad])
        assert not torch.equal(outs[0], outs[1])


def test_adversarial_round_runs_in_the_engine():
    """AdversarialRound over OTR in the general engine: the byzantine
    lanes' broadcasts are replaced for every receiver, so with f = 1 out
    of n = 4 the honest lanes still agree, on a value some lane
    proposed."""
    from round_tpu_torch.models.otr import OTR
    from round_tpu_torch.utils.byzantine import (
        AdversarialRound, corrupt_payloads,
    )

    n, key = 4, (3, 11)
    algo = OTR()
    tf = corrupt_payloads(lambda rk, leaf: torch.full_like(leaf, 3), 1)
    algo.rounds = (AdversarialRound(algo.rounds[0], tf, key),)
    init = np.array([0, 1, 1, 2], np.int32)
    res = texec.run_instance(algo, {"initial_value": init}, n, key,
                             tscen.full(n, device=CPU), 4, device=CPU)
    byz = tscen._hash_crash_set(key, n, 1, CPU, stream=tscen._BYZ_STREAM)
    honest = ~byz
    dec = res.state.decision[honest & res.state.decided]
    assert dec.numel() >= 2 and (dec == dec[0]).all()
