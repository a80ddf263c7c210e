"""Runtime verification in the port (round_tpu_torch/rv) against round_tpu.

The monitor program, the fused lane term and the host runner's numpy
twin are held against round_tpu's on the same seeded numpy inputs at
tolerance 0; the policies run on the broken fixtures in both of the
port's drivers; ``LeaseClock`` and the license registry (with an
injected prover) give round_tpu's verdicts.  Everything here runs on the
CPU.
"""

from __future__ import annotations

import functools
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

import round_tpu.apps.selector as r_sel
import round_tpu.rv.compile as r_compile
import round_tpu.rv.license as r_license
from round_tpu.core.rounds import RoundCtx as RCtx
from round_tpu.engine import executor as r_exec
from round_tpu.fuzz import replay as r_replay
from round_tpu_torch.apps.selector import select
from round_tpu_torch.engine.executor import LaneStep, lane_step
from round_tpu_torch.engine.scenarios import host_key_salts
from round_tpu_torch.fuzz import replay
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime import host
from round_tpu_torch.runtime.chaos import alloc_ports
from round_tpu_torch.runtime.host import run_instance_loop
from round_tpu_torch.runtime.lanes import run_instance_loop_lanes
from round_tpu_torch.runtime.transport import HostTransport
from round_tpu_torch.rv import compile as p_compile
from round_tpu_torch.rv import license as p_license
from round_tpu_torch.rv.dump import RvConfig, RvViolation
from round_tpu_torch.utils.tree import tree_flatten, tree_map, tree_stack

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

N, L, SID = 4, 16, 1


@functools.lru_cache(maxsize=None)
def _algo(name: str):
    """One Algorithm per name: lane steps cache on its Round objects."""
    return select(name)


# -- the compiled program ----------------------------------------------------


@pytest.mark.parametrize("name", ["otr", "lv", "lvb", "benor", "kset",
                                  "pbft", "rv-broken-agreement",
                                  "snap-broken-conservation"])
def test_monitor_program_equals_round_tpus(name):
    """Same labels, slots, offline split, shapes and dtypes (or None
    where round_tpu compiles nothing)."""
    got = p_compile.monitor_program(select(name), N)
    want = r_compile.monitor_program(r_sel.select(name), N)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got.labels == want.labels and got.slots == want.slots
    assert [f.label for f in got.offline] == [f.label for f in want.offline]
    assert got.decision_shape == want.decision_shape
    assert got.decision_dtype == np.dtype(want.decision_dtype)
    assert got.init_shape == want.init_shape
    assert got.init_dtype == np.dtype(want.init_dtype)
    assert got.validity_comparable == want.validity_comparable
    for a, b in zip(got.zeros(L), want.zeros(L)):
        assert a.shape == b.shape and a.dtype == b.dtype


def _monitor_inputs(prog, rng):
    """Seeded carried monitor state: decided flags, decisions and
    witness rows drawn from the schedule's small domain, so every slot
    both holds and trips somewhere."""
    prev_dec = rng.random(L) < 0.5
    prev_val = rng.integers(-1, 5, (L,) + prog.decision_shape).astype(
        prog.decision_dtype)
    ext_dec = rng.random(L) < 0.5
    ext_val = rng.integers(-1, 5, (L,) + prog.decision_shape).astype(
        prog.decision_dtype)
    init = rng.integers(0, 5, (L, N) + prog.init_shape).astype(
        prog.init_dtype)
    return prev_dec, prev_val, ext_dec, ext_val, init


@pytest.mark.parametrize("name", ["otr", "lastvoting", "rv-broken-agreement",
                                  "rv-broken-validity", "rv-broken-revoke"])
def test_monitored_lane_step_equals_round_tpus(name):
    """The monitored update on the same [L, ...] state, rounds, mailbox,
    active mask and carried monitor state: round_tpu's jitted
    LaneStep(monitor=) and the port's give the same state, exit flags,
    verdicts and advanced (prev decided, prev decision) — the port's
    plane merged for the active lanes as its lane driver merges it — bit
    for bit; the port's monitored state and exits equal its plain
    update's (monitors observe only)."""
    algo, ralgo = _algo(name), r_sel.select(name)
    prog = p_compile.monitor_program(algo, N)
    rprog = r_compile.monitor_program(ralgo, N)
    rng = np.random.default_rng(11)
    values = rng.integers(0, 5, L)
    st = tree_stack([host.lane_init_state(
        algo, SID, N, host.instance_io(algo, int(v)), "cpu")
        for v in values])
    rst = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[
        ralgo.make_init_state(RCtx(id=np.int32(SID), n=N, r=np.int32(0)),
                              {"initial_value": np.int32(v)})
        for v in values])
    salts = torch.tensor([host_key_salts(7 + i)[1] for i in range(L)],
                         dtype=torch.int64)
    useeds = np.arange(L, dtype=np.uint32)
    active = rng.random(L) < 0.75
    mon = _monitor_inputs(prog, rng)
    for rnd_i, (rnd, rrnd) in enumerate(zip(algo.rounds, ralgo.rounds)):
        rr = (rng.integers(0, 4, L) * len(algo.rounds) + rnd_i).astype(
            np.int32)
        pstep = LaneStep(rnd, N, L, monitor=prog)
        plain = LaneStep(rnd, N, L)
        rstep = r_exec.LaneStep(rrnd, N, L, monitor=rprog)
        act = torch.from_numpy(active)
        st1, payload, _dest = pstep.send(torch.from_numpy(rr), SID, salts,
                                         st, act)
        rst1, _rp, _rd = rstep.send(rr, np.int32(SID), useeds, rst, active)
        vals = tree_map(lambda x: torch.stack(
            [torch.roll(x, j, 0) for j in range(N)], 1), payload)
        mask = torch.from_numpy(rng.random((L, N)) < 0.9)
        rvals = jax.tree_util.tree_map(np.asarray, host.to_numpy(vals))
        mon_t = [torch.from_numpy(np.array(m)) for m in mon]
        st2, ex, ok, dec, val = pstep.update(
            torch.from_numpy(rr), SID, salts, st1, vals, mask, act, *mon_t)
        # the caller carries the plane forward for the active lanes
        ndec = torch.where(act, dec, mon_t[0])
        nval = torch.where(act, val, mon_t[1])
        pst2, pex = plain.update(torch.from_numpy(rr), SID, salts, st1,
                                 vals, mask, act)
        rst2, rex, rok, rndec, rnval = rstep.update(
            rr, np.int32(SID), useeds, rst1, rvals, mask.numpy(), active,
            *mon)
        for a, b in zip(tree_flatten(st2)[0],
                        jax.tree_util.tree_leaves(rst2)):
            assert np.array_equal(a.numpy(), np.asarray(b)), name
        for a, b in zip(tree_flatten(st2)[0], tree_flatten(pst2)[0]):
            assert torch.equal(a, b)
        assert torch.equal(ex, pex)
        assert np.array_equal(ex.numpy(), np.asarray(rex))
        assert np.array_equal(ok.numpy(), np.asarray(rok)), name
        assert np.array_equal(ndec.numpy(), np.asarray(rndec))
        assert np.array_equal(nval.numpy(), np.asarray(rnval))
        assert ok[~act].all()  # inactive lanes are vacuously ok
        st, rst = st2, jax.tree_util.tree_map(np.asarray, rst2)
        mon = (ndec.numpy(), nval.numpy()) + tuple(mon[2:])
    assert lane_step(algo.rounds[0], N, L, monitor=prog) is \
        lane_step(algo.rounds[0], N, L, monitor=prog)
    assert lane_step(algo.rounds[0], N, L, monitor=prog) is not \
        lane_step(algo.rounds[0], N, L)


@pytest.mark.parametrize("name", ["otr", "rv-broken-agreement"])
def test_instance_monitor_equals_round_tpus(name):
    """The host runner's numpy twin: a run of seeded post-update decision
    planes and peer decisions through both packages' InstanceMonitor
    gives the same tripped indices and carried pair at every step."""
    algo, ralgo = _algo(name), r_sel.select(name)
    prog = p_compile.monitor_program(algo, N)
    rprog = r_compile.monitor_program(ralgo, N)
    rng = np.random.default_rng(5)
    init = rng.integers(0, 5, N).astype(np.int32)
    pm = p_compile.InstanceMonitor(prog, init)
    rm = r_compile.InstanceMonitor(rprog, init)
    for step in range(64):
        decided = bool(rng.random() < 0.6)
        value = int(rng.integers(-1, 6))
        rst_row = ralgo.make_init_state(
            RCtx(id=np.int32(0), n=N, r=np.int32(0)),
            {"initial_value": np.int32(0)})
        rst_row = rst_row.replace(decided=np.bool_(decided),
                                  decision=np.int32(value))
        st = host.lane_init_state(algo, 0, N, host.instance_io(algo, 0),
                                  "cpu")
        st = st.replace(decided=torch.tensor(decided),
                        decision=torch.tensor(value, dtype=torch.int32))
        if step % 5 == 3:
            ext = int(rng.integers(0, 5))
            pm.note_ext(np.int32(ext))
            rm.note_ext(np.int32(ext))
        assert pm.check(st) == rm.check(rst_row), step
        assert pm.prev_dec == bool(rm.prev_dec)
        assert np.array_equal(pm.prev_val, np.asarray(rm.prev_val))
        assert pm.ext_dec == rm.ext_dec
    assert p_compile.schedule_init_values(algo, N, "mixed", 0, 7).tolist() \
        == r_compile.schedule_init_values(ralgo, N, "mixed", 0, 7).tolist()


# -- clusters ----------------------------------------------------------------


def _cluster(driver, name, rv, n=3, instances=2, lanes=4, seed=7,
             timeout_ms=2000, max_rounds=12, expect_error=False):
    """One in-thread cluster of the port's replicas on the CPU; returns
    (results, stats, errors)."""
    algo = _algo(name)
    ports = alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    trs = [HostTransport(i, ports[i]) for i in range(n)]
    results, stats, errors = {}, {}, {}

    def node(i):
        st: dict = {}
        kw = dict(timeout_ms=timeout_ms, seed=seed, value_schedule="mixed",
                  max_rounds=max_rounds, stats_out=st, rv=rv, device="cpu")
        try:
            if driver == "lanes":
                results[i] = run_instance_loop_lanes(
                    algo, i, peers, trs[i], instances, lanes=lanes, **kw)
            else:
                results[i] = run_instance_loop(algo, i, peers, trs[i],
                                               instances, **kw)
        except Exception as e:  # noqa: BLE001 — asserted by callers
            errors[i] = e
        finally:
            stats[i] = st
            trs[i].close()

    threads = [threading.Thread(target=node, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=150)
    assert not any(t.is_alive() for t in threads), "replica wedged"
    if not expect_error:
        assert not errors, f"replica errors: {errors}"
    return results, stats, errors


def _formulas(stats, node):
    return {v["formula"] for v in stats.get(node, {}).get("rv_violations",
                                                           [])}


def _copies():
    return {k: METRICS.counter(k).value
            for k in ("lanes.dispatches", "host.d2h_copies",
                      "host.h2d_copies")}


def test_monitors_leave_logs_dispatches_and_copies_unchanged():
    """A deterministic one-replica loopback run of the lane driver
    (lockstep lanes): monitors on and off give the same decision log and
    the same dispatch count, and — the lane state lying on the CPU here —
    no counted copy either way; a clean three-replica run logs the same
    decisions on and off with zero violations and every check counted."""
    algo = _algo("otr")

    def run(rv):
        port = alloc_ports(1)[0]
        tr = HostTransport(0, port)
        try:
            before = _copies()
            st: dict = {}
            log = run_instance_loop_lanes(
                algo, 0, {0: ("127.0.0.1", port)}, tr, 4, lanes=4,
                timeout_ms=2000, seed=3, max_rounds=12, stats_out=st,
                rv=rv, device="cpu")
            after = _copies()
            return log, {k: after[k] - before[k] for k in after}, st
        finally:
            tr.close()

    log_off, d_off, _ = run(None)
    log_on, d_on, st_on = run(RvConfig(policy="log"))
    assert log_on == log_off
    assert d_on == d_off, (d_on, d_off)
    assert st_on["rv_checks"] > 0 and st_on["rv_violations"] == []
    res_off, _s, _e = _cluster("lanes", "otr", None, instances=6, seed=3)
    res_on, stats_on, _e = _cluster("lanes", "otr", RvConfig(policy="log"),
                                    instances=6, seed=3)
    assert res_on == res_off
    for i in range(3):
        assert stats_on[i]["rv_checks"] > 0
        assert stats_on[i]["rv_violations"] == []


@pytest.mark.parametrize("driver", ["lanes", "seq"])
def test_validity_trips_every_replica_and_sheds(driver):
    """The fabricated-value round trips VALIDITY on every replica's own
    update (log); under shed the violating instances are logged
    undecided, as round_tpu's drivers log them."""
    _res, stats, _ = _cluster(driver, "rv-broken-validity",
                              RvConfig(policy="log"))
    for i in range(3):
        assert "property 'Validity'" in _formulas(stats, i), stats.get(i)
    res, stats, _ = _cluster(driver, "rv-broken-validity",
                             RvConfig(policy="shed"))
    for i in range(3):
        assert res[i] == [None, None], (i, res[i])
        assert stats[i]["rv_violations"]


def test_agreement_trips_both_drivers_and_artifact_replays(tmp_path):
    """The broken-agreement round (even pids decide min, odd max) with
    decision gossip trips AGREEMENT under both drivers; the dumped
    artifact replays bit for bit on the port's engine AND on
    round_tpu's, reproducing the violating plane."""
    rv = RvConfig(policy="log", protocol="rv-broken-agreement",
                  dump_dir=str(tmp_path), gossip=True)
    for driver in ("lanes", "seq"):
        _res, stats, _ = _cluster(driver, "rv-broken-agreement", rv)
        hits = set().union(*[_formulas(stats, i) for i in range(3)])
        assert "property 'Agreement'" in hits, driver
    arts = sorted(p for p in os.listdir(tmp_path) if "Agreement" in p)
    assert arts
    path = os.path.join(tmp_path, arts[0])
    art = replay.load_artifact(path)
    assert art["meta"]["rv"]["formula"] == "property 'Agreement'"
    ok, got = replay.check_engine(art, device="cpu")
    assert ok, got
    assert all(got["decided"]) and len(set(got["decision"])) > 1
    r_ok, r_got = r_replay.check_engine(r_replay.load_artifact(path))
    assert r_ok and r_got == got


def test_irrevocability_trips_host_and_halt_raises(tmp_path):
    """The revoking round trips IRREVOCABILITY under the host runner
    (the carried pair at work); under halt the lane driver raises
    RvViolation with its artifact, and the stats keep the record."""
    _res, stats, _ = _cluster("seq", "rv-broken-revoke",
                              RvConfig(policy="log"))
    assert "property 'Irrevocability'" in set().union(
        *[_formulas(stats, i) for i in range(3)])
    rv = RvConfig(policy="halt", protocol="rv-broken-validity",
                  dump_dir=str(tmp_path), bank_engine=False)
    _res, stats, errors = _cluster("lanes", "rv-broken-validity", rv,
                                   expect_error=True)
    assert errors and all(isinstance(e, RvViolation)
                          for e in errors.values())
    e = next(iter(errors.values()))
    assert e.artifact and os.path.exists(e.artifact)
    assert json.load(open(e.artifact))["kind"] == "round_tpu.fuzz.schedule"
    assert any(stats[i].get("rv_violations") for i in errors)


# -- leases and licenses -----------------------------------------------------


def test_lease_clock_equals_round_tpus():
    """The same script of peer notes, quorum notes, checks at chosen
    instants and a revoke gives the same grants and refusals."""
    clocks = []
    for mod in (p_compile, r_compile):
        t = [100.0]
        c = mod.LeaseClock(5, 0, mod.lease_bound_ms(200.0))
        c._now = lambda t=t: t[0]
        c._heard = {0: 100.0}
        clocks.append((c, t))
    script = [("peer", 1), ("check", 100.1), ("peer", 2), ("check", 100.2),
              ("check", 100.5), ("quorum", None), ("check", 100.6),
              ("check", 101.0), ("peer", 3), ("peer", 4), ("check", 101.1),
              ("revoke", None), ("check", 101.2)]
    for op, arg in script:
        outs = []
        for c, t in clocks:
            if op == "peer":
                t[0] += 0.01
                c.note_peer(arg)
            elif op == "quorum":
                c.note_quorum()
            elif op == "revoke":
                c.revoke()
            else:
                t[0] = arg
                outs.append(c.valid())
        assert len(set(outs)) <= 1, (op, arg, outs)
    assert [(c.grants, c.refusals) for c, _t in clocks][0] == \
        [(c.grants, c.refusals) for c, _t in clocks][1]
    assert p_compile.lease_bound_ms(300, 3) == r_compile.lease_bound_ms(300, 3)


def test_license_registry_with_injected_prover_equals_round_tpus():
    """One scripted prover (proves param-otr, fails param-lv once then
    proves it, crashes on nothing else) through both registries: the
    same status, model, suite, envelope and f_max for every query; the
    default prover, cache-only with no cache, proves nothing in either
    package, and either registry turns that into the same denial."""
    def scripted():
        calls = {"param-lv": 0}

        def prover(suite, cache_dir, solve):
            if suite == "param-lv":
                calls["param-lv"] += 1
                return (calls["param-lv"] > 1, False)
            return (True, True)
        return prover

    queries = [("otr", 4), ("otr", 3), ("lv", 7), ("lv", 7), ("lvb", 4),
               ("pbft", 4), ("benor", 5), ("nosuch", 4), ("otr", 10)]
    reg = p_license.ProofLicenseRegistry(prover=scripted())
    rreg = r_license.ProofLicenseRegistry(prover=scripted())
    for name, n in queries:
        a, b = reg.check(name, n), rreg.check(name, n)
        assert (a.status, a.model, a.suite, a.envelope, a.f_max, a.cached,
                a.ok) == (b.status, b.model, b.suite, b.envelope, b.f_max,
                          b.cached, b.ok), (name, n)
    assert p_license.parse_envelope("n > 3f") == 3
    with pytest.raises(ValueError):
        p_license.parse_envelope("n >= f")
    assert p_license._default_prover("param-otr", None, False) == \
        r_license._default_prover("param-otr", None, False) == (False, None)
    a = p_license.ProofLicenseRegistry(solve=False).check("otr", 4)
    b = r_license.ProofLicenseRegistry(solve=False).check("otr", 4)
    assert (a.status, a.suite, a.cached, a.reason) == \
        (b.status, b.suite, b.cached, b.reason)
    assert a.status == "unlicensed" and not a.ok
