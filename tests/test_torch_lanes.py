"""The port's lane-batched driver (round_tpu_torch/engine/executor.py's
lane half, round_tpu_torch/runtime/lanes.py) against its per-instance
trio, its per-instance driver and round_tpu's lane driver, on the CPU,
tolerance 0 (raw bits, or equal decision logs).

  * the mega-step: ``LaneStep`` equals ``make_host_round_fns`` applied
    lane by lane (state, payload, dest, exit, go probe), inactive lanes
    keep their state bit for bit, the device word twin ``lane_words``
    equals ``host_lane_word``, and for OTR and LastVoting (whose update
    draws nothing) round_tpu's ``LaneStep`` on the same inputs;
  * the driver: lane logs equal per-instance logs (OTR mixed schedule,
    LastVotingEvent's go probes, LastVotingBytes' wide payloads, a chaos
    drop schedule), checkpoint resume is byte-identical, admission churn
    builds no new LaneStep, a late replica adopts decision replies, the
    port's lane logs equal round_tpu's ``run_instance_loop_lanes`` logs,
    and a mixed cluster of round_tpu and port lane replicas (which
    exchange cross-lane FLAG_BATCH containers) decides round_tpu's
    values;
  * overload: a shedding lane replica accounts every shed frame.

Thread clusters use generous round deadlines (900 ms where chaos runs)
and assert decisions, never timings."""

import functools
import json
import threading
import time

import numpy as np
import pytest
import torch

import round_tpu.apps.selector as r_sel
import round_tpu.runtime.lanes as r_lanes
import round_tpu.runtime.transport as r_transport
from round_tpu.core.rounds import RoundCtx as RCtx
from round_tpu.engine import executor as r_exec
from round_tpu_torch.apps.selector import select
from round_tpu_torch.engine.executor import (
    LaneStep, host_lane_word, lane_decide, lane_sample_rows, lane_step,
    lane_words, make_host_round_fns,
)
from round_tpu_torch.engine.scenarios import host_key_salts
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime import host
from round_tpu_torch.runtime.chaos import FaultPlan, FaultyTransport, alloc_ports
from round_tpu_torch.runtime.decisions import DecisionLog
from round_tpu_torch.runtime.instances import AdmissionControl
from round_tpu_torch.runtime.lanes import LaneDriver, run_instance_loop_lanes
from round_tpu_torch.runtime.transport import HostTransport
from round_tpu_torch.utils.tree import tree_flatten, tree_map, tree_stack

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

N, L, SID = 4, 16, 1
MODELS = [("otr", {}), ("lastvoting", {}), ("lve", {}),
          ("lvb", {"payload_bytes": 64})]


@functools.lru_cache(maxsize=None)
def _algo(name: str, payload_bytes: int = 0):
    """One Algorithm object per (name, payload) for the module: the lane
    steps cache on its Round objects."""
    return select(name, {"payload_bytes": payload_bytes}
                  if payload_bytes else {})


def _lanes_input(algo, seed=0):
    """[L, ...] state of L instances (values from a seeded numpy draw),
    their seeds and salts, per-lane rounds of one class and an active
    mask; the rng is numpy's, shared with round_tpu's side."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 5, L)
    states = [host.lane_init_state(algo, SID, N,
                                   host.instance_io(algo, int(v)), "cpu")
              for v in values]
    seeds = [7 + i for i in range(1, L + 1)]
    salts = torch.tensor([host_key_salts(s)[1] for s in seeds],
                         dtype=torch.int64)
    active = torch.from_numpy(rng.random(L) < 0.7)
    mask = torch.from_numpy(rng.random((L, N)) < 0.8)
    return rng, values, tree_stack(states), seeds, salts, active, mask


def _row(tree, lane):
    return tree_map(lambda x: x[lane], tree)


def _equal_trees(a, b, flatten=tree_flatten):
    la, lb = flatten(a)[0], flatten(b)[0]
    return len(la) == len(lb) and all(
        torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for x, y in zip(la, lb))


def _mailbox(payload):
    """Every lane's mailbox: each sender's slot holds a lane's payload
    rolled by the sender index (a deterministic, lane-varying mailbox)."""
    return tree_map(lambda x: torch.stack(
        [torch.roll(x, j, 0) for j in range(N)], 1), payload)


@pytest.mark.parametrize("name,opts", MODELS, ids=[m[0] for m in MODELS])
def test_lane_step_equals_the_per_instance_trio(name, opts):
    """Every round class: the mega-step's send, update and go probe
    equal the host runner's trio applied lane by lane on the same inputs;
    inactive lanes keep their state bit for bit and send to no one."""
    algo = _algo(name, opts.get("payload_bytes", 0))
    rng, _v, st, seeds, salts, active, mask = _lanes_input(algo, 1)
    for c, rnd in enumerate(algo.rounds):
        rr = torch.from_numpy(
            (rng.integers(0, 6, L) * len(algo.rounds) + c).astype(np.int32))
        step = LaneStep(rnd, N, L)
        f_send, f_update, f_go = make_host_round_fns(rnd, N, "cpu")
        st1, payload, dest = step.send(rr, SID, salts, st, active)
        vals = _mailbox(payload)
        st2, ex = step.update(rr, SID, salts, st1, vals, mask, active)
        go = (step.go(rr, SID, salts, st1, vals, mask)
              if step.go is not None else None)
        assert (go is None) == (f_go is None)
        for lane in range(L):
            r, s = int(rr[lane]), seeds[lane]
            a1, p1, d1 = f_send(r, SID, s, _row(st, lane))
            a2, e2 = f_update(r, SID, s, _row(st1, lane), _row(vals, lane),
                              mask[lane])
            if bool(active[lane]):
                assert _equal_trees(_row(st1, lane), a1), (name, c, lane)
                assert _equal_trees(_row(payload, lane), p1, host._flatten)
                assert torch.equal(dest[lane], d1)
                assert _equal_trees(_row(st2, lane), a2), (name, c, lane)
                assert bool(ex[lane]) == bool(e2)
            else:
                assert _equal_trees(_row(st1, lane), _row(st, lane))
                assert _equal_trees(_row(st2, lane), _row(st1, lane))
                assert not dest[lane].any() and not ex[lane]
            if go is not None:
                assert bool(go[lane]) == bool(f_go(
                    r, SID, s, _row(st1, lane), _row(vals, lane),
                    mask[lane]))
        st = st2
    decided, decision = lane_decide(algo, L)(st)
    for lane in range(L):
        assert bool(decided[lane]) == bool(algo.decided(_row(st, lane)))
        assert torch.equal(decision[lane], algo.decision(_row(st, lane)))


@pytest.mark.parametrize("sid", [0, 3, 1023])
def test_lane_words_equal_host_lane_word(sid):
    """The device twin over a sweep of seeds (int64 extremes, negative
    seeds, ones past 2^32) and rounds: each lane's word is the host
    runner's, bit for bit."""
    seeds = [0, 1, 7, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32 + 5, -1, -(2 ** 63),
             2 ** 63 - 1] + [int(s) for s in np.random.default_rng(
                 sid).integers(-2 ** 62, 2 ** 62, size=23)]
    rounds = [0, 1, 3, 40, 2 ** 16 + 1, 2 ** 31 - 1] * 6
    salts = torch.tensor([host_key_salts(s)[1] for s in seeds],
                         dtype=torch.int64)
    rr = torch.tensor(rounds[:len(seeds)], dtype=torch.int32)
    words = lane_words(0, salts, rr, sid)
    assert words.tolist() == [
        host_lane_word(host_key_salts(s), r, sid)
        for s, r in zip(seeds, rounds)]


def _round_tpu_state(ralgo, values):
    rows = [ralgo.make_init_state(
        RCtx(id=np.int32(SID), n=N, r=np.int32(0)),
        {"initial_value": np.int32(v)}) for v in values]
    import jax

    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *rows)


@pytest.mark.parametrize("name", ["otr", "lastvoting"])
def test_lane_step_equals_round_tpus(name):
    """round_tpu's jitted LaneStep and the port's on the same [L, ...]
    state, rounds, active mask and mailbox: the same state, payload,
    destinations and exit flags, leaf by leaf (the update draws
    nothing, so the rng words, which differ by design, never enter)."""
    import jax

    algo, ralgo = _algo(name), r_sel.select(name)
    rng, values, st, _seeds, salts, active, mask = _lanes_input(algo, 2)
    rst = _round_tpu_state(ralgo, values)
    useeds = np.arange(L, dtype=np.uint32)
    for c, (rnd, rrnd) in enumerate(zip(algo.rounds, ralgo.rounds)):
        rr_np = (rng.integers(0, 6, L) * len(algo.rounds) + c).astype(
            np.int32)
        rr = torch.from_numpy(rr_np)
        pstep, rstep = LaneStep(rnd, N, L), r_exec.LaneStep(rrnd, N, L)
        st1, payload, dest = pstep.send(rr, SID, salts, st, active)
        rst1, rpayload, rdest = rstep.send(rr_np, np.int32(SID), useeds,
                                           rst, active.numpy())
        vals = _mailbox(payload)
        rvals = jax.tree_util.tree_map(np.asarray, host.to_numpy(vals))
        st2, ex = pstep.update(rr, SID, salts, st1, vals, mask, active)
        rst2, rex = rstep.update(rr_np, np.int32(SID), useeds, rst1, rvals,
                                 mask.numpy(), active.numpy())
        for got, want in ((st1, rst1), (st2, rst2)):
            pl = [x.numpy() for x in tree_flatten(got)[0]]
            rl = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
            assert len(pl) == len(rl)
            for a, b in zip(pl, rl):
                assert a.shape == b.shape and np.array_equal(a, b), (name, c)
        pp = host._flatten(host.to_numpy(payload))[0]
        rp = jax.tree_util.tree_leaves(rpayload)
        assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(pp, rp))
        assert np.array_equal(dest.numpy(), np.asarray(rdest))
        assert np.array_equal(ex.numpy(), np.asarray(rex))
        st, rst = st2, jax.tree_util.tree_map(np.asarray, rst2)


def test_lane_sample_rows_and_step_cache():
    """lane_sample_rows gives one lane's rows as owning arrays with
    round_tpu's shapes (0-d stays 0-d); lane_step caches per (n, lanes,
    monitored) and takes a monitor program (rv/compile.py)."""
    algo = _algo("otr")
    _rng, values, st, *_ = _lanes_input(algo, 3)
    leaves = tree_flatten(st)[0]
    rows = lane_sample_rows(leaves, 5)
    want = r_exec.lane_sample_rows([x.numpy() for x in leaves], 5)
    assert [r.shape for r in rows] == [w.shape for w in want]
    assert all(np.array_equal(r, w) for r, w in zip(rows, want))
    leaves[0][5] += 1
    assert np.array_equal(rows[0], want[0])  # owning, not a view
    rnd = algo.rounds[0]
    assert lane_step(rnd, N, L) is lane_step(rnd, N, L)
    assert lane_step(rnd, N, 2 * L) is not lane_step(rnd, N, L)
    from round_tpu_torch.rv.compile import monitor_program

    prog = monitor_program(algo, N)
    mon = lane_step(rnd, N, L, monitor=prog)
    assert mon is lane_step(rnd, N, L, monitor=prog)
    assert mon is not lane_step(rnd, N, L) and mon.monitor is prog


# -- clusters -----------------------------------------------------------------

def _cluster(driver, algo, n=3, instances=6, lanes=4, seed=7,
             timeout_ms=2000, schedule="mixed", chaos=None,
             checkpoint_dirs=None, start_delay=None, sides=None,
             rname=None, linger_ms=0):
    """One in-thread cluster; ``driver`` is "seq" (the port's
    per-instance loop) or "lanes" (the port's lane driver), and
    ``sides[i]`` == "round_tpu" runs replica i as round_tpu's lane
    driver on round_tpu's model ``rname`` instead.  ``linger_ms`` > 0
    keeps each port replica answering laggards with decision replies
    after its loop (host.serve_decisions, host_replica's --linger-ms).  Every socket is bound before any replica starts.
    Returns {replica: decision log}."""
    sides = sides or ["port"] * n
    ports = alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    trs = [(HostTransport if s == "port" else r_transport.HostTransport)(
        i, ports[i]) for i, s in enumerate(sides)]
    ralgo = r_sel.select(rname) if "round_tpu" in sides else None
    results, errors = {}, {}

    def node(i):
        if start_delay and i in start_delay:
            time.sleep(start_delay[i])
        tr = trs[i]
        if chaos:
            tr = FaultyTransport(tr, FaultPlan.parse(chaos), n)
        ck = checkpoint_dirs[i] if checkpoint_dirs else None
        try:
            if sides[i] == "round_tpu":
                results[i] = r_lanes.run_instance_loop_lanes(
                    ralgo, i, peers, tr, instances, lanes=lanes,
                    timeout_ms=timeout_ms, seed=seed,
                    value_schedule=schedule)
            elif driver == "lanes":
                results[i] = run_instance_loop_lanes(
                    algo, i, peers, tr, instances, lanes=lanes,
                    timeout_ms=timeout_ms, seed=seed,
                    value_schedule=schedule, checkpoint_dir=ck,
                    device="cpu")
            else:
                results[i] = host.run_instance_loop(
                    algo, i, peers, tr, instances, timeout_ms=timeout_ms,
                    seed=seed, value_schedule=schedule, checkpoint_dir=ck,
                    device="cpu")
            if linger_ms and sides[i] == "port":
                host.serve_decisions(tr, results[i], idle_ms=linger_ms,
                                     contact_idle_ms=linger_ms // 2)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors[i] = e
        finally:
            trs[i].close()

    threads = [threading.Thread(target=node, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "replica thread wedged"
    assert not errors, errors
    return results


EQUIV = [
    # (model, payload bytes, instances, lanes, timeout ms, schedule, chaos)
    ("otr", 0, 6, 4, 2000, "mixed", None),
    # LastVotingEvent: the FoldRound go probe as a batched dispatch;
    # uniform schedule, where the decision is arrival-order-invariant
    ("lve", 0, 3, 3, 2000, "uniform", None),
    # LastVotingBytes: wide payloads in the lane mailboxes; logs hold
    # digests.  The deadline paces non-coordinator rounds: keep it small
    ("lvb", 64, 3, 3, 200, "mixed", None),
    # a seeded drop schedule: the same logical frames fault whatever the
    # lane packing; 900 ms so a loaded box does not expire rounds.  A
    # replica whose last deciding frame drops finds its peers gone once
    # they finish, in either driver, so replicas linger (below)
    ("otr", 0, 4, 4, 900, "uniform", "drop=0.12,seed=5"),
]


@pytest.mark.parametrize("name,pb,instances,lanes,timeout_ms,schedule,chaos",
                         EQUIV, ids=["otr", "lve", "lvb", "otr-chaos"])
def test_lanes_equal_the_per_instance_driver(name, pb, instances, lanes,
                                             timeout_ms, schedule, chaos):
    algo = _algo(name, pb)
    kw = dict(instances=instances, timeout_ms=timeout_ms,
              schedule=schedule, chaos=chaos,
              linger_ms=1500 if chaos else 0)
    seq = _cluster("seq", algo, **kw)
    got = _cluster("lanes", algo, lanes=lanes, **kw)
    assert got == seq
    assert all(d is not None for log in got.values() for d in log)


def test_lanes_checkpoint_resume_byte_identical(tmp_path):
    algo = _algo("otr")
    instances = 6
    ref = _cluster("lanes", algo, instances=instances, schedule="uniform")
    # every replica restarts owning only the first 3 decisions
    dirs = {i: str(tmp_path / f"ck{i}") for i in range(3)}
    for i in range(3):
        host._save_decision_checkpoint(dirs[i], ref[i][:3], 3, instances)
    out = _cluster("lanes", algo, instances=instances, schedule="uniform",
                   checkpoint_dirs=dirs)
    assert out == ref
    from round_tpu_torch.runtime import checkpoint

    for i in range(3):
        assert checkpoint.restore_decisions(dirs[i]).values_tsv() == \
            DecisionLog.from_values(ref[i]).values_tsv()


def test_lane_admission_churn_builds_no_new_step():
    """20 instances through a 4-wide lane table: every instance cycles
    through a lane slot, logs equal the per-instance driver's, and each
    round class holds ONE LaneStep, at (n, lanes) = (3, 4)."""
    algo = select("otr")  # a fresh object: its step cache starts empty
    c0 = {k: METRICS.counter(k).value
          for k in ("lanes.admitted", "lanes.retired", "lanes.dispatches")}
    got = _cluster("lanes", algo, instances=20, lanes=4)
    seq = _cluster("seq", algo, instances=20)
    assert got == seq
    d = {k: METRICS.counter(k).value - v for k, v in c0.items()}
    assert d["lanes.admitted"] == d["lanes.retired"] == 3 * 20
    assert d["lanes.dispatches"] > 0
    for rnd in algo.rounds:
        assert set(rnd._lane_steps) == {(3, 4, False)}  # unmonitored


def test_lanes_late_replica_adopts_decision_replies():
    """A lane replica that starts late finds its peers' early instances
    retired: its traffic is answered with FLAG_DECISION replies that its
    lanes adopt out of band — one log, no starvation."""
    out = _cluster("lanes", _algo("otr"), instances=6, lanes=2,
                   schedule="uniform", timeout_ms=400,
                   start_delay={2: 0.8})
    assert len({tuple(log) for log in out.values()}) == 1
    assert all(d is not None for log in out.values() for d in log)


@pytest.mark.parametrize("name,instances,timeout_ms,schedule",
                         [("otr", 6, 2000, "mixed"),
                          ("lastvoting", 3, 600, "uniform")])
def test_lanes_equal_round_tpus_lane_driver(name, instances, timeout_ms,
                                            schedule):
    """The same seeds and schedule through three round_tpu lane replicas
    and three port lane replicas: equal decision logs."""
    algo = _algo(name)
    kw = dict(instances=instances, timeout_ms=timeout_ms, schedule=schedule)
    ref = _cluster("lanes", algo, sides=["round_tpu"] * 3, rname=name, **kw)
    got = _cluster("lanes", algo, **kw)
    assert got == ref
    assert all(d is not None for log in got.values() for d in log)


def test_mixed_lane_cluster_decides_round_tpus_values():
    """Two round_tpu and two port lane replicas on one wire (4 lanes, 6
    instances: each wave's frames to a peer coalesce across lanes into
    one FLAG_BATCH container, decoded by the other package) decide what
    four round_tpu lane replicas decide."""
    algo = _algo("otr")
    kw = dict(n=4, instances=6, lanes=4, schedule="uniform", rname="otr")
    ref = _cluster("lanes", algo, sides=["round_tpu"] * 4, **kw)
    mixed = _cluster("lanes", algo,
                     sides=["round_tpu", "port", "round_tpu", "port"], **kw)
    assert mixed == ref
    assert all(d is not None for log in mixed.values() for d in log)


def test_lane_driver_sheds_with_full_nack_accounting():
    """Replica 0 runs one lane with a 1-byte budget while its peers run
    four: it sheds, and every shed frame is NACK-accounted
    (shed_frames == nacks_sent + nacks_suppressed); the polite majority
    decides the uniform schedule (round_tpu's
    tests/test_overload.py::test_lane_driver_sheds_with_full_nack_accounting)."""
    names = ("overload.nacks_sent", "overload.nacks_suppressed",
             "overload.shed_frames", "overload.nacks_seen")
    base = {k: METRICS.counter(k).value for k in names}
    n, instances = 4, 8
    ports = alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    trs = [HostTransport(i, ports[i]) for i in range(n)]
    results, stats, errors = {}, {i: {} for i in range(n)}, {}

    def node(i):
        try:
            results[i] = run_instance_loop_lanes(
                _algo("otr"), i, peers, trs[i], instances,
                lanes=1 if i == 0 else 4, timeout_ms=400, seed=11,
                value_schedule="uniform", max_rounds=24, linger_ms=3000,
                stats_out=stats[i], device="cpu",
                admission=(AdmissionControl(high_bytes_per_lane=1,
                                            shed_deadline_ms=1)
                           if i == 0 else None))
        except BaseException as e:  # noqa: BLE001
            errors[i] = e
        finally:
            trs[i].close()

    threads = [threading.Thread(target=node, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    d = {k: METRICS.counter(k).value - v for k, v in base.items()}
    assert stats[0].get("shed_instances", 0) > 0 \
        or d["overload.shed_frames"] > 0
    assert d["overload.shed_frames"] == \
        d["overload.nacks_sent"] + d["overload.nacks_suppressed"]
    assert stats[0]["shed_frames"] == \
        stats[0]["nacks_sent"] + stats[0]["nacks_suppressed"]
    if d["overload.nacks_sent"]:
        assert d["overload.nacks_seen"] > 0
    want = [v % 5 for v in range(1, instances + 1)]
    for i in (1, 2, 3):
        assert results[i] == want, (i, results[i])
    assert all(x is None or x == want[k] for k, x in enumerate(results[0]))


# The name is historical (these hooks once raised naming their slice);
# it is kept so that the case keeps its identity across versions of the
# suite.
def test_later_slice_hooks_raise():
    """The driver's hooks build: ``rv=`` the monitored driver (an
    algorithm with no decision plane to monitor leaves it off),
    ``snap=`` its snapshot driver and ``kv=`` the replica's key-value
    shard."""
    from round_tpu_torch.kv.store import KvConfig, KVShard
    from round_tpu_torch.rv.dump import RvConfig
    from round_tpu_torch.snap import SnapConfig

    tr = HostTransport(0, alloc_ports(1)[0])
    try:
        shard = KVShard(KvConfig(), node=0, n=1, timeout_ms=300)
        d = LaneDriver(_algo("lvb", 64), 0, {0: ("127.0.0.1", 1)}, tr,
                       device="cpu", kv=shard)
        assert d._kv is shard and d._kv_reads == []
        d = LaneDriver(_algo("otr"), 0, {0: ("127.0.0.1", 1)}, tr,
                       device="cpu", snap=SnapConfig(every_k=2))
        assert d._snap is not None and d._snap.is_collector
        d = LaneDriver(_algo("otr"), 0, {0: ("127.0.0.1", 1)}, tr,
                       device="cpu", rv=RvConfig(policy="log"))
        assert d._rv is not None and d._rv_mon.slots == (
            "agreement", "validity", "irrevocability")
        d = LaneDriver(_algo("lvb", 64), 0, {0: ("127.0.0.1", 1)}, tr,
                       device="cpu", rv=RvConfig(policy="log"))
        assert d._rv is None
    finally:
        tr.close()


def test_host_replica_runs_the_lane_loop(capsys):
    """``host_replica --lanes`` serves its instances on the lane driver
    (a one-replica group decides alone) and reports its overload
    accounting with ``--admission``."""
    from round_tpu_torch.apps import host_replica

    port = alloc_ports(1)[0]
    assert host_replica.main([
        "--id", "0", "--peers", f"127.0.0.1:{port}", "--device", "cpu",
        "--lanes", "4", "--instances", "6", "--value-schedule", "uniform",
        "--admission", "--timeout-ms", "200"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["decisions"] == [i % 5 for i in range(1, 7)]
    assert out["overload"]["shed_frames"] == \
        out["overload"]["nacks_sent"] + out["overload"]["nacks_suppressed"]
