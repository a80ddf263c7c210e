"""The port's host runner (round_tpu_torch/runtime/host.py, chaos.py,
control.py; apps/host_replica.py, host_perftest.py, lock_manager.py)
against round_tpu's, on the CPU: the chaos layer's link hash and salts are
bit-exact, a 4-replica thread-mode cluster agrees, a mixed cluster of two
round_tpu and two port replicas decides what an all-round_tpu cluster
decides, the native and Python pumps give byte-identical decision logs,
checkpoint resume and FLAG_DECISION recovery serve as round_tpu's do, and
the lock manager serves round_tpu's clients.  Thread mode with generous
round timeouts; the tests assert decisions, never timings."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import round_tpu.apps.selector as r_sel
import round_tpu.runtime.host as rh
import round_tpu.runtime.transport as rt
from round_tpu.engine import scenarios as r_scen
from round_tpu_torch.apps import host_perftest, host_replica
from round_tpu_torch.apps.selector import select
from round_tpu_torch.engine import scenarios as p_scen
from round_tpu_torch.engine.executor import (
    LocalTopology, host_lane_word, make_host_round_fns,
)
from round_tpu_torch.runtime import chaos, host
from round_tpu_torch.runtime.decisions import DecisionLog
from round_tpu_torch.runtime.oob import Tag
from round_tpu_torch.runtime.transport import HostTransport

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

SEEDS = [0, 1, 23, 2 ** 31 - 1, 2 ** 32 - 1, 2 ** 32, -1, -(2 ** 31),
         2 ** 63 - 1, -(2 ** 63)]


@pytest.mark.parametrize("seed", SEEDS + [int(s) for s in np.random.default_rng(
    5).integers(-2 ** 62, 2 ** 62, size=6)])
def test_host_key_salts_and_link_hash_bit_exact(seed):
    assert p_scen.host_key_salts(seed) == r_scen.host_key_salts(seed)
    s0, s1 = p_scen.host_key_salts(seed)
    for r in (0, 1, 7, 2 ** 31 + 5):
        for src, dst, n, stream in ((0, 1, 4, 0), (3, 2, 4, chaos.STREAM_DUP),
                                    (9, 0, 1000, chaos.STREAM_GARBAGE)):
            assert p_scen.host_link_u32(s0, s1, r, src, dst, n, stream) == \
                r_scen.host_link_u32(s0, s1, r, src, dst, n, stream)


def test_host_key_salts_overflow_as_jax():
    for seed in (2 ** 63, -(2 ** 63) - 1):
        with pytest.raises(OverflowError):
            p_scen.host_key_salts(seed)
        with pytest.raises(OverflowError):
            r_scen.host_key_salts(seed)


def test_fault_plan_schedules_equal_round_tpus():
    """Every fault family's fate of every (src, dst, round) frame equals
    round_tpu's FaultyTransport's, and the drop family is the engine's
    link_bernoulli mask."""
    from round_tpu.runtime import chaos as rchaos

    spec = ("seed=11,drop=0.2,dup=0.1,truncate=0.1,garbage=0.05,"
            "heal_round=3,crash_round=9")
    n = 4

    class Inner:
        id = 1

    ps = chaos.FaultyTransport(Inner(), chaos.FaultPlan.parse(spec), n)
    rs = rchaos.FaultyTransport(Inner(), rchaos.FaultPlan.parse(spec), n)
    assert ps.plan.spec() == rs.plan.spec()
    for r in range(12):
        for dst in range(n):
            tag = Tag(instance=2, round=r)
            got = ps._send_faults(dst, tag, b"payload-bytes")
            want = rs._send_faults(dst, tag, b"payload-bytes")
            assert got == want, (r, dst)
    plan = chaos.FaultPlan(seed=3, drop=0.3)
    s0, s1 = p_scen.host_key_salts(3)
    for r in range(4):
        mask = p_scen.link_bernoulli((s0, s1), r, n, 0.3, device="cpu")
        for src in range(n):
            for dst in range(n):
                u = p_scen.host_link_u32(s0, s1, r, src, dst, n)
                assert bool(mask[dst, src]) == ((u & 0xFF)
                                                < chaos._p8(plan.drop))


def test_host_lane_word_is_the_general_engines():
    topo = LocalTopology(5, device="cpu")
    for seed in (0, 9, 2 ** 32 + 3):
        salts = p_scen.host_key_salts(seed)
        for r in (0, 3, 40):
            words = topo.lane_keys(salts, r)
            assert [host_lane_word(salts, r, i) for i in range(5)] == \
                words.tolist()


def test_host_round_fns_draw_the_general_engines_coins():
    """Ben-Or's update draws a coin: the host runner's update on lane sid
    with seed s equals the general engine's vmapped round on lane sid
    under host_key_salts(s)."""
    from round_tpu_torch.engine.executor import init_lanes, run_round
    from round_tpu_torch.models.common import consensus_io
    from round_tpu_torch.utils.tree import tree_map

    n, seed = 4, 17
    algo = select("benor")
    io = consensus_io(torch.tensor([0, 1, 1, 0], dtype=torch.int32))
    topo = LocalTopology(n, device="cpu")
    state = init_lanes(algo, io, n, topo)
    done = torch.zeros(n, dtype=torch.bool)
    ho = torch.ones((n, n), dtype=torch.bool)
    salts = p_scen.host_key_salts(seed)
    lanes = [tree_map(lambda x: x[i], state) for i in range(n)]
    for r in range(4):
        rnd = algo.rounds[r % len(algo.rounds)]
        f_send, f_update, _ = make_host_round_fns(rnd, n, "cpu")
        sent = [f_send(r, i, seed, lanes[i]) for i in range(n)]
        vals = tree_map(lambda *xs: torch.stack(xs), *[s[1] for s in sent])
        lanes = [f_update(r, i, seed, sent[i][0], vals,
                          torch.stack([s[2][i] for s in sent]))[0]
                 for i in range(n)]
        state, done = run_round(rnd, state, done, r, ho, salts, topo)
        for i in range(n):
            for a, b in zip(torch.utils._pytree.tree_leaves(lanes[i]),
                            torch.utils._pytree.tree_leaves(
                                tree_map(lambda x: x[i], state))):
                assert torch.equal(a, b), (r, i)


def test_adopt_decision_as_round_tpus():
    from round_tpu.core.rounds import RoundCtx as RCtx

    algo, ralgo = select("otr"), r_sel.select("otr")
    st = host.lane_init_state(algo, 0, 4, host.instance_io(algo, 2), "cpu")
    rst = ralgo.make_init_state(RCtx(id=np.int32(0), n=4, r=np.int32(0)),
                                rh.instance_io(ralgo, 2))
    for value in (np.int64(3), 4, np.array([1]), "junk", (1, 2)):
        got, want = algo.adopt_decision(st, value), \
            ralgo.adopt_decision(rst, value)
        assert (got is None) == (want is None), value
        if got is not None:
            assert bool(got.decided) == bool(np.asarray(want.decided))
            assert int(got.decision) == int(np.asarray(want.decision))
            assert got.decision.dtype == torch.int32


def test_adaptive_timeout_tracks_round_tpus():
    a, b = host.AdaptiveTimeout(seed=5), rh.AdaptiveTimeout(seed=5)
    for lat, exp in ((None, True), (12.5, False), (3.0, False),
                     (None, True), (40.0, False), (1.0, False)):
        a.observe(lat, exp)
        b.observe(lat, exp)
        assert a.current_ms() == b.current_ms()


# -- clusters -----------------------------------------------------------------

def _cluster(sides, algo_name, instances, schedule="mixed", timeout_ms=2000,
             pump=True, chaos_spec=None, seed=7):
    """One in-thread cluster; ``sides[i]`` is "port" or "round_tpu".
    Every socket is bound before any replica starts.  Returns the
    decision logs."""
    n = len(sides)
    ports = chaos.alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    trs = [(HostTransport if s == "port" else rt.HostTransport)(i, ports[i])
           for i, s in enumerate(sides)]
    algos = {"port": select(algo_name), "round_tpu": r_sel.select(algo_name)}
    logs, errors = {}, {}

    def node(i):
        tr = trs[i]
        try:
            if sides[i] == "port":
                if chaos_spec:
                    tr = chaos.FaultyTransport(
                        tr, chaos.FaultPlan.parse(chaos_spec), n)
                logs[i] = host.run_instance_loop(
                    algos["port"], i, peers, tr, instances,
                    timeout_ms=timeout_ms, seed=seed,
                    value_schedule=schedule, pump=pump, device="cpu")
            else:
                logs[i] = rh.run_instance_loop(
                    algos["round_tpu"], i, peers, tr, instances,
                    timeout_ms=timeout_ms, seed=seed,
                    value_schedule=schedule, pump=pump)
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
    return logs


def test_port_cluster_agrees_and_pumps_are_byte_identical():
    """Four port replicas agree on every instance; the native pump and
    the Python pump give byte-identical decision logs (as round_tpu's
    tests/test_pump.py holds its own)."""
    a = _cluster(["port"] * 4, "otr", 4, pump=True)
    b = _cluster(["port"] * 4, "otr", 4, pump=False)
    assert all(d is not None for log in a.values() for d in log)
    assert all(a[i] == a[0] for i in a)
    assert DecisionLog.from_values(a[0]).values_tsv() == \
        DecisionLog.from_values(b[0]).values_tsv()
    assert a == b


@pytest.mark.parametrize("algo,instances,timeout_ms",
                         [("otr", 4, 2000), ("lastvoting", 2, 600)])
def test_mixed_cluster_decides_round_tpus_values(algo, instances, timeout_ms):
    """Two round_tpu and two port replicas on one wire decide what four
    round_tpu replicas decide (the uniform schedule makes the decision a
    function of the instance alone, so the comparison is timing-free)."""
    ref = _cluster(["round_tpu"] * 4, algo, instances, schedule="uniform",
                   timeout_ms=timeout_ms)
    mixed = _cluster(["round_tpu", "port", "round_tpu", "port"], algo,
                     instances, schedule="uniform", timeout_ms=timeout_ms)
    assert all(d is not None for log in mixed.values() for d in log)
    assert mixed == ref


def test_chaos_drop_schedule_keeps_agreement():
    logs = _cluster(["port"] * 4, "otr", 3, schedule="uniform",
                    timeout_ms=600, chaos_spec="drop=0.12,seed=5")
    assert all(logs[i] == [(inst) % 5 for inst in range(1, 4)] for i in logs)


def test_checkpoint_resume_and_decision_recovery(tmp_path):
    """A replica restarted from its checkpoint (two of four instances
    durable) resumes at instance 3 and recovers the rest from its peers'
    FLAG_DECISION replies (adopt_decision): its decision log and the
    checkpoint's TSV are byte-identical to a never-crashed run."""
    n, instances = 4, 4
    ref = _cluster(["port"] * n, "otr", instances)
    d0 = str(tmp_path / "ck0")
    host._save_decision_checkpoint(d0, ref[0][:2], 2, instances)
    ports = chaos.alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    trs = [HostTransport(i, ports[i]) for i in range(n)]
    served, out, errors = {}, {}, {}

    def peer(i):
        try:
            served[i] = host.serve_decisions(trs[i], ref[i], idle_ms=3000,
                                             contact_idle_ms=500)
        finally:
            trs[i].close()

    def restarted():
        try:
            out[0] = host.run_instance_loop(
                select("otr"), 0, peers, trs[0], instances,
                timeout_ms=2000, seed=7, checkpoint_dir=d0, device="cpu")
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors[0] = e
        finally:
            trs[0].close()

    threads = [threading.Thread(target=peer, args=(i,))
               for i in range(1, n)] + [threading.Thread(target=restarted)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert out[0] == ref[0]
    assert sum(served.values()) >= 1
    want = DecisionLog.from_values(ref[0]).values_tsv()
    assert DecisionLog.from_values(out[0]).values_tsv() == want
    host._save_decision_checkpoint(str(tmp_path / "ref"), ref[0],
                                   instances, instances)
    for name in ("decisions.tsv", "manifest.json"):
        assert (tmp_path / "ck0" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


def test_view_propose_decides_over_the_host_runner():
    """ViewManager.propose runs its consensus through the port's
    HostRunner: every member proposes the same ADD and every member's
    view moves to epoch 1 with the new replica."""
    from round_tpu_torch.runtime.membership import Group, Replica
    from round_tpu_torch.runtime.view import ADD, View, ViewManager

    n = 3
    ports = chaos.alloc_ports(n + 1)
    group = Group([Replica(i, "127.0.0.1", ports[i]) for i in range(n)])
    trs = [HostTransport(i, ports[i]) for i in range(n)]
    out, errors = {}, {}

    def node(i):
        try:
            vm = ViewManager(i, View(0, group), trs[i])
            out[i] = (vm.propose(select("otr"), ADD, ports[n],
                                 timeout_ms=2000, device="cpu"),
                      vm.epoch, vm.view.n)
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors[i] = e
        finally:
            trs[i].close()

    threads = [threading.Thread(target=node, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert all(out[i] == ((ADD, ports[n]), 1, n + 1) for i in range(n)), out


def test_lock_manager_serves_as_round_tpus():
    """The replicated lock decides round_tpu's holders, and its service
    answers a round_tpu client's pickled requests over the wire."""
    import pickle

    from round_tpu.apps import lock_manager as rlm
    from round_tpu_torch.apps import lock_manager as plm

    ops = [(plm.ACQUIRE, 3), (plm.ACQUIRE, 5), (plm.RELEASE, 5),
           (plm.RELEASE, 3), (plm.ACQUIRE, 5)]
    pm, rm = plm.LockManager(n=4, device="cpu"), rlm.LockManager(n=4)
    for op, client in ops:
        pm.request(op, client)
        rm.request(op, client)
        pm.process()
        rm.process()
        assert pm.holder() == rm.holder()
    lm = plm.LockManager(n=4, device="cpu")
    ports = chaos.alloc_ports(2)
    with HostTransport(0, ports[0]) as srv, \
            rt.HostTransport(7, ports[1]) as client:
        client.add_peer(0, "127.0.0.1", ports[0])
        t = threading.Thread(target=plm.serve, args=(lm, srv),
                             kwargs={"rounds": 2})
        t.start()
        replies = []
        for op in (plm.ACQUIRE, plm.RELEASE):
            client.send(0, rt.Tag(instance=1, flag=plm.FLAG_LOCK_REQ),
                        pickle.dumps((op, 7)))
            got = None
            while got is None:
                got = client.recv(2000)
            replies.append(pickle.loads(bytes(got[2])))
        t.join(timeout=60)
    assert replies == [(True, 7), (True, plm.FREE)]


def test_fleet_supervisor_steps_as_round_tpus():
    """control.py's supervisor over a stub router: the same signals give
    the same grow/shrink trajectory in both packages; without a license
    registry the port's default is rv/license.py's registry, as
    round_tpu's is."""
    from round_tpu.runtime import control as rcontrol
    from round_tpu_torch.runtime import control as pcontrol

    class Lic:
        ok, status, reason = True, "licensed", "stub"

        def to_json(self):
            return {"status": self.status}

    class Registry:
        def check(self, model, n, solve=None):
            return Lic()

    class Model:
        def predict_dps(self, drivers, lanes, payload_bytes=0, read_frac=0):
            return 100.0 * drivers

    class Ring:
        def __init__(self):
            self.shards = ["s0"]

        def region_of(self, name):
            return "r0"

    class Router:
        def __init__(self):
            self.ring, self.shard_health, self.latency_ms = Ring(), {}, {}
            self.proposals, self.results, self._inflight = 0, [], {}

        def add_shard(self, name, replicas, region=None):
            self.ring.shards.append(name)

        def remove_shard(self, name):
            self.ring.shards.remove(name)
            return 0

    trails = []
    for mod in (pcontrol, rcontrol):
        router = Router()
        sup = mod.FleetSupervisor(
            router, algo_name="otr", n=4, spawn=lambda name: [],
            retire=lambda name: None, model=Model(),
            license_registry=Registry(), cooldown_s=0.0, window_s=1.0)
        trail = []
        for k in range(12):
            router.proposals += 300 if k < 6 else 5
            router.results.extend(range(300 if k < 6 else 5))
            dec = sup.step(now=float(k))
            trail.append(None if dec is None else
                         (dec["action"], dec["drivers_after"]))
        trails.append(trail)
    assert trails[0] == trails[1] and any(trails[0])
    from round_tpu_torch.rv.license import ProofLicenseRegistry

    sup = pcontrol.FleetSupervisor(Router(), algo_name="otr", n=4,
                                   spawn=None, retire=None)
    assert isinstance(sup.license_registry, ProofLicenseRegistry)


# -- the card by default ------------------------------------------------------


def test_entry_points_raise_without_a_card():
    """The card is the default: where torch finds none, the runner, the
    perftest and the replica raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    tr = HostTransport(0)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            host.HostRunner(select("otr"), 0, {0: ("127.0.0.1", tr.port)},
                            tr)
    finally:
        tr.close()
    with pytest.raises(RuntimeError, match="CUDA"):
        host_perftest.measure(instances=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        host_replica.main(["--id", "0", "--peers", "127.0.0.1:1"])


@pytest.mark.parametrize("flag", [["--snap"], ["--rv", "log"],
                                  ["--snap", "log"], ["--view-license"],
                                  ["--chaos-schedule",
                                   "tests/regressions/otr_equivocation_"
                                   "victim.json"]])
def test_replica_refuses_later_slices(flag, capsys):
    """An artifact replay whose n is not the cluster's is refused as
    round_tpu refuses it; ``--rv``, ``--snap`` and ``--view-license``
    now run: a one-replica loop under the monitors counts its checks,
    under snapshots audits its cuts clean, and a licensed view manager
    reports its (empty) refusals."""
    if "--chaos-schedule" in flag:
        art = Path(__file__).resolve().parent.parent / flag[1]
        with pytest.raises(SystemExit) as ei:
            host_replica.main(["--id", "0", "--peers", "127.0.0.1:1",
                               "--device", "cpu", flag[0], str(art)])
        assert ei.value.code == 2
        assert "n=4" in capsys.readouterr().err
        return
    port = chaos.alloc_ports(1)[0]
    extra = (["--view-change", ""] if "--view-license" in flag
             else ["--snap-every", "1"] if "--snap" in flag else [])
    assert host_replica.main(
        ["--id", "0", "--peers", f"127.0.0.1:{port}", "--device", "cpu",
         "--instances", "3", "--timeout-ms", "200", *flag, *extra]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["decided_instances"] == 3
    if "--rv" in flag:
        assert out["rv"]["checks"] > 0 and out["rv"]["violations"] == []
    elif "--snap" in flag:
        assert out["snap"]["cuts_audited"] > 0
        assert out["snap"]["violations"] == [] == out["snap"]["divergences"]
    else:
        assert out["view_refused"] == [] and out["view_degraded"] is False


def test_replica_processes_survive_a_crash_restart():
    """The one subprocess test: four host_replica processes on the CPU
    under a seeded drop plan (run_chaos_cluster); replica 2 is SIGKILLed
    once it has durably decided an instance and restarted from its
    checkpoint.  Every replica's decision-log TSV is byte-identical and
    is the fault-invariant uniform schedule's."""
    import tempfile

    instances = 6
    with tempfile.TemporaryDirectory() as d:
        out = chaos.run_chaos_cluster(
            d, n=4, instances=instances, chaos="drop=0.1,seed=3",
            crash_replica=2, crash_after=1, timeout_ms=600,
            linger_ms=3000, device="cpu", join_timeout=120)
    logs = out["log_bytes"]
    assert logs[0] == logs[1] == logs[2] == logs[3]
    assert out["decisions"][2] == [inst % 5 for inst in
                                   range(1, instances + 1)]
