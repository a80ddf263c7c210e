"""The port's fleet (round_tpu_torch/runtime/fleet.py, apps/loadgen.py,
apps/fleet.py) against round_tpu's, on the CPU, tolerance 0:

  * placement: ``ShardMap`` and ``TwoLevelRing`` give round_tpu's owners
    for the same shard names, instance ids and byte keys (blake2b);
  * load: ``plan_arrivals``, ``plan_tenant_arrivals`` and
    ``payload_value`` equal round_tpu's;
  * serving (in-process ``DriverServer`` shards on the CPU): a router
    over two shards decides every proposed value, the client-driven
    serve loop gives the scheduled lane run's log, NACK retry backs off
    and gives up loudly, an undecided resolution needs every replica,
    a starved shard's sheds are NACK-accounted through the router, and
    a garbage proposal is refused with its lane slot released;
  * the apps: one open-loop bench of two shard processes (the only
    subprocess test), the capacity bank, and the slice errors of
    ``fleet serve``."""

import functools
import json
import threading
import time

import numpy as np
import pytest
import torch

import round_tpu.apps.loadgen as r_loadgen
import round_tpu.runtime.fleet as r_fleet
from round_tpu_torch.apps import fleet as fleet_app
from round_tpu_torch.apps.loadgen import (
    open_loop, payload_value, plan_arrivals, plan_tenant_arrivals,
)
from round_tpu_torch.apps.selector import select
from round_tpu_torch.runtime import codec
from round_tpu_torch.runtime.chaos import alloc_ports
from round_tpu_torch.runtime.fleet import (
    DriverServer, FleetGiveUp, FleetRouter, ShardMap, TwoLevelRing,
)
from round_tpu_torch.runtime.host import instance_io
from round_tpu_torch.runtime.lanes import LaneDriver, run_instance_loop_lanes
from round_tpu_torch.runtime.oob import (
    FLAG_DECISION, FLAG_NACK, FLAG_NORMAL, FLAG_PROPOSE, FLAG_TOO_LATE, Tag,
)
from round_tpu_torch.runtime.transport import HostTransport

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _algo(name: str, payload_bytes: int = 0):
    return select(name, {"payload_bytes": payload_bytes}
                  if payload_bytes else {})


# -- placement and load plans -------------------------------------------------

def test_shard_map_owners_equal_round_tpus():
    names = [f"s{i}" for i in range(5)] + ["east-1", "ü-shard"]
    ring, rring = ShardMap(names), r_fleet.ShardMap(names)
    keys = list(range(0, 5000)) + [0xFEFF, 2 ** 40 + 3]
    assert [ring.owner(k) for k in keys] == [rring.owner(k) for k in keys]
    blobs = [bytes([i, 255 - i]) * (i % 7) for i in range(200)]
    assert [ring.owner_key(b) for b in blobs] == \
        [rring.owner_key(b) for b in blobs]
    for r in (ring, rring):
        r.remove("s2")
    assert [ring.owner(k) for k in keys] == [rring.owner(k) for k in keys]
    with pytest.raises(ValueError):
        ShardMap(["a", "a"])


def test_two_level_ring_owners_equal_round_tpus():
    ring, rring = TwoLevelRing(), r_fleet.TwoLevelRing()
    for i in range(7):
        for r in (ring, rring):
            r.add(f"s{i}", region=f"r{i % 3}")
    keys = list(range(1, 3001))
    assert [ring.owner(k) for k in keys] == [rring.owner(k) for k in keys]
    assert ring.regions == rring.regions
    for r in (ring, rring):
        r.remove("s4")
        r.remove("s1")  # r1's last shard: the region leaves the outer ring
    assert [ring.owner(k) for k in keys] == [rring.owner(k) for k in keys]
    assert ring.regions == rring.regions
    assert [ring.owner_key(bytes([k % 256, k // 256])) for k in keys] == \
        [rring.owner_key(bytes([k % 256, k // 256])) for k in keys]


@pytest.mark.parametrize("skew", [0.0, 1.5])
def test_plan_arrivals_equal_round_tpus(skew):
    ring, rring = (ShardMap(["s0", "s1", "s2"]),
                   r_fleet.ShardMap(["s0", "s1", "s2"]))
    got = plan_arrivals(500.0, 300, seed=9, skew=skew, ring=ring,
                        start_id=4)
    want = r_loadgen.plan_arrivals(500.0, 300, seed=9, skew=skew,
                                   ring=rring, start_id=4)
    assert got == want
    assert len({p["inst"] for p in got}) == 300
    specs = [{"tenant": 2, "rate": 50, "instances": 40, "skew": 1.0},
             {"tenant": 1, "rate": 80, "instances": 60}]
    assert plan_tenant_arrivals(specs, 3, ring, start_id=10) == \
        r_loadgen.plan_tenant_arrivals(specs, 3, rring, start_id=10)


def test_payload_value_equals_round_tpus_and_instance_io():
    for value, b in ((13, 96), (0, 1), (4, 1024)):
        v = payload_value(value, b)
        assert v.dtype == np.uint8
        assert np.array_equal(v, r_loadgen.payload_value(value, b))
        assert np.array_equal(
            v, instance_io(_algo("lvb", b), value)["initial_value"])


# -- serving, in-process ------------------------------------------------------

def _fleet(shards, n=3, lanes=8, timeout_ms=1500, **kw):
    servers = {}
    router = FleetRouter(**kw)
    for name in shards:
        srv = DriverServer(_algo("otr"), n=n, lanes=lanes,
                           timeout_ms=timeout_ms, idle_ms=60_000,
                           device="cpu")
        router.add_shard(name, srv.start())
        servers[name] = srv
    return servers, router


def _spy_decisions(router):
    """The (shard, replica, instance) of every FLAG_DECISION frame the
    router handles: a replica streams an instance's decision to its
    proposer right after logging it."""
    streamed = set()
    on_frame = router._on_frame

    def spy(shard, got):
        sender, tag, _raw = got
        if tag.flag == FLAG_DECISION:
            streamed.add((shard, sender, tag.instance))
        on_frame(shard, got)

    router._on_frame = spy
    return streamed


def _await_streams(router, streamed, want, deadline_s):
    """Pump the router until every (shard, replica, instance) of ``want``
    has streamed its decision."""
    t_end = time.monotonic() + deadline_s
    while not want <= streamed and time.monotonic() < t_end:
        router.pump(50)
    assert want <= streamed, sorted(want - streamed)


def _shutdown(servers, router):
    for srv in servers.values():
        srv.stop()
    for srv in servers.values():
        srv.join(60)
    router.close()


def test_fleet_serves_proposed_values_across_shards():
    servers, router = _fleet(["s0", "s1"])
    K = 12
    try:
        for i in range(1, K + 1):
            router.propose(i, 40 + i)
        assert router.drain(90)
        assert router.results == {i: 40 + i for i in range(1, K + 1)}
        assert router.give_ups == 0 and len(router.latency_ms) == K
        rep = open_loop(router, rate=400.0, instances=10, seed=3,
                        start_id=K + 1, deadline_s=90.0)
        assert rep["decided"] == 10 and rep["unresolved"] == 0
        assert rep["p99_ms"] >= rep["p50_ms"] > 0
    finally:
        _shutdown(servers, router)
    # routing followed the ring: each shard served exactly its keys.  The
    # router resolves on the first replica's decision and the shutdown
    # stops a shard as soon as the open loop returns, so a replica one
    # round behind its siblings may not log the last instances: the
    # shard's replicas together logged exactly its keys, and no replica
    # logged a key of the other shard
    for name, srv in servers.items():
        mine = {i for i in range(1, K + 11)
                if router.ring.owner(i) == name}
        logs = [set(r) for r in srv.results]
        assert set().union(*logs) == mine
        assert all(log <= mine for log in logs)


def test_serve_equals_the_scheduled_run():
    """The client-driven serve loop gives the scheduled lane run's log
    for the same instance/value universe (uniform schedule: instance i's
    value is i % 5)."""
    algo, K = _algo("otr"), 8
    ports = alloc_ports(3)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(3)}
    trs = [HostTransport(i, ports[i]) for i in range(3)]
    logs, errs = {}, {}

    def node(i):
        try:
            logs[i] = run_instance_loop_lanes(
                algo, i, peers, trs[i], K, lanes=4, timeout_ms=1500,
                seed=0, value_schedule="uniform", device="cpu")
        except Exception as e:  # noqa: BLE001
            errs[i] = e
        finally:
            trs[i].close()

    ts = [threading.Thread(target=node, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(90)
    assert not errs and len(logs) == 3
    scheduled = {i + 1: logs[0][i] for i in range(K)}
    srv = DriverServer(algo, n=3, lanes=4, timeout_ms=1500, idle_ms=60_000,
                       device="cpu")
    router = FleetRouter()
    streamed = _spy_decisions(router)
    try:
        router.add_shard("s0", srv.start())
        for i in range(1, K + 1):
            router.propose(i, i % 5)
        assert router.drain(90)
        # the router resolves on the first replica's decision: stop the
        # shard only once every replica has logged every instance
        _await_streams(router, streamed,
                       {("s0", j, i) for j in range(3)
                        for i in range(1, K + 1)}, 60)
    finally:
        srv.stop()
        srv.join(60)
        router.close()
    assert router.results == scheduled
    assert srv.results[0] == scheduled


class _StubLink:
    """A router link that records and answers nothing."""

    def __init__(self, n):
        self.n = n
        self.sent = []
        self.pending = []

    def add_peer(self, *a):
        pass

    def send_buffered(self, j, tag, payload=b""):
        self.sent.append((j, tag))

    def flush(self, to=None):
        return 0

    def recv_many(self, timeout_ms):
        out, self.pending = self.pending, []
        return out

    def close(self):
        pass


def test_nack_retry_backoff_and_give_up():
    """A shard that NACKs every proposal: capped-backoff retries, then a
    FleetGiveUp — never silent loss."""
    links = []

    class _NackLink(_StubLink):
        def send_buffered(self, j, tag, payload=b""):
            super().send_buffered(j, tag, payload)
            if tag.flag == FLAG_PROPOSE and j == 0:
                self.pending.append(
                    (0, Tag(instance=tag.instance, flag=FLAG_NACK), b""))

    def factory(n):
        links.append(_NackLink(n))
        return links[-1]

    router = FleetRouter(transport_factory=factory, give_up=4,
                         nack_backoff_ms=1.0, nack_backoff_cap_ms=4.0)
    router.add_shard("s0", [("h", 1)])
    router.propose(7, 3)
    t0 = time.monotonic()
    while 7 not in router.results and time.monotonic() - t0 < 10:
        router.pump(1)
    assert router.results.get(7, "unresolved") is None
    assert router.give_ups == 1 and router.nack_retries == 4
    assert sum(t.flag == FLAG_PROPOSE for _j, t in links[0].sent) == 5
    assert "retry cap" in router.errors[7]
    with pytest.raises(FleetGiveUp):
        router.raise_if_gave_up()


def test_too_late_needs_every_replica_of_the_shard():
    router = FleetRouter(transport_factory=_StubLink)
    router.add_shard("s0", [("h", 1), ("h", 2), ("h", 3)])
    router.propose(4, 9)
    tl = Tag(instance=4, flag=FLAG_TOO_LATE)
    for _ in range(5):  # one replica re-answering every re-ask
        router._on_frame("s0", (0, tl, b""))
    assert 4 not in router.results
    router._on_frame("s0", (1, tl, b""))
    router._on_frame("s0", (2, tl, b""))
    assert router.results[4] is None
    assert router.status()["shards"]["s0"]["too_late"] == 7


def test_view_observer_migrates_a_removed_shards_instances():
    links = []

    def factory(n):
        links.append(_StubLink(n))
        return links[-1]

    router = FleetRouter(transport_factory=factory)
    router.add_shard("alpha", [("h", 1), ("h", 2)])
    router.add_shard("beta", [("h", 3), ("h", 4)])
    for i in range(1, 41):
        router.propose(i, i)
    beta = [i for i in range(1, 41) if router.ring.owner(i) == "beta"]
    names = {0: "alpha", 1: "beta"}
    router.view_observer(names)({0: 0, 1: None}, 1)
    assert router.ring.shards == ["alpha"] and names == {0: "alpha"}
    assert router.migrations == len(beta) > 0
    assert set(beta) <= {t.instance for _j, t in links[0].sent
                         if t.flag == FLAG_PROPOSE}


def test_shed_accounting_holds_through_the_router():
    """A shard starved by a 1-byte admission budget sheds proposals with
    accounted NACKs; the retry loop still lands instances, and
    shed_frames == nacks_sent + nacks_suppressed over its replicas."""
    srv = DriverServer(_algo("otr"), n=3, lanes=2, timeout_ms=1500,
                       idle_ms=60_000, admission_bytes_per_lane=1,
                       shed_deadline_ms=100, device="cpu")
    router = FleetRouter(give_up=40, nack_backoff_ms=20,
                         nack_backoff_cap_ms=200, repropose_ms=500)
    K = 10
    try:
        router.add_shard("s0", srv.start())
        for i in range(1, K + 1):
            router.propose(i, i)
        router.drain(120)
    finally:
        srv.stop()
        srv.join(60)
        router.close()
    assert sum(1 for i in range(1, K + 1)
               if router.results.get(i) is not None) >= 1
    agg = {k: sum(int(st.get(k, 0)) for st in srv.stats)
           for k in ("shed_frames", "nacks_sent", "nacks_suppressed")}
    assert agg["shed_frames"] == agg["nacks_sent"] + agg["nacks_suppressed"]


def test_deadline_shed_purges_the_shed_proposals_stash(monkeypatch):
    """The cause the shed-accounting test met under CPU load, pinned
    with a clock that stands still: a peer's first-round frame for
    instance 1 lands in the stash before this replica admits instance
    1's proposal, so a 1-byte budget defers the proposal, and the
    deadline sheds it.  The shed must purge instance 1's stashed frames,
    as the scheduled loop's shed does: the queued bytes fall to zero,
    shedding ends, and the client's retry is admitted (before the repair
    the stash kept the driver shedding every later proposal)."""
    from round_tpu_torch.runtime import lanes as lanes_mod
    from round_tpu_torch.runtime.instances import AdmissionControl

    clock = [1000.0]
    monkeypatch.setattr(lanes_mod._time, "monotonic", lambda: clock[0])
    ports = alloc_ports(2)
    tr = HostTransport(0, ports[0])
    try:
        driver = LaneDriver(
            _algo("otr"), 0, {0: ("127.0.0.1", ports[0]),
                              1: ("127.0.0.1", ports[1])},
            tr, lanes=2, timeout_ms=200, clients={2},
            admission=AdmissionControl(high_bytes_per_lane=1,
                                       shed_deadline_ms=100),
            device="cpu")
        peer = (1, Tag(instance=1, round=0, flag=FLAG_NORMAL),
                codec.encode(np.int32(3)))
        propose = (2, Tag(instance=1, flag=FLAG_PROPOSE),
                   codec.encode(np.int32(3)))
        driver._ingest(peer)               # start skew: stashed
        driver._ingest(propose)
        assert driver._stash_bytes > 0 and len(driver._proposals) == 1
        assert driver._admission_update()  # the stash trips the budget
        driver._admit_proposals()          # deferred, deadline stamped
        assert len(driver._proposals) == 1
        clock[0] += 0.2                    # past shed_deadline_ms
        driver._admit_proposals()          # deadline-shed, NACK sent
        assert len(driver._proposals) == 0
        assert driver.shed_instances == 1 and driver.nacks_sent == 1
        assert driver._stash_bytes == 0 and 1 not in driver._stash
        assert not driver._admission_update()
        clock[0] += 1.0                    # the client's backoff
        driver._ingest(propose)            # the retry
        driver._admission_update()
        driver._admit_proposals()
        assert driver.table.lane_of(1) is not None
    finally:
        tr.close()


def test_garbage_proposal_refused_and_slot_released():
    ports = alloc_ports(1)
    tr = HostTransport(0, ports[0])
    try:
        driver = LaneDriver(_algo("otr"), 0, {0: ("127.0.0.1", ports[0])},
                            tr, lanes=2, timeout_ms=200, clients={1},
                            device="cpu")
        bad = np.ones((3, 3), dtype=np.float32)
        for iid in (5, 6, 7):
            driver._client_frame(1, Tag(instance=iid, flag=FLAG_PROPOSE),
                                 codec.encode(bad))
        for iid in (0, 0xFF01):  # reserved ids
            driver._client_frame(1, Tag(instance=iid, flag=FLAG_PROPOSE),
                                 codec.encode(np.int32(1)))
        assert len(driver._proposals) == 0 and driver.malformed >= 5
        driver._client_frame(1, Tag(instance=9, flag=FLAG_PROPOSE),
                             codec.encode(np.int32(4)))
        driver._admit_proposals()
        assert driver.table.occupancy == 1
        assert driver.table.lane_of(9) is not None
        # an admission that fails past the boundary releases its slot
        driver._proposals.append(
            (11, {"initial_value": np.ones((2, 2), np.float32)}, 1))
        driver._proposed.add(11)
        driver._admit_proposals()
        assert driver.table.lane_of(11) is None
        assert driver.table.occupancy == 1 and driver.table.can_admit()
    finally:
        tr.close()


# -- the apps -----------------------------------------------------------------

def test_fleet_bench_open_loop_on_two_shard_processes():
    """The deployment shape on the CPU: two shard processes (apps/fleet.py
    serve) under an open-loop plan, every request decided with its own
    value, the shed invariant through the router, and each shard's
    start-up seconds reported."""
    rep = fleet_app.run_fleet_bench(
        drivers=2, rate=60.0, instances=16, n=3, lanes=8, algo="otr",
        warmup=1, deadline_s=60.0, idle_ms=1500, device="cpu")
    ol = rep["open_loop"]
    assert ol["decided"] == 16 and ol["unresolved"] == 0
    assert rep["shed_accounting_ok"]
    assert sorted(rep["startup_s"]) == [0, 1]
    assert all(s > 0 for s in rep["startup_s"].values())
    assert sum(o["decided_instances"] for o in rep["servers"].values()) \
        == 17  # 16 measured + 1 warm-up


def test_bank_and_maybe_fit(tmp_path):
    bank, model = str(tmp_path / "knees.json"), str(tmp_path / "cap.json")
    out = None
    for d, lanes in ((1, 8), (2, 16), (4, 8), (4, 32)):
        out = fleet_app.bank_and_maybe_fit(bank, model, {
            "drivers": d, "lanes": lanes, "payload_bytes": 0,
            "knee_dps": 10.0 * d * lanes ** 0.5})
    assert out["banked"] == 4 and out["fitted"]
    assert abs(out["b_drivers"] - 1.0) < 1e-6
    assert len(json.load(open(bank))) == 4


# The test's name and its parameter ids are historical (these flags once
# exited naming the slice that would bring them); they are kept so that
# each case keeps its identity across versions of the suite.
@pytest.mark.parametrize("flag,extra,clean", [
    pytest.param("--rv", ["log"],
                 {"violations": [], "halted": []}, id="--rv-None"),
    pytest.param("--snap", ["log"],
                 {"violations": [], "halted": []}, id="--snap-None"),
    pytest.param("--kv", ["--algo", "lvb", "--payload-bytes", "64"],
                 {"applied": 0, "reads_lin": 0}, id="--kv-6e"),
])
def test_fleet_serve_later_slice_flags_exit(flag, extra, clean, capsys):
    """``serve --rv``, ``--snap`` and ``--kv`` each serve an idle shard
    and exit 0: runtime verification and the snapshot audit with their
    summary block enabled and clean, the replicated key-value store with
    its kv block enabled and nothing applied or read."""
    ports = alloc_ports(3)
    rc = fleet_app.main(["serve", "--ports", ",".join(map(str, ports)),
                         "--device", "cpu", "--idle-ms", "300", flag]
                        + extra)
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])[flag[2:]]
    assert rc == 0 and summary["enabled"]
    assert {k: summary[k] for k in clean} == clean


# The test's name is historical: the default registry's prover once
# raised, and the test pinned the refusal that followed.
def test_autoscale_bench_needs_a_license_registry():
    """Without an explicit license_registry the bench's default is
    rv/license.py's registry with its default prover (the port's
    verifier_cli, tracing on the bench's device), as round_tpu's is: a
    short overloaded bench at n=4 grows, the grow licensed by the PROVED
    param-otr suite, and no point meets the SLO by shedding."""
    from pathlib import Path

    model = Path(__file__).resolve().parent.parent / "CAPACITY_r03.json"
    rep = fleet_app.run_autoscale_bench(
        algo="otr", n=4, payload_bytes=0, model_path=str(model),
        device="cpu", multipliers=(3.0,), point_s=1.5, warmup=2,
        max_shards=2, deadline_s=20, window_s=0.5, dwell_steps=1,
        cooldown_s=0.2, step_interval_s=0.1)
    assert rep["license_prewarm"]["status"] == "licensed"
    assert rep["license_prewarm"]["suite"] == "param-otr"
    sup = rep["supervisor"]
    assert sup["grows"] >= 1 and sup["refused"] == 0
    grows = [d["license"] for d in sup["decisions"] if d["action"] == "grow"]
    assert grows and all(x["status"] == "licensed"
                         and "param-otr PROVED" in x["reason"]
                         for x in grows)
    assert not rep["slo_met_by_shedding"]
    assert not any(p["slo_met_by_shedding"] for p in rep["points"])
