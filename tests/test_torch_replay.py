"""Schedule artifacts in the port (round_tpu_torch/fuzz/replay.py) against
round_tpu's, on the CPU: every banked artifact in tests/regressions/
replays bit for bit through the port's engine (and equals round_tpu's
replay of it), artifacts written by either package load in the other
with the same bytes, ``FaultyTransport.from_schedule_file`` builds
round_tpu's transport, and the host-wire replay of the all-undecided
artifact reproduces its recorded outcome."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import round_tpu.runtime.chaos as r_chaos
from round_tpu.fuzz import replay as r_replay
from round_tpu_torch.apps import fuzz_cli
from round_tpu_torch.fuzz import replay
from round_tpu_torch.runtime import chaos

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = sorted(glob.glob(os.path.join(HERE, "regressions", "*.json")))
_IDS = [os.path.basename(p)[:-5] for p in ARTIFACTS]


def test_bank_is_there():
    assert len(ARTIFACTS) >= 4


@pytest.mark.parametrize("path", ARTIFACTS, ids=_IDS)
def test_banked_artifact_replays_on_the_ports_engine(path):
    """check_engine on the port's batched evaluator reproduces the
    recorded expected.engine exactly, equals round_tpu's replay, and
    ``fuzz_cli replay`` exits 0 on it."""
    art = replay.load_artifact(path)
    ok, got = replay.check_engine(art, device="cpu")
    assert ok, (got, art["expected"]["engine"])
    assert got == r_replay.replay_engine(r_replay.load_artifact(path))
    assert fuzz_cli.main(["replay", "--artifact", path,
                          "--device", "cpu"]) == 0


def _plan(rng, T, n, p):
    plan = np.full((T, n, n), -1, dtype=np.int32)
    for r in range(T):
        for d in range(n):
            for s in range(n):
                if d != s and rng.random() < p:
                    plan[r, d, s] = int(rng.integers(0, 4)) \
                        if rng.random() < 0.7 else -2
    return plan


@pytest.mark.parametrize("version", [1, 2])
def test_artifacts_round_trip_between_the_packages(version, tmp_path):
    """The same schedule (and, for v2, value plan) made into an artifact
    by each package: equal documents, byte-equal files; a file written by
    one loads in the other to the same schedule and value plan."""
    rng = np.random.default_rng(version)
    T, n = 8, 4
    sched = rng.random((T, n, n)) < 0.8
    sched[:, np.eye(n, dtype=bool)] = True
    vplan = _plan(rng, T, n, 0.1) if version == 2 else None
    kw = dict(protocol="otr", schedule=sched, values=np.arange(n) % 3,
              seed=5, value_plan=vplan, meta={"source": "test"})
    mine, theirs = replay.make_artifact(**kw), r_replay.make_artifact(**kw)
    assert mine == theirs and mine["version"] == version
    pa, pb = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    replay.dump_artifact(pa, mine)
    r_replay.dump_artifact(pb, theirs)
    assert open(pa, "rb").read() == open(pb, "rb").read()
    for load, path in ((r_replay.load_artifact, pa),
                       (replay.load_artifact, pb)):
        art = load(path)
        assert np.array_equal(replay.schedule_from_artifact(art), sched)
        got = replay.value_plan_from_artifact(art)
        assert (got is None) == (vplan is None)
        if vplan is not None:
            assert np.array_equal(got, vplan)
            assert np.array_equal(
                got, r_replay.value_plan_from_artifact(art))
    bad = dict(mine, kind="something.else")
    with pytest.raises(ValueError):
        replay.dump_artifact(str(tmp_path / "bad.json"), bad)


@pytest.mark.parametrize("path", ARTIFACTS, ids=_IDS)
def test_faulty_transport_from_schedule_file(path):
    """The explicit-schedule transport the port builds from an artifact
    is round_tpu's: group size, seed, deliver schedule, value plan,
    protocol and phase length."""
    class Inner:
        dropped = 0

    got = chaos.FaultyTransport.from_schedule_file(Inner(), path)
    want = r_chaos.FaultyTransport.from_schedule_file(Inner(), path)
    assert got.n == want.n
    assert got.plan.seed == want.plan.seed
    assert np.array_equal(got.schedule, want.schedule)
    assert (got.value_plan is None) == (want.value_plan is None)
    if got.value_plan is not None:
        assert np.array_equal(got.value_plan, want.value_plan)
        assert got.protocol == want.protocol
        assert got._rpp == want._rpp


def test_host_thread_replay_reproduces_the_recorded_outcome():
    """The all-undecided artifact replays on real sockets in four port
    replica threads to its recorded host outcome, decisions and rounds.
    Every replica's socket is bound before any replica starts
    (replay_host_threads): a round-0 frame sent to a peer still binding
    was lost, a delivery the schedule keeps, and that moved OTR's values
    together so that two replicas decided."""
    path = next(p for p in ARTIFACTS
                if os.path.basename(p) == "otr_undecided_horizon.json")
    art = replay.load_artifact(path)
    ok, got = replay.check_host(art, timeout_ms=400, device="cpu")
    assert ok, (got, art["expected"]["host"])
    out = json.loads(json.dumps(got))
    assert out["rounds"] == [art["rounds"]] * art["n"]


def test_host_thread_replay_holds_with_replicas_slow_to_bind(monkeypatch):
    """Replicas whose sockets take 100-200 ms to bind still replay the
    all-undecided artifact to its recorded outcome: every socket is bound
    before any replica starts.  Were each bound in its replica's thread,
    replica 0's round-0 frames would meet peers not yet listening and be
    lost (deliveries the schedule keeps); replica 3 would then hear only
    replicas 1 and 2, take their minimum value, and two replicas would
    decide."""
    import time

    from round_tpu_torch.runtime import transport

    bind_delay_s = {1: 0.2, 2: 0.2, 3: 0.1}

    class SlowToBind(transport.HostTransport):
        def __init__(self, node_id, *args, **kwargs):
            time.sleep(bind_delay_s.get(node_id, 0.0))
            super().__init__(node_id, *args, **kwargs)

    monkeypatch.setattr(transport, "HostTransport", SlowToBind)
    path = next(p for p in ARTIFACTS
                if os.path.basename(p) == "otr_undecided_horizon.json")
    art = replay.load_artifact(path)
    ok, got = replay.check_host(art, timeout_ms=400, device="cpu")
    assert ok, (got, art["expected"]["host"])
