"""Round-consistent snapshots in the port (round_tpu_torch/snap) against
round_tpu's, on the CPU: the audit program and its verdicts on the same
seeded cuts equal round_tpu's AuditProgram and the eager ``check_cut``
at tolerance 0; samples, digests and banked cuts written by one package
load in the other; a lane cluster on the broken-conservation fixture is
caught by the collector while the rv monitors stay silent, and a clean
one audits cuts with decision logs unchanged."""

import functools
import os
import threading

import numpy as np
import pytest
import torch

import round_tpu.apps.selector as r_sel
import round_tpu.snap.audit as r_audit
import round_tpu.snap.collect as r_collect
import round_tpu.snap.sample as r_sample
from round_tpu_torch.apps import snap_cli
from round_tpu_torch.apps.selector import select
from round_tpu_torch.runtime import host
from round_tpu_torch.runtime.chaos import alloc_ports
from round_tpu_torch.runtime.lanes import run_instance_loop_lanes
from round_tpu_torch.runtime.transport import HostTransport
from round_tpu_torch.rv.dump import RvConfig
from round_tpu_torch.snap import audit, collect, sample
from round_tpu_torch.snap.audit import SnapConfig
from round_tpu_torch.spec.check import check_cut
from round_tpu_torch.utils.tree import tree_unflatten

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

N = 4


@functools.lru_cache(maxsize=None)
def _algo(name):
    return select(name)


@pytest.mark.parametrize("name", ["otr", "lv", "lvb", "benor", "kset",
                                  "snap-broken-conservation"])
def test_audit_program_equals_round_tpus(name):
    got = audit.audit_program(select(name), N, device="cpu")
    want = r_audit.audit_program(r_sel.select(name), N)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got.labels == want.labels
    assert got.needs_init == want.needs_init
    assert sorted(got.skipped) == sorted(want.skipped)
    assert got.n_leaves == want.n_leaves


def _cuts(algo, rng, C):
    """C seeded [n, ...] OTR-shaped global states (x, decided, decision,
    after) from small domains, each with its proposal row and round."""
    states, values, rounds = [], [], []
    for _ in range(C):
        vals = rng.integers(0, 5, N)
        x = np.where(rng.random(N) < 0.7, vals[rng.integers(0, N, N)],
                     rng.integers(0, 12, N)).astype(np.int32)
        decided = rng.random(N) < 0.5
        decision = np.where(decided, x[rng.integers(0, N)]
                            if rng.random() < 0.7
                            else rng.integers(0, 6, N), -1).astype(np.int32)
        after = rng.integers(0, 3, N).astype(np.int32)
        states.append([x, decided, decision, after])
        values.append(vals.astype(np.int64))
        rounds.append(int(rng.integers(0, 9)))
    return states, values, rounds


@pytest.mark.parametrize("name", ["otr", "snap-broken-conservation"])
def test_audit_verdicts_equal_round_tpus_and_check_cut(name):
    """The batched evaluator on 37 seeded cuts (padded to 64) gives
    round_tpu's verdicts bit for bit, and each cut's verdicts equal the
    eager ``check_cut`` on that cut."""
    prog = audit.audit_program(_algo(name), N, device="cpu")
    rprog = r_audit.audit_program(r_sel.select(name), N)
    rng = np.random.default_rng(3)
    states, values, rounds = _cuts(_algo(name), rng, 37)
    leaves_order = [f for f in ("x", "decided", "decision", "after")]
    assert prog.n_leaves == len(leaves_order)
    inits = [prog.init_rows(v) for v in values]
    rinits = [rprog.init_rows(v) for v in values]
    for a, b in zip(inits, rinits):
        assert all(np.array_equal(x, np.asarray(y)) for x, y in zip(a, b))
    got = prog.check_batch(states, inits, rounds)
    want = rprog.check_batch(states, rinits, rounds)
    assert got.dtype == np.bool_ and np.array_equal(got, np.asarray(want))
    assert not got.all() and got.any()
    for c in range(len(states)):
        st = tree_unflatten([torch.from_numpy(x) for x in states[c]],
                            prog.treedef)
        init = tree_unflatten([torch.from_numpy(x) for x in inits[c]],
                              prog.treedef)
        eager = check_cut(_algo(name).spec, st, N, rounds[c], init0=init,
                          rounds_per_phase=prog.rounds_per_phase)
        assert [eager[lab] for lab in prog.labels] == list(got[c]), c


def test_samples_and_cuts_cross_the_packages(tmp_path):
    """A sample encoded by either package decodes in the other with the
    same rows and digest (the ``blob_digest`` bytes are equal); a cut
    banked by either package loads in the other; the sampling phase is
    round_tpu's."""
    rng = np.random.default_rng(7)
    leaves = [rng.integers(0, 9, ()).astype(np.int32), np.bool_(True),
              rng.integers(0, 9, (3,)).astype(np.int64)]
    for enc_mod, dec_mod in ((sample, r_sample), (r_sample, sample)):
        blob = enc_mod.state_blob(leaves)
        assert blob == (r_sample if enc_mod is sample
                        else sample).state_blob(leaves)
        payload = enc_mod.encode_sample(2, blob, [1, 2, 3, 4],
                                        enc_mod.blob_digest(blob))
        got = dec_mod.decode_sample(payload)
        assert got["node"] == 2 and got["digest"] == \
            dec_mod.blob_digest(blob) == sample.state_digest(leaves)
        assert all(np.array_equal(a, b) and a.shape == np.shape(b)
                   for a, b in zip(got["state"], leaves))
    assert [sample.sample_jitter(i, 5, 4) for i in range(64)] == \
        [r_sample.sample_jitter(i, 5, 4) for i in range(64)]
    states, values, _ = _cuts(_algo("otr"), rng, 1)
    for mod, other in ((collect, r_collect), (r_collect, collect)):
        cut = mod.Cut(epoch=1, inst=9, round=4, n=N, state=states[0],
                      present=np.array([True, True, False, True]),
                      digests=[b"\1" * 16, b"\2" * 16, None, b"\3" * 16],
                      values=values[0], wall=12.5)
        d = tmp_path / mod.__name__.split(".")[0]
        path = mod.bank_cut(str(d), cut, protocol="otr")
        back, proto = other.load_cut(path)
        assert proto == "otr" and back.missing == 1
        assert (back.epoch, back.inst, back.round, back.n) == (1, 9, 4, N)
        assert back.digests == cut.digests
        assert all(np.array_equal(a, b) for a, b in zip(back.state,
                                                          cut.state))


def _cluster(name, snap, rv=None, n=3, instances=3, lanes=3):
    algo = _algo(name)
    ports = alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    trs = [HostTransport(i, ports[i]) for i in range(n)]
    logs, stats, errors = {}, {}, {}

    def node(i):
        st: dict = {}
        try:
            logs[i] = run_instance_loop_lanes(
                algo, i, peers, trs[i], instances, lanes=lanes,
                timeout_ms=2000, seed=7, max_rounds=8, stats_out=st,
                snap=snap, rv=rv, device="cpu")
        except Exception as e:  # noqa: BLE001 — asserted below
            errors[i] = e
        finally:
            stats[i] = st
            trs[i].close()

    threads = [threading.Thread(target=node, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=150)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return logs, stats


def test_broken_conservation_caught_by_the_collector(tmp_path):
    """Every estimate turns into a value nobody proposed and nobody
    decides: the rv monitors stay silent, the collector's audit trips
    the invariant chain, banks its cuts, and ``snap_cli audit`` on the
    bank exits 1 with the same formula."""
    bank = str(tmp_path / "bank")
    snap = SnapConfig(policy="log", protocol="snap-broken-conservation",
                      dump_dir=str(tmp_path / "dumps"), every_k=1,
                      bank_dir=bank, bank_engine=False)
    logs, stats = _cluster("snap-broken-conservation", snap,
                           rv=RvConfig(policy="log"))
    assert all(all(d is None for d in log) for log in logs.values())
    assert all(st["rv_violations"] == [] for st in stats.values())
    col = stats[0]
    assert col["snap_cuts_audited"] > 0
    assert {v["formula"] for v in col["snap_violations"]} == \
        {"invariants (chain)"}
    assert col.get("snap_divergences", []) == []
    assert all(stats[i].get("snap_samples", 0) > 0 for i in range(3))
    assert snap_cli.main(["audit", bank, "--device", "cpu"]) == 1


def test_clean_cluster_audits_with_logs_unchanged():
    """OTR with every round sampled: cuts assemble and audit clean, and
    the decision logs equal a snapshots-off run's."""
    off, _ = _cluster("otr", None)
    on, stats = _cluster("otr", SnapConfig(policy="log", every_k=1))
    assert on == off and all(d is not None for d in on[0])
    assert stats[0]["snap_cuts_audited"] > 0
    assert stats[0]["snap_violations"] == []
    assert stats[0].get("snap_divergences", []) == []
