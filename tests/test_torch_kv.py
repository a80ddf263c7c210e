"""The port's replicated key-value store (round_tpu_torch/kv, the lane
driver's and the fleet's kv paths, apps/loadgen.py's kv workload,
apps/kv.py) against round_tpu's, on the CPU, tolerance 0 (raw bytes and
bits):

  * the record, read and reply bytes and the ``read_tag`` words, both
    ways, with garbage and overflow refused alike;
  * ``KVState``'s tables (data, votes, locks, counters) after the same
    records applied in reordered sequences;
  * the array rider: ``kv_array_apply`` on the same rows, and one
    decided record log replayed through both ``kv_array_machine``s,
    against the host ``KVState``;
  * ``tpc_decide`` on every vote vector of up to 4 participants;
  * the checker's verdicts on the same histories, and an artifact
    written by either package replayed by the other;
  * ``plan_kv_ops`` traces and ``kv_summary`` keys;
  * round_tpu's live in-process ``kv_cluster`` tests on the port at
    ``device="cpu"``: the three read grades, NACK correlation,
    single-shard and cross-shard transactions and the conflicting
    prepare that aborts; and a one-replica loopback shard whose waves
    make the same host copies with kv on as with kv off.

The process-per-shard benches (a clean run and the broken-lease catch)
are ``slow``, as round_tpu marks its own."""

import itertools
import os

import numpy as np
import pytest
import torch

import round_tpu.apps.loadgen as r_loadgen
import round_tpu.kv.lin as r_lin
import round_tpu.kv.reads as r_reads
import round_tpu.kv.store as r_store
import round_tpu.kv.txn as r_txn
from round_tpu_torch.apps import kv as kv_app
from round_tpu_torch.apps.loadgen import plan_kv_ops
from round_tpu_torch.kv import lin as klin
from round_tpu_torch.kv import reads as R
from round_tpu_torch.kv import txn as ktxn
from round_tpu_torch.kv.store import (
    OP_ABORT, OP_COMMIT, OP_PREPARE, OP_PUT, OP_TXN, KVShard, KVState,
    KvConfig, decode_record, encode_record, key_index, kv_array_apply,
    kv_array_machine, value_digest,
)
from round_tpu_torch.models.lastvoting import LastVotingBytes
from round_tpu_torch.runtime.fleet import DriverServer, FleetRouter

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

B = 64  # lvb payload width for every in-process cluster in this file
OPS = (OP_PUT, OP_TXN, OP_PREPARE, OP_COMMIT, OP_ABORT)


def _rand_bytes(rng, lo, hi):
    return bytes(rng.integers(0, 256, int(rng.integers(lo, hi)),
                              dtype=np.uint8))


def _rand_pairs(rng, npairs, klen=8, vlen=8):
    return [(int(rng.integers(0, 1 << 32)), _rand_bytes(rng, 1, klen),
             _rand_bytes(rng, 0, vlen)) for _ in range(npairs)]


# -- record, read and reply bytes ---------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_record_bytes_equal_round_tpus_both_ways(op):
    rng = np.random.default_rng(op)
    for npairs in (1, 2, 5):
        pairs = _rand_pairs(rng, npairs)
        txn = int(rng.integers(0, 1 << 32))
        for keyspace in (64, 4096):
            row = encode_record(op, pairs, 256, txn=txn, keyspace=keyspace)
            want = r_store.encode_record(op, pairs, 256, txn=txn,
                                         keyspace=keyspace)
            assert row.dtype == want.dtype == np.uint8
            assert row.tobytes() == want.tobytes()
            rec = {"op": op, "txn": txn, "pairs": pairs}
            assert decode_record(want) == r_store.decode_record(row) == rec
            kidx = int(row[8]) | int(row[9]) << 8
            assert kidx == key_index(pairs[0][1], keyspace) \
                == r_store.key_index(pairs[0][1], keyspace)
            assert int.from_bytes(row[10:14].tobytes(), "little") \
                == value_digest(pairs[0][2]) \
                == r_store.value_digest(pairs[0][2])


def test_record_garbage_and_overflow_refused_alike():
    rng = np.random.default_rng(11)
    rows = [np.zeros(B, np.uint8), np.zeros(4, np.uint8),
            np.zeros((2, B), np.uint8)]
    good = encode_record(OP_PUT, [(1, b"k", b"v")], B)
    bad_op = good.copy()
    bad_op[1] = 99
    rows.append(bad_op)
    rows.append(encode_record(OP_PUT, [(1, b"k", b"v" * 30)], B)[:20])
    no_pairs = good.copy()
    no_pairs[6] = 0
    rows.append(no_pairs)
    for _ in range(200):
        row = rng.integers(0, 256, int(rng.integers(0, 80)), dtype=np.uint8)
        if row.size:
            row[0] = 0xC5  # past the magic: the body decoder decides
        rows.append(row)
    for row in rows:
        assert decode_record(row) == r_store.decode_record(row)
    for args in (([(1, b"k", b"v" * 60)], B), ([], B),
                 ([(1, b"k" * 256, b"")], 512),
                 ([(1, b"k", b"")] * 256, 4096)):
        for enc in (encode_record, r_store.encode_record):
            with pytest.raises(ValueError):
                enc(OP_PUT, *args)


def test_read_and_reply_bytes_equal_round_tpus_both_ways():
    rng = np.random.default_rng(5)
    for _ in range(50):
        rid = int(rng.integers(0, 1 << 40))
        key = _rand_bytes(rng, 0, 40)
        grade = int(rng.integers(0, 3))
        raw = R.encode_read(rid, key, grade)
        assert raw == r_reads.encode_read(rid, key, grade)
        assert R.decode_read(raw) == r_reads.decode_read(raw) \
            == {"r": rid, "k": key, "g": grade}
        st, seq = int(rng.integers(0, 2)), int(rng.integers(0, 1 << 32))
        val = _rand_bytes(rng, 0, 40)
        rep = R.encode_reply(rid, st, seq, val)
        assert rep == r_reads.encode_reply(rid, st, seq, val)
        assert R.decode_reply(rep) == r_reads.decode_reply(rep)
        assert R.read_tag(rid).pack() == r_reads.read_tag(rid).pack()
    for rid in (0, 1, 0xFFFF, 0x10000, 0x10001):
        assert R.read_tag(rid).pack() == r_reads.read_tag(rid).pack()
    for raw in (b"", b"\x00\x01", b"garbage!", R.encode_reply(1, 0, 2, b"v"),
                R.encode_read(3, b"k", 0)):
        assert R.decode_read(raw) == r_reads.decode_read(raw)
        assert R.decode_reply(raw) == r_reads.decode_reply(raw)
    assert R.combine_lin([(1, b"a"), (3, b"c"), (3, b"d"), (2, b"b")]) \
        == r_reads.combine_lin([(1, b"a"), (3, b"c"), (3, b"d"), (2, b"b")])
    assert [R.majority(n) for n in range(1, 8)] \
        == [r_reads.majority(n) for n in range(1, 8)]


# -- KVState ------------------------------------------------------------------

def _state_tables(st):
    return (st.data, st.txns, st.locks, st.applied, st.txn_commits,
            st.txn_aborts)


def _record_stream(rng, count):
    keys = [b"k%d" % i for i in range(4)]
    recs = []
    for _ in range(count):
        op = int(rng.choice(OPS))
        txn = int(rng.integers(1, 4))
        pairs = [(int(rng.integers(0, 4)), keys[int(rng.integers(0, 4))],
                  _rand_bytes(rng, 0, 3))
                 for _ in range(int(rng.integers(1, 3)))]
        recs.append({"op": op, "txn": txn, "pairs": pairs})
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kvstate_tables_equal_round_tpus_after_reordered_applies(seed):
    rng = np.random.default_rng(seed)
    recs = _record_stream(rng, 12)
    orders = [np.arange(len(recs))] + [rng.permutation(len(recs))
                                       for _ in range(6)]
    for order in orders:
        got, want = KVState(), r_store.KVState()
        for i in order:
            got.apply(recs[i])
            want.apply(recs[i])
        assert _state_tables(got) == _state_tables(want)
        for k in list(got.data) + [ktxn.vote_key(t) for t in range(5)]:
            assert got.get(k) == want.get(k)
    # equal-seq writes converge under every interleave, as round_tpu's
    pairs = [(1, b"k", b"cA1"), (1, b"k", b"cB1"), (2, b"k", b"cA2"),
             (2, b"k", b"cB2")]
    outcomes = set()
    for perm in itertools.permutations(pairs):
        got, want = KVState(), r_store.KVState()
        for p in perm:
            got.apply({"op": OP_PUT, "txn": 0, "pairs": [p]})
            want.apply({"op": OP_PUT, "txn": 0, "pairs": [p]})
        assert got.get(b"k") == want.get(b"k")
        outcomes.add(got.get(b"k"))
    assert len(outcomes) == 1


def test_kvstate_votes_locks_and_idempotence():
    st = KVState()
    st.apply({"op": OP_PREPARE, "txn": 1, "pairs": [(1, b"k", b"v1")]})
    st.apply({"op": OP_PREPARE, "txn": 2, "pairs": [(1, b"k", b"v2")]})
    assert st.get(ktxn.vote_key(1)) == (1, b"y")
    assert st.get(ktxn.vote_key(2)) == (2, b"n")
    assert st.get(ktxn.vote_key(9)) == (0, b"")
    assert st.get(b"k") == (0, b"")
    st.apply({"op": OP_COMMIT, "txn": 1, "pairs": [(1, b"k", b"")]})
    st.apply({"op": OP_COMMIT, "txn": 1, "pairs": [(1, b"k", b"")]})
    assert st.get(b"k") == (1, b"v1") and st.txn_commits == 1
    st.apply({"op": OP_COMMIT, "txn": 2, "pairs": [(1, b"k", b"")]})
    assert st.get(b"k") == (1, b"v1") and st.txn_aborts == 1
    assert st.locks == {}
    assert ktxn.vote_key(7) == r_txn.vote_key(7)


# -- the SMR array rider ------------------------------------------------------

def _rider_rows(rng, count, keyspace, seqs=(1, 2, 3, 4)):
    """PUT rows over a few keys (stale seqs, equal-seq ties, digests
    above 2^31), with non-PUT and non-record rows between them."""
    rows = []
    for i in range(count):
        key = b"k%d" % int(rng.integers(0, 6))
        seq = int(rng.choice(seqs))
        val = _rand_bytes(rng, 0, 6)
        rows.append(encode_record(OP_PUT, [(seq, key, val)], B,
                                  keyspace=keyspace))
        if i % 5 == 2:
            rows.append(encode_record(OP_PREPARE, [(9, key, b"z")], B,
                                      txn=7, keyspace=keyspace))
        if i % 7 == 3:
            rows.append(np.zeros(B, np.uint8))
    return rows


def _host_tables(rows, keyspace):
    host = KVState()
    for row in rows:
        rec = decode_record(row)
        if rec is not None and rec["op"] == OP_PUT:
            host.apply(rec)
    seqs = np.zeros(keyspace, np.int64)
    digs = np.zeros(keyspace, np.int64)
    for key, (seq, val) in host.data.items():
        k = key_index(key, keyspace)
        seqs[k] = seq
        digs[k] = value_digest(val)
    return seqs, digs


def test_kv_array_apply_equals_round_tpus_and_the_host_store():
    import jax.numpy as jnp

    keyspace = 64
    # seqs with the high bit set too: round_tpu assembles the seq in int32
    # shifts, so its rider orders them below seq 0 (its host store does
    # not, a difference no client meets: seqs count up from 1 per key),
    # and the port's rider must order them the same way
    rows = _rider_rows(np.random.default_rng(3), 40, keyspace,
                       seqs=(1, 2, 3, (1 << 31) + 5, (1 << 32) - 1))
    rows += _rider_rows(np.random.default_rng(4), 40, keyspace)
    seqs = torch.zeros(keyspace, dtype=torch.int32)
    digs = torch.zeros(keyspace, dtype=torch.int64)
    jseqs = jnp.zeros(keyspace, jnp.int32)
    jdigs = jnp.zeros(keyspace, jnp.uint32)
    for row in rows:
        seqs, digs = kv_array_apply((seqs, digs), torch.from_numpy(row))
        jseqs, jdigs = r_store.kv_array_apply((jseqs, jdigs),
                                              jnp.asarray(row))
        assert seqs.dtype == torch.int32 and digs.dtype == torch.int64
        assert np.array_equal(seqs.numpy(), np.asarray(jseqs))
        assert np.array_equal(digs.numpy().astype(np.uint32),
                              np.asarray(jdigs))
        assert int(digs.min()) >= 0 and int(digs.max()) < 1 << 32
    # a high-bit seq reads as negative and never wins, in both packages
    assert int(seqs.min()) >= 0
    # from empty tables, the client seqs give the host store's tables
    rows = _rider_rows(np.random.default_rng(5), 40, keyspace)
    seqs = torch.zeros(keyspace, dtype=torch.int32)
    digs = torch.zeros(keyspace, dtype=torch.int64)
    for row in rows:
        seqs, digs = kv_array_apply((seqs, digs), torch.from_numpy(row))
    want_seqs, want_digs = _host_tables(rows, keyspace)
    assert np.array_equal(seqs.numpy(), want_seqs)
    assert np.array_equal(digs.numpy(), want_digs)


def test_kv_array_machine_replays_a_decided_log_like_round_tpus(tmp_path):
    from round_tpu.engine import scenarios as r_scenarios
    from round_tpu_torch.engine import scenarios
    from round_tpu_torch.runtime import checkpoint as ckpt

    keyspace, n = 64, 3
    rows = _rider_rows(np.random.default_rng(8), 10, keyspace)
    m = kv_array_machine(n, scenarios.full(n, device="cpu"),
                         payload_bytes=B, keyspace=keyspace, window=8,
                         device="cpu")
    for row in rows:
        m.propose(row.tolist())
    assert m.run((0, 5)) == len(rows)
    # full delivery, uniform proposals: the decided log IS the records
    assert sorted(m.decided_batches) == list(range(len(rows)))
    for i, row in enumerate(rows):
        assert m.decided_batches[i].tobytes() == row.tobytes()
    seqs, digs = m.apply_decided()
    rm = r_store.kv_array_machine(n, r_scenarios.full(n), payload_bytes=B,
                                  keyspace=keyspace, window=8)
    rm.decided_batches = dict(m.decided_batches)
    rm.next_instance = m.next_instance
    jseqs, jdigs = rm.apply_decided()
    assert np.array_equal(seqs.numpy(), np.asarray(jseqs))
    assert np.array_equal(digs.numpy().astype(np.uint32), np.asarray(jdigs))
    want_seqs, want_digs = _host_tables(rows, keyspace)
    assert np.array_equal(seqs.numpy(), want_seqs)
    assert np.array_equal(digs.numpy(), want_digs)
    # the checkpoint writes the digest table back as uint32
    path = str(tmp_path / "rider")
    m.checkpoint(path)
    state, _step, _meta = ckpt.restore(path, m._checkpoint_like())
    assert state["sm"][1].dtype == np.uint32
    assert np.array_equal(state["sm"][1], np.asarray(jdigs))


# -- transactions -------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_tpc_decide_equals_round_tpus_on_every_vote_vector(k):
    for votes in itertools.product([True, False], repeat=k):
        got = ktxn.tpc_decide(list(votes), device="cpu")
        assert got == r_txn.tpc_decide(list(votes)) == all(votes)


def test_plan_txn_partitions_by_the_ring():
    from round_tpu.runtime.fleet import ShardMap as RShardMap
    from round_tpu_torch.runtime.fleet import ShardMap

    pairs = {b"key%d" % i: b"v%d" % i for i in range(20)}
    got = ktxn.plan_txn(ShardMap(["s0", "s1", "s2"]), pairs)
    assert got == r_txn.plan_txn(RShardMap(["s0", "s1", "s2"]), pairs)


# -- the linearizability checker ----------------------------------------------

def _w(key, seq, t0, t1, ok=True, **kw):
    return {"cl": "c0", "op": "w", "key": key, "seq": seq, "val": "aa",
            "t0": t0, "t1": t1, "ok": ok, **kw}


def _r(key, res_seq, t0, t1, grade="lin", ok=True, **kw):
    return {"cl": "c0", "op": "r", "key": key, "grade": grade, "t0": t0,
            "t1": t1, "ok": ok, "res_seq": res_seq, "res_val": "aa", **kw}


HISTORIES = {
    "empty": [],
    "clean": [_w("6b", 1, 0.0, 1.0), _r("6b", 1, 1.1, 1.2),
              _r("6b", 1, 1.3, 1.4, grade="lease"),
              _r("6b", 0, 1.3, 1.4, grade="stale")],
    "concurrent-old": [_w("6b", 1, 0.0, 1.0), _r("6b", 0, 0.5, 0.6)],
    "concurrent-new": [_w("6b", 1, 0.0, 1.0), _r("6b", 1, 0.5, 0.6)],
    "failed-write": [_w("6b", 1, 0.0, 1.0, ok=False),
                     _r("6b", 1, 1.1, 1.2)],
    "missed-write": [_w("6b", 1, 0.0, 1.0), _r("6b", 0, 1.1, 1.2)],
    "broken-lease": [_w("6b", 1, 0.0, 1.0), _w("6b", 2, 1.1, 2.0),
                     _r("6b", 1, 2.1, 2.2, grade="lease")],
    "stale-superseded": [_w("6b", 1, 0.0, 1.0), _w("6b", 2, 1.1, 2.0),
                         _r("6b", 1, 2.1, 2.2, grade="stale")],
    "stale-future": [_r("6b", 3, 0.0, 0.1, grade="stale"),
                     _w("6b", 3, 1.0, 2.0)],
    "aborted-read": [_w("6b", 1, 0.0, 1.0, ok=False, txn=4, aborted=True),
                     _r("6b", 1, 1.1, 1.2)],
    "phantom-read": [_w("6b", 1, 0.0, 1.0), _r("6b", 7, 1.1, 1.2)],
    "read-before-write": [_r("6b", 1, 0.0, 0.1), _w("6b", 1, 1.0, 2.0)],
    # duplicate write seqs: the Wing & Gong fallback, clean and violating
    "wg-clean": [_w("6b", 1, 0.0, 1.0), _w("6b", 1, 0.5, 1.5),
                 _r("6b", 1, 2.0, 2.1)],
    "wg-violating": [_w("6b", 1, 0.0, 1.0), _w("6b", 1, 1.1, 1.5),
                     _w("6b", 2, 1.6, 1.8), _r("6b", 1, 2.0, 2.1)],
    "two-keys": [_w("6b", 1, 0.0, 1.0), _r("6b", 1, 1.1, 1.2),
                 _w("6c", 1, 0.0, 1.0), _r("6c", 0, 1.1, 1.2)],
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_checker_verdicts_equal_round_tpus(name):
    hist = HISTORIES[name]
    got = klin.check_history(hist)
    assert got == r_lin.check_history(hist)
    assert bool(got) == (name not in (
        "empty", "clean", "concurrent-old", "concurrent-new",
        "failed-write", "stale-superseded", "wg-clean"))


def test_checker_random_histories_equal_round_tpus():
    rng = np.random.default_rng(13)
    for _ in range(40):
        hist, t = [], 0.0
        for _ in range(int(rng.integers(1, 12))):
            t0 = t + float(rng.random())
            t1 = t0 + float(rng.random())
            t = t0
            key = str(int(rng.integers(0, 2)))
            if rng.random() < 0.4:
                hist.append(_w(key, int(rng.integers(1, 6)), t0, t1,
                               ok=bool(rng.random() < 0.8)))
            else:
                hist.append(_r(key, int(rng.integers(0, 6)), t0, t1,
                               grade=str(rng.choice(["lin", "lease",
                                                     "stale"]))))
        assert klin.check_history(hist) == r_lin.check_history(hist)


def test_artifacts_replay_across_packages(tmp_path, capsys):
    hist = HISTORIES["broken-lease"]
    viol = klin.check_history(hist)
    path = klin.dump_history_violation(str(tmp_path / "port"), hist, viol,
                                       meta={"fixture": "unit"})
    rpath = r_lin.dump_history_violation(str(tmp_path / "ref"), hist,
                                         r_lin.check_history(hist),
                                         meta={"fixture": "unit"})
    assert os.path.basename(path) == os.path.basename(rpath)
    for p in (path, rpath):
        art = klin.load_artifact(p)
        assert art["kind"] == "kv-lin" and art["meta"]["kv"]["ops"] == 3
        assert klin.replay_artifact(p) == r_lin.replay_artifact(p)
        assert klin.replay_artifact(p)["matches_expected"]
    # the CLI replays it (exit 0 = the verdict reproduced)
    assert kv_app.main(["check", rpath]) == 0
    assert '"matches_expected": true' in capsys.readouterr().out
    with pytest.raises(ValueError):
        klin.load_artifact(__file__)


# -- the workload and the summary ---------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(rate=100.0, ops=400, seed=0),
    dict(rate=250.0, ops=300, seed=7, keys=16, key_skew=0.0,
         read_frac=0.5, grade_mix=(0.2, 0.6, 0.2)),
    dict(rate=40.0, ops=120, seed=3, keys=200, key_skew=1.3,
         read_frac=1.0, grade_mix=(1, 0, 0), key_prefix=b"user"),
])
def test_plan_kv_ops_equals_round_tpus(kw):
    kw = dict(kw)
    rate, ops, seed = kw.pop("rate"), kw.pop("ops"), kw.pop("seed")
    got = plan_kv_ops(rate, ops, seed, **kw)
    assert got == r_loadgen.plan_kv_ops(rate, ops, seed, **kw)
    assert len(got) == ops


def test_kv_summary_keys_equal_round_tpus():
    from round_tpu.models.lastvoting import LastVotingBytes as RLVB
    from round_tpu.runtime.fleet import DriverServer as RDriverServer

    got = DriverServer(LastVotingBytes(payload_bytes=B), n=3,
                       kv=KvConfig(), device="cpu")
    want = RDriverServer(RLVB(payload_bytes=B), n=3,
                         kv=r_store.KvConfig())
    try:
        assert got.kv_summary() == want.kv_summary()
        assert got.kv_summary()["enabled"]
        # the same replica stats aggregate to the same summary
        for i in range(3):
            st = KVShard(KvConfig(), node=i, n=3, timeout_ms=25)
            st.reads_lin, st.txn_frames = 2 * i + 1, i
            for stats in (got.stats, want.stats):
                st.fill_stats(stats[i])
        assert got.kv_summary() == want.kv_summary()
        assert got.kv_summary()["reads_lin"] == 9
    finally:
        got.join(1.0)
        want.join(1.0)


# -- the lease clock and the read barrier -------------------------------------

def test_lease_refuses_when_the_staleness_bound_starves():
    shard = KVShard(KvConfig(lease_ms=50.0), node=0, n=3, timeout_ms=25)
    assert shard.lease_answer(b"k") is None
    assert shard.lease_refused == 1
    shard.state.apply({"op": OP_PUT, "txn": 0, "pairs": [(4, b"k", b"v")]})
    shard.lease.note_quorum()
    assert shard.lease_answer(b"k") == (4, b"v")
    shard.lease.revoke()
    shard.lease.note_quorum()
    assert shard.lease_answer(b"k") is None


def test_lease_and_vote_reads_wait_behind_pending_writes():
    shard = KVShard(KvConfig(lease_ms=50.0), node=0, n=3, timeout_ms=25)
    shard.state.apply({"op": OP_PUT, "txn": 0,
                       "pairs": [(1, b"k", b"old")]})
    shard.lease.note_quorum()
    assert shard.lease_answer(b"k") == (1, b"old")
    row = encode_record(OP_PUT, [(2, b"k", b"new")], B)
    shard.note_propose(9, row)
    assert shard.lease_answer(b"k") is None and shard.lease_barrier == 1
    shard.on_decision(9, True, row)
    shard.lease.note_quorum()
    assert shard.lease_answer(b"k") == (2, b"new")
    prep = encode_record(OP_PREPARE, [(1, b"q", b"v")], B, txn=6)
    shard.note_propose(4, prep)
    assert shard.barrier_for(ktxn.vote_key(6)) == {4}
    shard.on_decision(4, True, prep)
    assert shard.answer(ktxn.vote_key(6)) == (6, b"y")
    broken = KVShard(KvConfig(broken_lease=True), node=0, n=3,
                     timeout_ms=25)
    broken.state.apply({"op": OP_PUT, "txn": 0,
                        "pairs": [(1, b"k", b"old")]})
    assert broken.lease_answer(b"k") == (1, b"old")
    broken.state.apply({"op": OP_PUT, "txn": 0,
                        "pairs": [(2, b"k", b"new")]})
    assert broken.lease_answer(b"k") == (1, b"old")


# -- the three grades against a live in-process cluster -----------------------

def _kv_server(idle_ms=60_000, max_ms=120_000):
    return DriverServer(LastVotingBytes(payload_bytes=B), n=3, lanes=8,
                        timeout_ms=150, idle_ms=idle_ms, max_ms=max_ms,
                        kv=KvConfig(), device="cpu")


@pytest.fixture(scope="module")
def kv_cluster():
    from round_tpu_torch.kv.client import KVClient

    srv = _kv_server()
    srv.start()
    router = FleetRouter(proto="tcp")
    router.add_shard("s0", srv.replicas)
    cl = KVClient(router, payload_bytes=B, device="cpu")
    yield srv, router, cl
    router.close()
    srv.stop()
    srv.join(30.0)


def test_lin_read_observes_committed_concurrent_write(kv_cluster):
    srv, router, cl = kv_cluster
    cl.put(b"lin-k", b"v1")
    assert cl.drain(30.0)
    cl.read(b"lin-k", R.GRADE_LIN)
    assert cl.drain(20.0)
    op = cl.history[-1]
    assert op["grade"] == "lin" and op["ok"]
    assert op["res_seq"] == 1 and op["res_val"] == b"v1".hex()
    # a write still in flight when the read arrives: the read-index
    # barrier defers the answer behind it
    cl.put(b"lin-k", b"v2")
    cl.read(b"lin-k", R.GRADE_LIN)
    assert cl.drain(30.0)
    reads = [op for op in cl.history
             if op["op"] == "r" and op["key"] == b"lin-k".hex()]
    assert reads[-1]["res_seq"] == 2
    assert klin.check_history(cl.history) == []


def test_lease_read_serves_locally_or_falls_back(kv_cluster):
    srv, router, cl = kv_cluster
    cl.put(b"lease-k", b"lv")
    assert cl.drain(30.0)
    cl.read(b"lease-k", R.GRADE_LEASE)
    assert cl.drain(20.0)
    op = cl.history[-1]
    assert op["ok"] and op["res_seq"] == 1
    assert op["grade"] == ("lease" if not op.get("fallback") else "lin")
    assert cl.lease_served + cl.lease_fallbacks >= 1
    assert klin.check_history(cl.history) == []


def test_stale_read_serves_from_the_decision_bank(kv_cluster):
    srv, router, cl = kv_cluster
    cl.put(b"stale-k", b"sv")
    assert cl.drain(30.0)
    assert cl.read(b"stale-k", R.GRADE_STALE) is None  # completed inline
    op = cl.history[-1]
    assert op["grade"] == "stale" and op["ok"]
    assert op["res_seq"] == 1 and op["res_val"] == b"sv".hex()
    assert cl.read(b"never-written", R.GRADE_STALE) is None
    assert cl.history[-1]["res_seq"] == 0


class _NoWireRouter:
    """A router that fails on any data-plane touch: the stale grade's
    zero-wire-traffic proof (KVClient installs its two reply hooks by
    setattr; everything else is a breach)."""

    def __getattr__(self, name):
        raise AssertionError(f"stale read touched the wire: router.{name}")


def test_stale_read_is_wire_free():
    from round_tpu_torch.kv.client import KVClient

    cl = KVClient(_NoWireRouter(), payload_bytes=B, device="cpu")
    cl.mirror[b"k"] = (3, b"banked")
    assert cl.read(b"k", R.GRADE_STALE) is None
    assert cl.read(b"unknown", R.GRADE_STALE) is None
    seen = [(op["res_seq"], op["res_val"]) for op in cl.history]
    assert seen == [(3, b"banked".hex()), (0, "")]


class _FakeReadRouter:
    """Just enough router for client-side read bookkeeping: records
    sends, never answers."""

    class _Ring:
        def owner_key(self, key):
            return "s0"

    def __init__(self):
        self.ring = self._Ring()
        self.results = {}
        self.sent = []

    def shard_n(self, shard):
        return 3

    def send_read(self, shard, replica, rid, payload, tenant=0):
        self.sent.append((shard, replica, rid))

    def pump(self, timeout_ms=0):
        return 0


def test_read_nack_correlation_survives_rid16_aliasing():
    from round_tpu_torch.kv.client import KVClient

    cl = KVClient(_FakeReadRouter(), payload_bytes=B, device="cpu")
    r1 = cl.read(b"k1", R.GRADE_LIN)
    cl._rid = r1 + 65536
    r2 = cl.read(b"k2", R.GRADE_LIN)
    assert R.read_tag(r1).instance == R.read_tag(r2).instance
    iid = R.read_tag(r1).instance
    cl._complete_read(cl._reads[r1], True, 1, b"v")
    cl._on_read_nack("s0", iid)
    assert cl._reads[r2].next_retry > 0
    cl._complete_read(cl._reads[r2], False)
    assert iid not in cl._rid16
    cl._rid = 65536
    r3 = cl.read(b"k3", R.GRADE_LIN)
    assert R.read_tag(r3).instance == 1
    cl._on_read_nack("s0", 1)
    assert cl._reads[r3].next_retry > 0


def test_nack_backoff_only_touches_the_shedding_shard():
    from round_tpu_torch.kv.client import KVClient

    cl = KVClient(_FakeReadRouter(), payload_bytes=B, device="cpu")
    r1 = cl.read(b"k1", R.GRADE_LIN, shard="s0")
    cl._rid = r1 + 65536
    r2 = cl.read(b"k2", R.GRADE_LIN, shard="s1")
    cl._on_read_nack("s1", R.read_tag(r1).instance)
    assert cl._reads[r1].next_retry == 0.0
    assert cl._reads[r2].next_retry > 0


def test_single_shard_txn_commits_atomically(kv_cluster):
    srv, router, cl = kv_cluster
    res = cl.txn({b"txn-a": b"1", b"txn-b": b"2"}, deadline_s=30.0)
    assert res["committed"] and res["shards"] == 1
    for key, val in ((b"txn-a", b"1"), (b"txn-b", b"2")):
        cl.read(key, R.GRADE_LIN)
        assert cl.drain(20.0)
        assert cl.history[-1]["res_val"] == val.hex()
    assert klin.check_history(cl.history) == []


def test_txn_verb_refuses_a_plain_record(kv_cluster):
    """FLAG_TXN is PROPOSE plus record validation: a PUT record on the
    txn verb is refused with the give-up signal (undecided at the
    router), and the shard counts no txn frame for it."""
    srv, router, cl = kv_cluster
    inst = cl._alloc_inst()
    router.propose(inst, encode_record(OP_PUT, [(1, b"tv", b"x")], B),
                   shard="s0", txn=True)
    assert cl._wait_insts([inst], 20.0) is False
    assert router.results[inst] is None


@pytest.fixture(scope="module")
def kv_cluster2():
    """A two-shard in-process cluster: the cross-shard 2PC arm."""
    from round_tpu_torch.kv.client import KVClient

    srvs = [_kv_server() for _ in range(2)]
    for s in srvs:
        s.start()
    router = FleetRouter(proto="tcp")
    for i, s in enumerate(srvs):
        router.add_shard(f"s{i}", s.replicas)
    cl = KVClient(router, payload_bytes=B, device="cpu")
    yield srvs, router, cl
    router.close()
    for s in srvs:
        s.stop()
        s.join(30.0)


def _key_on(ring, shard: str, prefix: str) -> bytes:
    for i in range(4096):
        k = f"{prefix}{i}".encode()
        if ring.owner_key(k) == shard:
            return k
    raise AssertionError(f"no {prefix}* key hashes to {shard}")


def test_cross_shard_txn_commits_end_to_end(kv_cluster2):
    srvs, router, cl = kv_cluster2
    ka = _key_on(router.ring, "s0", "xa")
    kb = _key_on(router.ring, "s1", "xb")
    res = cl.txn({ka: b"A1", kb: b"B1"}, deadline_s=60.0)
    assert res["committed"] and res["shards"] == 2
    for key, val in ((ka, b"A1"), (kb, b"B1")):
        cl.read(key, R.GRADE_LIN)
        assert cl.drain(30.0)
        assert cl.history[-1]["ok"]
        assert cl.history[-1]["res_val"] == val.hex()
    assert klin.check_history(cl.history) == []


def test_cross_shard_txn_conflicting_prepare_aborts_atomically(
        kv_cluster2):
    srvs, router, cl = kv_cluster2
    ka = _key_on(router.ring, "s0", "ya")
    kb = _key_on(router.ring, "s1", "yb")
    assert cl.txn({ka: b"A1", kb: b"B1"}, deadline_s=60.0)["committed"]
    blocker = 9001
    prep = encode_record(OP_PREPARE, [(99, ka, b"blk")], B, txn=blocker)
    inst = cl._alloc_inst()
    router.propose(inst, prep, shard="s0", txn=True)
    assert cl._wait_insts([inst], 30.0)
    assert not cl.txn({ka: b"A2", kb: b"B2"}, deadline_s=60.0)["committed"]
    for key, val in ((ka, b"A1"), (kb, b"B1")):
        cl.read(key, R.GRADE_LIN)
        assert cl.drain(30.0)
        assert cl.history[-1]["res_val"] == val.hex()
    ab = encode_record(OP_ABORT, [(99, ka, b"")], B, txn=blocker)
    inst = cl._alloc_inst()
    router.propose(inst, ab, shard="s0", txn=True)
    assert cl._wait_insts([inst], 30.0)
    assert cl.txn({ka: b"A3", kb: b"B3"}, deadline_s=60.0)["committed"]
    for key, val in ((ka, b"A3"), (kb, b"B3")):
        cl.read(key, R.GRADE_LIN)
        assert cl.drain(30.0)
        assert cl.history[-1]["res_val"] == val.hex()
    assert klin.check_history(cl.history) == []
    # every replica of a shard holds one store: the same tables
    for s in srvs:
        assert s.kv is not None


def test_kv_summary_counts_the_traffic():
    from round_tpu_torch.kv.client import KVClient

    srv = _kv_server(idle_ms=30_000, max_ms=60_000)
    srv.start()
    router = FleetRouter(proto="tcp")
    router.add_shard("s0", srv.replicas)
    cl = KVClient(router, payload_bytes=B, device="cpu")
    try:
        cl.put(b"sum-k", b"v")
        assert cl.drain(30.0)
        cl.read(b"sum-k", R.GRADE_LIN)
        assert cl.drain(20.0)
        assert cl.txn({b"sum-a": b"1", b"sum-b": b"2"},
                      deadline_s=30.0)["committed"]
    finally:
        router.close()
        srv.stop()
        srv.join(30.0)
    s = srv.kv_summary()
    assert s["enabled"]
    assert s["applied"] > 0 and s["reads_lin"] > 0
    assert s["txn_frames"] > 0 and s["txn_commits"] > 0


def _loopback_copies(kv: bool, writes: int = 6):
    """A one-replica shard on the CPU serving ``writes`` records one at a
    time (each drained before the next, so every wave has one lane): the
    log, and the host copies and update waves it took."""
    from round_tpu_torch.kv.client import KVClient
    from round_tpu_torch.obs.metrics import METRICS

    names = ("lanes.update_dispatches", "host.d2h_copies",
             "host.h2d_copies")
    srv = DriverServer(LastVotingBytes(payload_bytes=B), n=1, lanes=4,
                       timeout_ms=150, idle_ms=30_000, max_ms=60_000,
                       kv=KvConfig() if kv else None, device="cpu")
    srv.start()
    router = FleetRouter(proto="tcp")
    router.add_shard("s0", srv.replicas)
    cl = KVClient(router, payload_bytes=B, device="cpu")
    try:
        c0 = [METRICS.counter(k).value for k in names]
        for i in range(writes):
            rec = encode_record(OP_PUT, [(i + 1, b"lb", b"v%d" % i)], B)
            router.propose(i + 1, rec, shard="s0")
            assert cl._wait_insts([i + 1], 30.0)
            if kv:
                # reads cost no copy: answered from the host store
                cl.read(b"lb", R.GRADE_LIN)
                cl.read(b"lb", R.GRADE_LEASE)
                assert cl.drain(20.0)
        d = {k: METRICS.counter(k).value - v for k, v in zip(names, c0)}
    finally:
        router.close()
        srv.stop()
        srv.join(30.0)
    return dict(srv.results[0]), d, srv.kv_summary()


def test_kv_adds_no_host_copy_to_a_lane_wave():
    log_off, d_off, _ = _loopback_copies(False)
    log_on, d_on, s = _loopback_copies(True)
    assert log_on == log_off and len(log_on) == 6
    assert d_on == d_off and d_on["lanes.update_dispatches"] > 0
    assert s["applied"] == 6 and s["reads_lin"] == 6


# -- the capacity model's read axes and the fuzz arm --------------------------

def test_capacity_fit_read_axes_equal_round_tpus():
    from round_tpu.runtime.capacity import fit_capacity as r_fit
    from round_tpu_torch.runtime.capacity import fit_capacity

    base = dict(drivers=2, lanes=16, payload_bytes=256)
    samples = [
        {**base, "knee_dps": 100.0},
        {**base, "knee_dps": 210.0, "read_frac": 0.5, "lease_frac": 0.2},
        {**base, "knee_dps": 420.0, "read_frac": 0.9, "lease_frac": 0.5},
        {**base, "knee_dps": 300.0, "read_frac": 0.9, "lease_frac": 0.1},
    ]
    got, want = fit_capacity(samples), r_fit(samples)
    assert got.to_json() == want.to_json()
    assert got.b_read > 0 and got.b_lease > 0
    assert got.predict_dps(2, 16, 256, read_frac=0.9, lease_frac=0.5) \
        == want.predict_dps(2, 16, 256, read_frac=0.9, lease_frac=0.5)


_KV_REC = 2  # the uniformly-proposed record token (engine value domain)


def _kv_fuzz_target(seed=5):
    from round_tpu_torch.fuzz.search import make_target

    return make_target("lastvoting", n=4, horizon=12, seed=seed,
                       values=np.full(4, _KV_REC, dtype=np.int32),
                       device="cpu")


def test_fuzz_smoke_kv_stream_invariant_holds_in_envelope():
    """Benign fault schedules never make a decided lane apply anything
    but the uniformly-proposed record — the engine-level root of the KV
    serving contract (round_tpu's tier-1 smoke, on the port)."""
    from round_tpu_torch.fuzz.objectives import kv_stream_violated
    from round_tpu_torch.fuzz.search import search

    t = _kv_fuzz_target()
    pred = kv_stream_violated(_KV_REC)
    res = search(t, pop_size=64, generations=2, seed=5, stop_when=pred)
    assert res.evaluated == 128          # no early stop = no violation
    assert res.best_outcome["validity_viol"] == 0
    assert res.best_outcome["agreement_viol"] == 0


@pytest.mark.fuzz
@pytest.mark.slow
def test_fuzz_kv_stream_sweep_and_counterexample(tmp_path):
    """>= 4k in-envelope schedules with the invariant intact; one value
    liar past the envelope yields a phantom apply, minimized and banked
    as a schedule artifact whose engine replay reproduces bit-exact."""
    from round_tpu_torch.byz.crosscheck import liar_rows
    from round_tpu_torch.fuzz import minimize as fmin, replay as freplay
    from round_tpu_torch.fuzz.objectives import kv_stream_violated
    from round_tpu_torch.fuzz.search import search

    t = _kv_fuzz_target()
    pred = kv_stream_violated(_KV_REC)
    res = search(t, pop_size=512, generations=8, seed=5, stop_when=pred,
                 time_box_s=180.0)
    assert res.evaluated >= 4000 or res.generations < 8
    assert res.best_outcome["validity_viol"] == 0
    assert res.best_outcome["agreement_viol"] == 0
    seeds = liar_rows(4, t.horizon, 1, seed=5)
    res2 = search(t, pop_size=256, generations=12, seed=7,
                  stop_when=pred, value_cap=1, seed_rows=seeds,
                  time_box_s=180.0)
    assert pred(res2.outcome).any(), "one value liar must phantom-apply"
    mr = fmin.minimize(t, res2.best_row, pred)
    art = freplay.make_artifact(
        protocol=t.name, schedule=mr.schedule, values=t.init_values,
        seed=t.seed, value_plan=mr.value_plan,
        meta={"objective": pred.__name__})
    art["expected"]["engine"] = freplay.replay_engine(art, device="cpu")
    path = str(tmp_path / "kv-stream-counterexample.json")
    freplay.dump_artifact(path, art)
    ok, got = freplay.check_engine(freplay.load_artifact(path),
                                   device="cpu")
    assert ok, got


# -- the apps -----------------------------------------------------------------

def test_kv_serve_delegates_to_a_kv_fleet_shard(capsys):
    import json

    from round_tpu_torch.runtime.chaos import alloc_ports

    ports = alloc_ports(3)
    rc = kv_app.main(["serve", "--ports", ",".join(map(str, ports)),
                      "--device", "cpu", "--idle-ms", "300",
                      "--payload-bytes", str(B)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["kv"]["enabled"]
    assert summary["kv"]["applied"] == 0


@pytest.mark.slow
def test_kv_fleet_clean_run_serves_all_grades():
    rep = kv_app.run_kv_bench(shards=2, n=3, lanes=16, rate=150.0,
                              ops=1000, payload_bytes=256, timeout_ms=150,
                              seed=3, deadline_s=240.0, device="cpu")
    assert rep["lin_ok"], rep["violations"]
    assert rep["checked_ops"] >= 1000 and rep["shed_accounting_ok"]
    ol = rep["open_loop"]
    assert ol["give_ups"] == 0 and ol["lease_served"] > 0
    g = ol["read_grades"]
    assert all(g[name]["count"] > 0 for name in ("lin", "lease", "stale"))
    for srv in rep["servers"].values():
        assert srv["kv"]["enabled"] and srv["kv"]["applied"] > 0


@pytest.mark.slow
def test_kv_fleet_broken_lease_is_caught_with_artifact(tmp_path):
    rep = kv_app.run_kv_bench(shards=2, n=3, lanes=16, rate=100.0, ops=400,
                              payload_bytes=256, timeout_ms=150, seed=7,
                              keys=16, grade_mix=(0.2, 0.6, 0.2),
                              broken_lease=True, dump_dir=str(tmp_path),
                              deadline_s=240.0, device="cpu")
    assert not rep["lin_ok"]
    assert any(v["kind"] in ("non-linearizable", "stale-read-uncommitted")
               for v in rep["violations"])
    assert rep["artifact"] and os.path.exists(rep["artifact"])
    assert klin.replay_artifact(rep["artifact"])["matches_expected"]
    assert r_lin.replay_artifact(rep["artifact"])["matches_expected"]
