"""Port parity of the in-process runtime's device half (round_tpu_torch/
runtime: instances, smr; the membership and directory flows around them).

Each test of tests/test_runtime.py runs here through both packages on the
same inputs and compares the outputs (tolerance 0: values, arrays with
their dtypes, decision-log digests).  Beside them: the pool's decision logs
for OTR and LastVoting under the key-free samplers (``full``,
``from_schedule``, ``from_mix_row`` of a hash-mode mix), the batched window
against ``run_instance`` on ``instance_key(key, iid)`` for a keyed
``omission`` sampler, and SMR applied states and digests under drops.

Keys: round_tpu's ``PRNGKey(k)`` is the port's ``(0, k)``; key-free
samplers make the two packages' runs comparable whatever the key.  A
window is one batched program: torch's vmap fallback warning (an op with
no batching rule run as a Python loop) is an error in every test here."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.engine import scenarios as jscen
from round_tpu.models import LastVoting as JLastVoting
from round_tpu.models import OTR as JOTR
from round_tpu.models import consensus_io as jio
from round_tpu.runtime import Directory as JDirectory
from round_tpu.runtime import Group as JGroup
from round_tpu.runtime import InstancePool as JPool
from round_tpu.runtime import Replica as JReplica
from round_tpu.runtime import ReplicatedStateMachine as JRSM
from round_tpu.runtime.decisions import DecisionLog as JDecisionLog
from round_tpu.runtime.membership import local_group as jlocal_group
from round_tpu_torch import interop
from round_tpu_torch.engine import executor as texec
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.models.benor import BenOr as TBenOr
from round_tpu_torch.models.common import consensus_io as tio
from round_tpu_torch.models.lastvoting import LastVoting as TLastVoting
from round_tpu_torch.models.otr import OTR as TOTR
from round_tpu_torch.runtime import Directory as TDirectory
from round_tpu_torch.runtime import Group as TGroup
from round_tpu_torch.runtime import InstancePool as _TPool
from round_tpu_torch.runtime import Replica as TReplica
from round_tpu_torch.runtime import ReplicatedStateMachine as _TRSM
from round_tpu_torch.runtime.decisions import DecisionLog as TDecisionLog
from round_tpu_torch.runtime.instances import instance_key, window_masks
from round_tpu_torch.runtime.membership import local_group as tlocal_group

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")


@pytest.fixture(autouse=True)
def no_vmap_fallback():
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*")
        yield


def TPool(*a, **kw):
    return _TPool(*a, device=CPU, **kw)


def TRSM(*a, **kw):
    return _TRSM(*a, device=CPU, **kw)


def _same_result(t, j):
    assert t.instance_id == j.instance_id
    for f in ("decided", "decision", "decided_round"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a, b)
        assert np.array_equal(a, b), (t.instance_id, f, a, b)
    if j.value is None:
        assert t.value is None
    else:
        assert np.array_equal(np.asarray(t.value), np.asarray(j.value))
        assert np.asarray(t.value).dtype == np.asarray(j.value).dtype


def _same_results(tres, jres):
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        _same_result(t, j)


def _log_of(results, cls):
    log = cls()
    for res in results:
        if res.value is not None:
            rnd = int(res.decided_round[np.asarray(res.decided).argmax()])
            assert log.record(res.instance_id, rnd, int(res.value))
    return log


# -- the tests of tests/test_runtime.py, through both packages ---------------


def test_instance_pool_multiplexes_and_logs():
    n = 4
    jp = JPool(JOTR(), n, jscen.full(n), max_phases=4, window=3)
    tp = TPool(TOTR(), n, tscen.full(n, device=CPU), max_phases=4, window=3)
    for i in range(7):
        jp.submit(i, jio([i + 1] * n))
        tp.submit(i, tio([i + 1] * n))
    assert tp.is_running(2) and jp.is_running(2)
    jres = jp.run_all(jax.random.PRNGKey(0))
    tres = tp.run_all((0, 0))
    _same_results(tres, jres)
    for i in range(7):
        assert tp.get_decision(i).value == i + 1
        assert not tp.is_running(i)
    assert not tp.can_start(3)
    with pytest.raises(ValueError):
        tp.submit(3, tio([9] * n))


def test_instance_pool_stop_and_recovery():
    n = 4

    def run(Pool, sampler, io, keys):
        a = Pool(*((JOTR(), n, sampler(n)) if Pool is JPool else
                   (TOTR(), n, sampler(n, device=CPU))), max_phases=4,
                 window=4)
        b = Pool(*((JOTR(), n, sampler(n)) if Pool is JPool else
                   (TOTR(), n, sampler(n, device=CPU))), max_phases=4,
                 window=4)
        for i in range(3):
            a.submit(i, io([10 + i] * n))
        a.submit(3, io([99] * n))
        a.stop(3)
        a.run_all(keys[0])
        b.submit(0, io([10] * n))
        b.run_all(keys[1])
        got = (a.get_decision(3), b.recover_from(a, 1),
               b.recover_from(a, 2), b.recover_from(a, 3))
        return a, b, got

    ja, jb, jgot = run(JPool, jscen.full, jio,
                       (jax.random.PRNGKey(1), jax.random.PRNGKey(2)))
    ta, tb, tgot = run(TPool, tscen.full, tio, ((0, 1), (0, 2)))
    assert tgot == jgot == (None, True, True, False)
    for i in range(3):
        _same_result(tb.get_decision(i), jb.get_decision(i))
    assert tb.get_decision(2).value == 12


def test_instance_id_wraparound():
    n = 4
    jp = JPool(JOTR(), n, jscen.full(n), max_phases=3, window=2)
    tp = TPool(TOTR(), n, tscen.full(n, device=CPU), max_phases=3, window=2)
    for p, io in ((jp, jio), (tp, tio)):
        p.submit(65535, io([1] * n))
        p.submit(65536, io([2] * n))
    _same_results(tp.run_all((0, 0)), jp.run_all(jax.random.PRNGKey(0)))
    assert tp.get_decision(65535).value == 1
    assert tp.get_decision(0).value == 2


def _replicas(g):
    return [(r.id, r.address, r.port) for r in g.replicas]


def test_group_add_remove_rename():
    out = []
    for local_group in (jlocal_group, tlocal_group):
        g = local_group(4)
        g2 = g.remove(1)
        g3 = g2.add("10.0.0.9", 7777)
        out.append((g.size, g.inet_to_id("127.0.0.1", 4446), _replicas(g2),
                    g2.renaming_from(g), _replicas(g3)))
    assert out[0] == out[1]
    assert out[1][1] == 2 and out[1][3] == {0: 0, 1: None, 2: 1, 3: 2}


def test_group_rejects_non_contiguous_ids():
    for Group, Replica in ((JGroup, JReplica), (TGroup, TReplica)):
        with pytest.raises(ValueError, match="0..n-1"):
            Group([Replica(0, "a"), Replica(2, "b")])


def test_directory_membership_change_between_instances():
    out = []
    for Directory, local_group, Pool, algo, full, io, keys in (
            (JDirectory, jlocal_group, JPool, JOTR, jscen.full, jio,
             (jax.random.PRNGKey(0), jax.random.PRNGKey(1))),
            (TDirectory, tlocal_group, TPool, TOTR,
             lambda n: tscen.full(n, device=CPU), tio, ((0, 0), (0, 1)))):
        d = Directory(local_group(4))
        pool4 = Pool(algo(), d.size, full(d.size), 4, window=2)
        pool4.submit(0, io([5] * 4))
        pool4.run_all(keys[0])
        d.remove_replica(3)
        pool3 = Pool(algo(), d.size, full(d.size), 4, window=2)
        pool3.submit(1, io([7] * 3))
        pool3.run_all(keys[1])
        out.append((pool4.get_decision(0), pool3.get_decision(1),
                    _replicas(d.group)))
    (j4, j3, jg), (t4, t3, tg) = out
    _same_result(t4, j4)
    _same_result(t3, j3)
    assert tg == jg and t3.value == 7 and len(t3.decided) == 3


def _counter_j():
    return (lambda state, batch: state + jnp.sum(batch),
            jnp.asarray(0, dtype=jnp.int32))


def _counter_t():
    return (lambda state, batch: state + batch.sum(dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32))


def _rsm_pair(n=4, batch=4, jsampler=None, tsampler=None, max_phases=4,
              jalgo=None, talgo=None):
    fj, ij = _counter_j()
    ft, it = _counter_t()
    j = JRSM(jalgo or JLastVoting(), n, fj, ij, jsampler or jscen.full(n),
             batch_size=batch, max_phases=max_phases)
    t = TRSM(talgo or TLastVoting(), n, ft, it,
             tsampler or tscen.full(n, device=CPU), batch_size=batch,
             max_phases=max_phases)
    return j, t


def _same_smr(t, j):
    assert int(t.apply_decided()) == int(j.apply_decided())
    assert t.applied_upto == j.applied_upto
    assert t.next_instance == j.next_instance
    assert t.log_gaps() == j.log_gaps()
    assert t.decided_batches == j.decided_batches
    assert sorted(t.batch_store) == sorted(j.batch_store)
    for i, row in j.batch_store.items():
        assert np.array_equal(t.batch_store[i], row)
        assert t.batch_store[i].dtype == row.dtype


def test_smr_batches_decide_and_apply():
    j, t = _rsm_pair()
    j.propose([1, 2, 3, 4, 5, 6, 7, 8])
    t.propose([1, 2, 3, 4, 5, 6, 7, 8])
    assert t.run((0, 0)) == j.run(jax.random.PRNGKey(0)) == 2
    _same_smr(t, j)
    assert int(t.apply_decided()) == 36 and t.log_gaps() == []


def test_smr_partial_batch_padding():
    j, t = _rsm_pair(batch=4)
    j.propose([10, 20])
    t.propose([10, 20])
    assert t.run((0, 0)) == j.run(jax.random.PRNGKey(0)) == 0
    assert (t.run((0, 0), pad_with_noop=True)
            == j.run(jax.random.PRNGKey(0), pad_with_noop=True) == 1)
    _same_smr(t, j)
    assert int(t.apply_decided()) == 30


def test_smr_recovery_fills_gaps():
    ja, ta = _rsm_pair()
    ja.propose(list(range(1, 13)))
    ta.propose(list(range(1, 13)))
    ja.run(jax.random.PRNGKey(0))
    ta.run((0, 0))
    jb, tb = _rsm_pair()
    assert tb.recover_from(ta) == jb.recover_from(ja) == 3
    _same_smr(tb, jb)
    assert int(tb.apply_decided()) == sum(range(1, 13))


def test_smr_snapshot_install():
    ja, ta = _rsm_pair()
    ja.propose(list(range(1, 9)))
    ta.propose(list(range(1, 9)))
    ja.run(jax.random.PRNGKey(3))
    ta.run((0, 3))
    jsnap, tsnap = ja.snapshot(), ta.snapshot()
    assert (tsnap.upto, int(tsnap.state)) == (jsnap.upto, int(jsnap.state))
    jb, tb = _rsm_pair()
    jb.install_snapshot(jsnap)
    tb.install_snapshot(tsnap)
    assert tb.applied_upto == jb.applied_upto == 2
    assert int(tb.apply_decided()) == int(jb.apply_decided()) == 36


def _npz_leaves(path):
    with np.load(f"{path}/state.npz", allow_pickle=False) as data:
        return {k: data[k] for k in data.files if k != "__manifest__"}


def _same_leaf_bytes(tpath, jpath):
    t, j = _npz_leaves(tpath), _npz_leaves(jpath)
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        assert t[k].tobytes() == j[k].tobytes(), k


def test_smr_checkpoint_restart_matches_never_crashed_twin(tmp_path):
    """Both packages checkpoint the same replica: the leaves are byte-equal
    and the sidecar TSVs too; each restores into a fresh replica that
    matches its never-crashed twin, and a batch-size mismatch refuses."""
    from round_tpu.runtime.checkpoint import restore_decisions as jrd
    from round_tpu_torch.runtime.checkpoint import CheckpointError
    from round_tpu_torch.runtime.checkpoint import restore_decisions as trd

    ja, ta = _rsm_pair()
    ja.propose(list(range(1, 13)))
    ta.propose(list(range(1, 13)))
    ja.run(jax.random.PRNGKey(0))
    ta.run((0, 0))
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    ja.checkpoint(jpath)
    ta.checkpoint(tpath)
    _same_leaf_bytes(tpath, jpath)
    with open(f"{tpath}/decisions.tsv", "rb") as a, \
            open(f"{jpath}/decisions.tsv", "rb") as b:
        assert a.read() == b.read()
    jb, tb = _rsm_pair()
    assert tb.restore_checkpoint(tpath) == jb.restore_checkpoint(jpath) \
        == ta.applied_upto
    _same_smr(tb, jb)
    _same_smr(tb, ta)
    assert tb.log_gaps() == []
    assert len(trd(tpath)) == len(jrd(jpath)) == 3
    wrong = _rsm_pair(batch=8)[1]
    with pytest.raises(CheckpointError, match="not an SMR checkpoint"):
        wrong.restore_checkpoint(tpath)


def test_smr_byzantine_decides_through_primary_failure():
    from round_tpu.models.pbft import PbftViewChange as JPbftVC
    from round_tpu_torch.models.pbft import PbftViewChange as TPbftVC

    n, rounds = 4, 12
    ho = np.ones((rounds, n, n), dtype=bool)
    ho[:, :, 0] = False
    for r in range(rounds):
        np.fill_diagonal(ho[r], True)
    j, t = _rsm_pair(jsampler=jscen.from_schedule(jnp.asarray(ho)),
                     tsampler=tscen.from_schedule(torch.as_tensor(ho)),
                     max_phases=2, jalgo=JPbftVC(), talgo=TPbftVC())
    j.propose(list(range(1, 9)))
    t.propose(list(range(1, 9)))
    assert t.run((0, 0)) == j.run(jax.random.PRNGKey(0)) == 2
    _same_smr(t, j)
    assert t.log_gaps() == [] and int(t.apply_decided()) == 36


def _bytes_pair(n=4, B=8):
    from round_tpu.models.lastvoting import LastVotingBytes as JLVB
    from round_tpu_torch.models.lastvoting import LastVotingBytes as TLVB

    def japply(state, batch):
        def step(s, c):
            return s * jnp.uint32(31) + c.astype(jnp.uint32), None

        out, _ = jax.lax.scan(step, state, batch)
        return out

    def tapply(state, batch):
        # uint32 held in int64 (torch has no uint32 arithmetic)
        for c in batch:
            state = (state * 31 + c.to(torch.int64)) & 0xFFFFFFFF
        return state

    j = JRSM(JLVB(payload_bytes=B), n, japply, jnp.asarray(7, jnp.uint32),
             jscen.full(n), batch_size=B, max_phases=4, payload="bytes")
    t = TRSM(TLVB(payload_bytes=B), n, tapply, np.asarray(7, np.uint32),
             tscen.full(n, device=CPU), batch_size=B, max_phases=4,
             payload="bytes")
    return j, t


def test_smr_opaque_byte_payloads_replicate_commands(tmp_path):
    """LastVotingB: the decided log is the byte commands in both packages,
    the uint32 hash chain (int64 in the port) replays to the same value,
    a fresh replica recovers it, and the checkpoint's leaves (the uint32
    state among them) are byte-equal."""
    j, t = _bytes_pair()
    payload = b"hello, tpu-smr!!"
    j.propose(payload)
    t.propose(payload)
    assert t.run((0, 0)) == j.run(jax.random.PRNGKey(0)) == 2
    assert t.log_gaps() == []
    for i in range(2):
        assert t.decided_batches[i].dtype == np.uint8
        assert np.array_equal(t.decided_batches[i], j.decided_batches[i])
    expected = 7
    for c in payload:
        expected = (expected * 31 + c) % (1 << 32)
    assert int(t.apply_decided()) == int(j.apply_decided()) == expected
    fresh = _bytes_pair()[1]
    assert fresh.recover_from(t) == 2
    assert int(fresh.apply_decided()) == expected
    t.checkpoint(str(tmp_path / "t"))
    j.checkpoint(str(tmp_path / "j"))
    _same_leaf_bytes(str(tmp_path / "t"), str(tmp_path / "j"))


# -- the pool against round_tpu under the key-free samplers ------------------


def _samplers(kind, n, T, seed):
    if kind == "full":
        return jscen.full(n), tscen.full(n, device=CPU)
    if kind == "schedule":
        rng = np.random.default_rng(seed)
        ho = rng.random((T, n, n)) < 0.7
        for r in range(T):
            np.fill_diagonal(ho[r], True)
        return (jscen.from_schedule(jnp.asarray(ho)),
                tscen.from_schedule(torch.as_tensor(ho)))
    mix = jfast.standard_mix(jax.random.PRNGKey(seed), 4, n, p_drop=0.2, f=1)
    tmix = interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}, device=CPU)
    return jscen.from_mix_row(mix, 2), tscen.from_mix_row(tmix, 2)


@pytest.mark.parametrize("kind", ["full", "schedule", "mix_row"])
@pytest.mark.parametrize("algo", ["otr", "lv"])
def test_pool_decision_logs_match_round_tpu(algo, kind):
    n, phases, count = 5, 4, 10
    jalgo, talgo = ((JOTR(), TOTR()) if algo == "otr"
                    else (JLastVoting(), TLastVoting()))
    jsam, tsam = _samplers(kind, n, phases * talgo.rounds_per_phase, 3)
    jp = JPool(jalgo, n, jsam, max_phases=phases, window=4)
    tp = TPool(talgo, n, tsam, max_phases=phases, window=4)
    inits = np.random.default_rng(11).integers(0, 4, (count, n), np.int32)
    for i, v in enumerate(inits):
        jp.submit(100 + i, jio(jnp.asarray(v)))
        tp.submit(100 + i, tio(torch.as_tensor(v)))
    jres, tres = jp.run_all(jax.random.PRNGKey(5)), tp.run_all((0, 5))
    _same_results(tres, jres)
    jlog, tlog = _log_of(jres, JDecisionLog), _log_of(tres, TDecisionLog)
    assert tlog.values_tsv() == jlog.values_tsv()
    assert tlog.digest() == jlog.digest()
    assert len(tlog) > 0


# -- the batched window against run_instance per instance key ----------------


@pytest.mark.parametrize("algo", ["otr", "benor"])
@pytest.mark.parametrize("W", [1, 3, 16])
def test_window_matches_run_instance_on_instance_keys(W, algo):
    """Instance iid of a window equals run_instance on instance_key(key,
    iid), under a keyed omission sampler (Ben-Or also draws its coins
    from the per-instance lane words); the window is one round loop, a
    run_round call a round whatever W; the masks come in one call of the
    sampler's window form, row by row its per-key masks; a sampler
    without a window form takes the per-key path to the same results."""
    n, phases, key = 5, 4, (12345, 678)
    talgo = TOTR() if algo == "otr" else TBenOr()
    sampler = tscen.omission(n, 0.3, device=CPU)
    rng = np.random.default_rng(W)
    ids = [int(i) for i in rng.choice(60000, W, replace=False)]
    inits = rng.integers(0, 2, (W, n)).astype(np.int32)
    calls = [0]
    inner = texec.run_round

    def counting(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    pools = []
    for s in (sampler, lambda k, r: sampler(k, r)):
        pool = TPool(talgo, n, s, max_phases=phases, window=W)
        for iid, v in zip(ids, inits):
            pool.submit(iid, tio(torch.as_tensor(v)))
        pools.append(pool)
    texec.run_round = counting
    try:
        batched = pools[0].run_pending(key)
    finally:
        texec.run_round = inner
    assert calls[0] == phases * talgo.rounds_per_phase
    _same_results(pools[1].run_pending(key), batched)
    for res, iid, v in zip(batched, ids, inits):
        want = texec.run_instance(talgo, tio(torch.as_tensor(v)), n,
                                  instance_key(key, iid), sampler, phases,
                                  device=CPU)
        assert np.array_equal(res.decided,
                              talgo.decided(want.state).numpy())
        assert np.array_equal(res.decision,
                              talgo.decision(want.state).numpy())
        assert np.array_equal(res.decided_round,
                              want.decided_round.numpy())
    keys = [instance_key(key, iid) for iid in ids]
    salts = torch.tensor(keys, dtype=torch.int64)
    for r in (0, 3, 17):
        masks = window_masks(sampler, keys, (salts[:, 0], salts[:, 1]), r)
        assert masks.shape == (W, n, n)
        for w, k in enumerate(keys):
            assert torch.equal(masks[w], sampler(k, r))


def test_instance_key_is_the_scenario_key_rule():
    from round_tpu_torch.engine.scenarios import mix32_host
    from round_tpu_torch.ops.fused import _GOLD

    for key, iid in (((0, 5), 0), ((7, 9), 65535), ((0xFFFFFFFF, 3), 12)):
        assert instance_key(key, iid) == (
            mix32_host(key[0] + iid * _GOLD), key[1])


# -- SMR under drops: applied states and digests -----------------------------


def test_smr_under_drops_matches_round_tpu():
    """LastVoting SMR over a from_mix_row schedule with drops: the decided
    batches, the gaps, the applied state and the decision log's digest
    equal round_tpu's; a lagging replica recovers every gap."""
    n = 4
    jsam, tsam = _samplers("mix_row", n, 16, 8)
    j, t = _rsm_pair(n=n, batch=4, jsampler=jsam, tsampler=tsam)
    cmds = list(np.random.default_rng(2).integers(0, 1000, 40))
    j.propose(cmds)
    t.propose(cmds)
    assert t.run((0, 4)) == j.run(jax.random.PRNGKey(4)) == 10
    _same_smr(t, j)
    jlog, tlog = JDecisionLog(), TDecisionLog()
    for i, b in j.decided_batches.items():
        jlog.record(i, 0, b)
    for i, b in t.decided_batches.items():
        tlog.record(i, 0, b)
    assert tlog.digest() == jlog.digest()
    lag = _rsm_pair(n=n, batch=4)[1]
    assert lag.recover_from(t) == len(t.decided_batches)
    assert int(lag.apply_decided()) == int(t.apply_decided())
