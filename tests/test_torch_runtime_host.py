"""Port parity of the in-process runtime's host half (round_tpu_torch/
runtime: checkpoint, config, capacity, health, the admission meters and
the lane table, decisions), held against round_tpu on the same inputs with
tolerance 0: checkpoint leaf bytes, Options fields, capacity coefficients
as floats, health scores and quarantine states, admission decisions and
decision-log bytes.  The event streams are drawn from numpy seeds and fed
to both packages.  (The device half, pools and SMR, is
tests/test_torch_runtime.py.)"""

import dataclasses
import json
import os
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.runtime import capacity as jcap
from round_tpu.runtime import checkpoint as jckpt
from round_tpu.runtime import config as jconfig
from round_tpu.runtime import health as jhealth
from round_tpu.runtime import instances as jinst
from round_tpu.runtime.decisions import DecisionLog as JDecisionLog
from round_tpu_torch import interop
from round_tpu_torch.runtime import capacity as tcap
from round_tpu_torch.runtime import checkpoint as tckpt
from round_tpu_torch.runtime import config as tconfig
from round_tpu_torch.runtime import health as thealth
from round_tpu_torch.runtime import instances as tinst
from round_tpu_torch.runtime.decisions import DecisionLog as TDecisionLog

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


# -- checkpoints --------------------------------------------------------------


def _states(seed=0):
    """The same state in both packages: a nested dict whose insertion order
    is not its sorted order, with int32, bool, float32 and uint8 leaves."""
    rng = np.random.default_rng(seed)
    arrays = {
        "x": rng.integers(-5, 5, (2, 3)).astype(np.int32),
        "d": rng.random(4) < 0.5,
        "inner": {"z": rng.random(3).astype(np.float32),
                  "a": rng.integers(0, 255, (2, 2)).astype(np.uint8)},
    }

    def conv(tree, fn):
        return {k: conv(v, fn) if isinstance(v, dict) else fn(v)
                for k, v in tree.items()}

    return conv(arrays, jnp.asarray), conv(arrays, torch.as_tensor), arrays


def _npz(path):
    with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _flat(tree):
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_flat(v) if isinstance(v, dict) else [np.asarray(v)])
    return out


def test_checkpoint_leaf_bytes_equal_and_both_restore(tmp_path):
    """save() of the same state in both packages writes byte-equal leaf{i}
    arrays in round_tpu's dtypes and order, the same step, meta and
    decisions.tsv; the port restores its own checkpoint and, through
    interop.checkpoint_from_round_tpu, round_tpu's."""
    jstate, tstate, arrays = _states()
    log = [(1, 0, 5), (4, 2, 6)]
    jlog, tlog = JDecisionLog(), TDecisionLog()
    for i, r, v in log:
        jlog.record(i, r, v)
        tlog.record(i, r, v)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save(jpath, jstate, step=9, meta={"k": 1}, decisions=jlog)
    tckpt.save(tpath, tstate, step=9, meta={"k": 1}, decisions=tlog)
    jz, tz = _npz(jpath), _npz(tpath)
    assert sorted(jz) == sorted(tz)
    for k in jz:
        if k == "__manifest__":
            continue
        assert tz[k].dtype == jz[k].dtype and tz[k].shape == jz[k].shape
        assert tz[k].tobytes() == jz[k].tobytes(), k
    jm = json.loads(open(os.path.join(jpath, "manifest.json")).read())
    tm = json.loads(open(os.path.join(tpath, "manifest.json")).read())
    assert {k: v for k, v in jm.items() if k != "treedef"} == \
        {k: v for k, v in tm.items() if k != "treedef"}
    assert open(os.path.join(jpath, "decisions.tsv")).read() == \
        open(os.path.join(tpath, "decisions.tsv")).read()
    for restore in (lambda: tckpt.restore(tpath, tstate),
                    lambda: interop.checkpoint_from_round_tpu(jpath,
                                                              tstate)):
        state, step, meta = restore()
        assert (step, meta) == (9, {"k": 1})
        for got, want in zip(_flat(state), _flat(arrays)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tckpt.restore_decisions(tpath).values_tsv() == jlog.values_tsv()


def test_checkpoint_from_round_tpu_refuses_mismatched_leaves(tmp_path):
    """round_tpu's treedef string cannot be compared, so the leaves are:
    count, dtype and shape (zero-length dims of the template match any
    length) — each mismatch is a CheckpointError."""
    path = str(tmp_path / "j")
    jckpt.save(path, {"a": jnp.zeros((3, 2), jnp.int32),
                      "b": jnp.ones(4, bool)}, step=1)
    ok = {"a": np.zeros((0, 2), np.int32), "b": np.zeros(0, bool)}
    state, step, _ = interop.checkpoint_from_round_tpu(path, ok)
    assert step == 1 and state["a"].shape == (3, 2)
    for bad, match in (({"a": np.zeros((3, 2), np.int32)}, "leaves"),
                       ({"a": np.zeros((3, 2), np.int64),
                         "b": np.zeros(4, bool)}, "leaf 0"),
                       ({"a": np.zeros((3, 3), np.int32),
                         "b": np.zeros(4, bool)}, "leaf 0"),
                       ({"a": np.zeros((3, 2), np.int32),
                         "b": np.zeros((4, 1), bool)}, "leaf 1")):
        with pytest.raises(tckpt.CheckpointError, match=match):
            interop.checkpoint_from_round_tpu(path, bad)


def _smr(pkg, payload):
    """A decided SMR replica of either package (counter state machine, or
    the uint32 byte hash chain), on the same commands."""
    n = 4
    if pkg == "jax":
        import jax
        from round_tpu.engine import scenarios
        from round_tpu.models.lastvoting import LastVoting, LastVotingBytes
        from round_tpu.runtime import ReplicatedStateMachine as RSM

        if payload == "index":
            args = (LastVoting(), n, lambda s, b: s + jnp.sum(b),
                    jnp.asarray(0, jnp.int32))
        else:
            def apply(s, b):
                return jax.lax.scan(lambda s, c: (
                    s * jnp.uint32(31) + c.astype(jnp.uint32), None), s, b)[0]

            args = (LastVotingBytes(payload_bytes=8), n, apply,
                    jnp.asarray(7, jnp.uint32))
        rsm = RSM(*args, scenarios.full(n), batch_size=8, max_phases=4,
                  payload=payload)
        key = jax.random.PRNGKey(0)
    else:
        from round_tpu_torch.engine import scenarios
        from round_tpu_torch.models.lastvoting import (
            LastVoting, LastVotingBytes,
        )
        from round_tpu_torch.runtime import ReplicatedStateMachine as RSM

        if payload == "index":
            args = (LastVoting(), n,
                    lambda s, b: s + b.sum(dtype=torch.int32),
                    torch.tensor(0, dtype=torch.int32))
        else:
            def apply(s, b):
                for c in b:
                    s = (s * 31 + c.to(torch.int64)) & 0xFFFFFFFF
                return s

            args = (LastVotingBytes(payload_bytes=8), n, apply,
                    np.asarray(7, np.uint32))
        rsm = RSM(*args, scenarios.full(n, device="cpu"), batch_size=8,
                  max_phases=4, payload=payload, device="cpu")
        key = (0, 0)
    return rsm, key


@pytest.mark.parametrize("payload", ["index", "bytes"])
def test_smr_from_round_tpu_checkpoint(tmp_path, payload):
    """A round_tpu SMR checkpoint (the uint32 LastVotingBytes state
    included) restores into a fresh port replica through
    interop.smr_from_round_tpu and matches the port's never-crashed twin;
    the two packages' checkpoints have byte-equal leaves."""
    cmds = list(b"replicate these 24 bytes")
    j, jkey = _smr("jax", payload)
    twin, tkey = _smr("torch", payload)
    j.propose(cmds)
    twin.propose(cmds)
    j.run(jkey)
    twin.run(tkey)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    j.checkpoint(jpath)
    twin.checkpoint(tpath)
    jz, tz = _npz(jpath), _npz(tpath)
    for k in jz:
        if k != "__manifest__":
            assert tz[k].dtype == jz[k].dtype, k
            assert tz[k].tobytes() == jz[k].tobytes(), k
    fresh, _ = _smr("torch", payload)
    assert interop.smr_from_round_tpu(fresh, jpath) == twin.applied_upto == 3
    assert int(fresh.apply_decided()) == int(twin.apply_decided()) \
        == int(j.apply_decided())
    assert fresh.next_instance == twin.next_instance
    assert fresh.log_gaps() == []
    for i, v in twin.decided_batches.items():
        assert np.array_equal(fresh.decided_batches[i], v)
    wrong, _ = _smr("torch", "bytes" if payload == "index" else "index")
    with pytest.raises(tckpt.CheckpointError):
        interop.smr_from_round_tpu(wrong, jpath)


def _corrupt(mode, path):
    """Damage a fresh checkpoint directory as round_tpu's checkpoint tests
    do (tests/test_harness.py)."""
    npz = os.path.join(path, "state.npz")
    if mode == "truncated":
        with open(npz, "r+b") as fh:
            fh.truncate(os.path.getsize(npz) // 2)
    elif mode == "nomanifest":
        os.remove(os.path.join(path, "manifest.json"))
    elif mode == "badjson":
        with open(os.path.join(path, "manifest.json"), "w") as fh:
            fh.write("{not json")
    elif mode == "notazip":
        with open(npz, "wb") as fh:
            fh.write(b"\x00" * 64)


@pytest.mark.parametrize("mode,match", [
    ("truncated", "corrupt or truncated"),
    ("nomanifest", "no checkpoint manifest"),
    ("badjson", "unreadable"),
    ("leafcount", "leaves"),
    ("notazip", "corrupt or truncated"),
    ("treedef", "treedef"),
])
def test_checkpoint_corruption_raises_the_same_errors(tmp_path, mode, match):
    """Every corruption mode of round_tpu's checkpoint tests raises a
    CheckpointError of the same text class in both packages."""
    for pkg, ckpt, arr in (("j", jckpt, jnp.asarray),
                           ("t", tckpt, torch.as_tensor)):
        state = {"x": arr(np.arange(8)), "y": arr(np.ones(3))}
        path = str(tmp_path / pkg)
        ckpt.save(path, state, step=3)
        _corrupt(mode, path)
        like = ({"x": state["x"]} if mode == "leafcount" else
                {"b": state["x"], "z": state["y"]} if mode == "treedef"
                else state)
        with pytest.raises(ckpt.CheckpointError, match=match):
            ckpt.restore(path, like)


def test_checkpoint_torn_save_and_sidecar(tmp_path):
    """A stale manifest.json beside a newer state.npz restores the newer
    consistent pair; a missing manifest is still an error; a log-less
    checkpoint has no decision log — in both packages alike."""
    for pkg, ckpt, arr, Log in (("j", jckpt, jnp.asarray, JDecisionLog),
                                ("t", tckpt, torch.as_tensor, TDecisionLog)):
        path = str(tmp_path / pkg)
        ckpt.save(path, {"x": arr(np.arange(4))}, step=1, meta={"gen": 1})
        stale = str(tmp_path / f"{pkg}-stale.json")
        shutil.copy(os.path.join(path, "manifest.json"), stale)
        ckpt.save(path, {"x": arr(np.arange(4) + 100)}, step=2,
                  meta={"gen": 2})
        shutil.copy(stale, os.path.join(path, "manifest.json"))
        state, step, meta = ckpt.restore(path, {"x": arr(np.zeros(4))})
        assert step == 2 and meta == {"gen": 2}
        assert np.array_equal(np.asarray(state["x"]), np.arange(4) + 100)
        with pytest.raises(ckpt.CheckpointError, match="no decision log"):
            ckpt.restore_decisions(path)
        os.remove(os.path.join(path, "manifest.json"))
        assert not ckpt.exists(path)
        with pytest.raises(ckpt.CheckpointError,
                           match="no checkpoint manifest"):
            ckpt.restore(path, {"x": arr(np.zeros(4))})
        log = Log()
        log.record(1, 0, 5)
        ckpt.save(path, {"x": arr(np.arange(4))}, step=2, decisions=log)
        assert ckpt.restore_decisions(path).get(1) == (0, 5)


def test_tree_to_packs_every_dtype_into_one_buffer():
    """The pool's one-copy staging (utils.tree.tree_to): leaves of any
    dtype and shape, 0-d included, packed at 8-byte aligned offsets and
    viewed back bit for bit."""
    from round_tpu_torch.utils.tree import (
        pack_bytes, tree_flatten, tree_to, unpack_bytes,
    )

    rng = np.random.default_rng(5)
    leaves = [torch.as_tensor(rng.random(5) < 0.5),
              torch.as_tensor(rng.integers(-9, 9, (3, 2)).astype(np.int32)),
              torch.tensor(-(1 << 40), dtype=torch.int64),
              torch.as_tensor(rng.integers(0, 255, (7,)).astype(np.uint8)),
              torch.as_tensor(rng.random((2, 3)).astype(np.float32))]
    buf = pack_bytes(leaves)
    assert buf.dtype == torch.uint8 and buf.numel() == 8 + 24 + 8 + 8 + 24
    for got, want in zip(unpack_bytes(buf, leaves), leaves):
        assert got.dtype == want.dtype and torch.equal(got, want)
    tree = {"b": leaves[:2], "a": leaves[2]}
    assert tree_to(tree, "cpu") is tree
    assert [t.dtype for t in tree_flatten(tree)[0]] == \
        [torch.int64, torch.bool, torch.int32]


# -- decision logs ------------------------------------------------------------


def test_decision_log_bytes_and_interop(tmp_path):
    rng = np.random.default_rng(4)
    triples = [(int(i), int(r), int(v)) for i, r, v in zip(
        rng.choice(500, 60, replace=False), rng.integers(0, 9, 60),
        rng.integers(-3, 1000, 60))]
    jlog, tlog = JDecisionLog(), TDecisionLog()
    for i, r, v in triples:
        assert jlog.record(i, r, v) == tlog.record(i, r, v)
    assert not tlog.record(*triples[0][:2], triples[0][2] + 1)
    assert tlog.values_tsv() == jlog.values_tsv()
    assert tlog.digest() == jlog.digest()
    assert tlog.missing(100) == jlog.missing(100)
    for log, name in ((jlog, "j"), (tlog, "t")):
        log.dump_tsv(str(tmp_path / f"{name}.tsv"))
        log.dump_values_tsv(str(tmp_path / f"{name}.vals"))
    for ext in ("tsv", "vals"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()
    back = interop.decision_log_from_round_tpu(
        [(i, *jlog.get(i)) for i in jlog.instances()])
    assert back.digest() == jlog.digest()
    assert TDecisionLog.load_tsv(str(tmp_path / "j.tsv")).digest() == \
        jlog.digest()
    vals = [None if k % 5 == 0 else k * 3 for k in range(20)]
    assert TDecisionLog.from_values(vals).digest() == \
        JDecisionLog.from_values(vals).digest()
    assert tlog.replay(lambda s, i, v: s + v, 0) == \
        jlog.replay(lambda s, i, v: s + v, 0)


# -- config ------------------------------------------------------------------

SAMPLE_XML = """<config>
  <peers>
    <replica address="127.0.0.1" port="4444"/>
    <replica address="127.0.0.1" port="4445"/>
    <replica address="127.0.0.1" port="4446"/>
  </peers>
  <parameters>
    <param name="timeout" value="5"/>
    <param name="algorithm" value="lv"/>
    <param name="stat"/>
  </parameters>
</config>"""


@pytest.mark.parametrize("argv", [
    [],
    ["-a", "lv", "-n", "7", "-rt", "1024", "--seed", "3", "--stat"],
    ["--conf", "{xml}"],
    ["--conf", "{xml}", "-to", "25", "-a", "otr", "--max-phases", "9"],
    ["--conf", "{json}", "--log", "d.tsv", "-id", "2"],
    ["--scenarios", "8", "--chunk", "2", "--byzantine", "1",
     "--scenario-shards", "2", "--proc-shards", "4", "--unknown", "x"],
])
def test_parse_args_matches_round_tpu(tmp_path, argv):
    xml = tmp_path / "conf.xml"
    xml.write_text(SAMPLE_XML)
    js = tmp_path / "conf.json"
    js.write_text('{"peers": [["h0", 1], ["h1", 2]], "seed": 9, '
                  '"stats": true, "rate": 32}')
    argv = [a.format(xml=xml, json=js) for a in argv]
    want = dataclasses.asdict(jconfig.parse_args(argv))
    got = dataclasses.asdict(tconfig.parse_args(argv))
    assert got == want
    assert tconfig.parse_args(argv).group().size == got["n"]
    if "--conf" in argv:
        assert tconfig.parse_config_file(str(argv[1])) == \
            jconfig.parse_config_file(str(argv[1]))


def test_parse_args_warns_on_unknown_file_keys(tmp_path):
    p = tmp_path / "conf.json"
    p.write_text('{"sedd": 3}')
    for config in (jconfig, tconfig):
        with pytest.warns(UserWarning, match="unrecognized"):
            config.parse_args(["--conf", str(p)])


# -- capacity ----------------------------------------------------------------


def test_capacity_fit_on_banked_samples_matches_round_tpu(tmp_path):
    """CAPACITY_r03.json's knee samples (round_tpu's host measurements) fit
    to the same coefficients, bit for bit, and derive the same lanes and
    watermarks."""
    samples = json.loads((REPO / "CAPACITY_r03.json").read_text())["samples"]
    jm, tm = jcap.fit_capacity(samples), tcap.fit_capacity(samples)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    for drivers in (1, 2, 4):
        for payload in (0, 1024, 4096):
            assert tm.recommended_lanes(drivers, payload) == \
                jm.recommended_lanes(drivers, payload)
            assert tm.admission_bytes_per_lane(4, 64, payload, drivers) == \
                jm.admission_bytes_per_lane(4, 64, payload, drivers)
    tm.save(str(tmp_path / "cap.json"))
    for lanes in (0, 16):
        assert tcap.derive_admission(str(tmp_path / "cap.json"), 4, lanes,
                                     1024) == \
            jcap.derive_admission(str(tmp_path / "cap.json"), 4, lanes, 1024)
    for bad in ([{"drivers": 1, "lanes": 8, "knee_dps": 10.0}],
                [{"drivers": 1, "lanes": 8, "knee_dps": 10.0}] * 4):
        with pytest.raises(tcap.CapacityFitError):
            tcap.fit_capacity(bad)


# -- health ------------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 100.0

    def monotonic(self):
        return self.t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peer_health_matches_round_tpu_on_event_streams(monkeypatch, seed):
    """The same round-by-round event stream (rounds heard or expired, with
    and without goals, malformed frames, reconnects, ticks, view resizes)
    gives the same scores, quarantine sets and summaries."""
    clocks = []
    for mod in (jhealth, thealth):
        clocks.append(_Clock())
        monkeypatch.setattr(mod, "_time", clocks[-1])
    n = 7
    hs = [mod.PeerHealth(n, 0, quarantine_after=2.0, probe_backoff_ms=300)
          for mod in (jhealth, thealth)]
    rng = np.random.default_rng(seed)
    for step in range(300):
        dt = float(rng.random()) * 0.2
        for c in clocks:
            c.t += dt
        kind = rng.integers(0, 10)
        n_now = hs[0].n
        for h in hs:
            h_rng = np.random.default_rng(seed * 1000 + step)
            if kind < 6:
                heard = [int(p) for p in np.nonzero(
                    h_rng.random(n_now) < 0.6)[0]]
                goal = None if h_rng.random() < 0.5 else int(
                    h_rng.integers(0, n_now + 1))
                h.note_round(heard, expired=bool(h_rng.random() < 0.7),
                             goal=goal)
            elif kind == 6:
                h.note_malformed(int(h_rng.integers(0, n_now + 1)))
            elif kind == 7:
                h.note_reconnect(int(h_rng.integers(0, n_now)))
            elif kind == 8:
                h.tick()
            elif n_now > 4:
                gone = int(h_rng.integers(1, n_now))
                ren = {p: (None if p == gone else p - (p > gone))
                       for p in range(n_now)}
                h.resize(n_now - 1, ren)
            else:
                h.resize(n_now + 1)
        j, t = hs
        assert t.score == j.score
        assert t.active() == j.active()
        assert t.summary() == j.summary()
        assert t.effective_threshold(j.n) == j.effective_threshold(j.n)


# -- admission meters and the lane table --------------------------------------


def _both(fn):
    """fn(module) for both packages' instances modules; the same outcome
    (return value or exception class) from each."""
    out = []
    for mod in (jinst, tinst):
        try:
            out.append(("ok", fn(mod)))
        except (ValueError, KeyError) as e:
            out.append(("err", type(e).__name__))
    assert out[0] == out[1], out
    return out[1]


@pytest.mark.parametrize("lanes", [1, 5, 16, 2000])
def test_lane_table_matches_round_tpu_on_churn(lanes):
    rng = np.random.default_rng(lanes)
    tables = [jinst.LaneTable(lanes), tinst.LaneTable(lanes)]
    assert tables[0].width == tables[1].width == jinst.lane_bucket(
        min(lanes, 1024))
    for step in range(400):
        op = rng.integers(0, 3)
        iid = int(rng.integers(0, 1 << 17))
        live = tables[0].live_instances()
        out = []
        for tab in tables:
            try:
                if op == 0 or not live:
                    out.append(tab.admit(iid) if tab.can_admit() else "full")
                elif op == 1:
                    out.append(tab.retire(live[step % len(live)]))
                else:
                    out.append(tab.admit(live[0]))
            except ValueError as e:
                out.append(type(e).__name__)
        assert out[0] == out[1]
        assert tables[0].occupancy == tables[1].occupancy
        assert tables[0].live_instances() == tables[1].live_instances()
        assert [tables[0].instance_of(k) for k in range(tables[0].width)] \
            == [tables[1].instance_of(k) for k in range(tables[1].width)]
    for k in (0, 1, 3, 9, 1000, 1025, 5000):
        _both(lambda m: m.lane_bucket(k))


def test_admission_control_matches_round_tpu_on_streams():
    rng = np.random.default_rng(9)
    for _ in range(5):
        kw = {"high_bytes_per_lane": int(rng.integers(1, 400)),
              "low_frac": float(rng.uniform(0.05, 0.95))}
        acs = [jinst.AdmissionControl(**kw), tinst.AdmissionControl(**kw)]
        for _ in range(200):
            args = (int(rng.integers(0, 9)), int(rng.integers(0, 4000)),
                    bool(rng.random() < 0.1))
            assert acs[0].update(*args) == acs[1].update(*args)
            assert acs[0].admit_ok() == acs[1].admit_ok()
    for bad in ({"high_bytes_per_lane": 0}, {"low_frac": 1.5}):
        _both(lambda m: m.AdmissionControl(**bad))


def test_tenant_admission_matches_round_tpu_on_streams():
    rng = np.random.default_rng(10)
    weights = {1: 1.0, 2: 3.0, 5: 0.5}
    tas = [jinst.TenantAdmission(bytes_per_lane=1000, weights=weights),
           tinst.TenantAdmission(bytes_per_lane=1000, weights=weights)]
    for _ in range(300):
        live = int(rng.integers(1, 9))
        queued = {int(t): int(rng.integers(0, 5000))
                  for t in rng.choice(8, int(rng.integers(0, 5)),
                                      replace=False)}
        bp = bool(rng.random() < 0.15)
        assert tas[0].update(live, queued, bp) == tas[1].update(live, queued,
                                                                 bp)
        pick = [ta.next_tenant(list(queued)) for ta in tas]
        assert pick[0] == pick[1]
        if pick[0] is not None:
            for ta in tas:
                ta.note_admit(pick[0])
        assert tas[0].share_bytes(2, live) == tas[1].share_bytes(2, live)
    for bad in ({"bytes_per_lane": 0}, {"weights": {1: -1.0}},
                {"low_frac": 1.0}, {"default_weight": 0}):
        _both(lambda m: m.TenantAdmission(**bad))
