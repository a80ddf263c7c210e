"""The port's observability package (round_tpu_torch/obs) and the engine
counters.

Mirrors the pure tests of tests/test_obs.py: the tracer round-trips
through JSONL, wraps its ring at capacity, and the disabled path records
nothing and allocates nothing; the metrics registry serves typed
counters/gauges/histograms with JSON and Prometheus snapshots, and Stats is
a facade over it.  Then the two HO-stat surfaces of engine.fast against
round_tpu's arrays on the same mix and sampler, bit for bit, and the
engine.hist_runs / engine.loop_runs counters."""

import gc
import json
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.engine import scenarios as jscen
from round_tpu_torch import interop
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.obs import metrics as tmetrics
from round_tpu_torch.obs import trace as ttrace
from round_tpu_torch.obs.metrics import METRICS, MetricsRegistry, Stats
from round_tpu_torch.obs.trace import Tracer, load_jsonl, merge

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")


# -- tracer -----------------------------------------------------------------

def test_tracer_jsonl_roundtrip(tmp_path):
    tr = Tracer(capacity=64, node=3, enabled=True)
    tr.emit("round_start", inst=1, round=0)
    tr.emit("round_end", inst=1, round=0, heard=2, ho=[0, 2],
            timedout=False, wall_ms=1.25)
    tr.emit("decision", inst=1, round=4, decided=True,
            value=np.int32(7))  # numpy payloads must serialize
    tr.emit("decision", inst=2, round=4, decided=True,
            value=torch.tensor(9, dtype=torch.int32))  # and torch scalars
    path = str(tmp_path / "t.jsonl")
    assert tr.dump_jsonl(path) == 4
    back = load_jsonl(path)
    assert [e["ev"] for e in back] == ["round_start", "round_end",
                                       "decision", "decision"]
    assert all(e["node"] == 3 for e in back)
    assert back[1]["ho"] == [0, 2] and back[1]["wall_ms"] == 1.25
    assert back[2]["value"] == 7 and back[3]["value"] == 9
    ts = [e["t"] for e in back]
    assert ts == sorted(ts)


def test_tracer_jsonl_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "torn.jsonl")
    with open(path, "w") as fh:
        fh.write('{"t": 1.0, "ev": "a"}\n{"t": 2.0, "ev"')  # torn mid-write
    assert [e["ev"] for e in load_jsonl(path)] == ["a"]


def test_tracer_ring_wraparound():
    tr = Tracer(capacity=8, enabled=True)
    for i in range(20):
        tr.emit("e", i=i)
    assert len(tr) == 8
    assert [e["i"] for e in tr.events()] == list(range(12, 20))
    with pytest.raises(ValueError):
        Tracer(capacity=0)


def test_tracer_disabled_records_nothing_and_allocates_nothing():
    tr = Tracer()
    assert not tr.enabled
    tr.emit("x", i=1)  # an unguarded emit is still a no-op
    assert len(tr) == 0
    gc.collect()
    tracemalloc.start()
    snap1 = tracemalloc.take_snapshot()
    for _ in range(256):
        if tr.enabled:
            tr.emit("x", i=1)
    snap2 = tracemalloc.take_snapshot()
    tracemalloc.stop()
    grown = [s for s in snap2.compare_to(snap1, "filename")
             if s.traceback[0].filename == ttrace.__file__
             and s.size_diff > 0]
    assert not grown, grown
    assert len(tr) == 0


def test_tracer_explicit_node_wins_and_merge_orders_by_time():
    tr = Tracer(node=0, enabled=True)
    tr.emit("send", node=2, dst=1)
    tr.emit("send", dst=1)
    evs = tr.events()
    assert evs[0]["node"] == 2 and evs[1]["node"] == 0
    a = [{"t": 1.0, "ev": "a"}, {"t": 3.0, "ev": "c"}]
    b = [{"t": 2.0, "ev": "b"}, {"t": 3.0, "ev": "d"}]
    assert [e["ev"] for e in merge([a, b])] == ["a", "b", "c", "d"]


# -- metrics registry ------------------------------------------------------

def test_metrics_counter_gauge_histogram_and_snapshot():
    reg = MetricsRegistry()
    reg.counter("host.rounds").inc()
    reg.counter("host.rounds").inc(4)
    reg.gauge("host.deadline_ms").set(250)
    h = reg.histogram("host.round_ms", buckets=(1, 10, 100), unit="ms")
    for v in (0.5, 5, 50, 500):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["counters"]["host.rounds"] == 5
    assert snap["gauges"]["host.deadline_ms"] == 250.0
    hs = snap["histograms"]["host.round_ms"]
    assert hs["count"] == 4 and hs["sum"] == 555.5 and hs["unit"] == "ms"
    assert hs["buckets"] == [[1.0, 1], [10.0, 2], [100.0, 3], ["+Inf", 4]]
    assert json.loads(reg.to_json()) == snap
    reg.counter("zero")
    reg.gauge("never")
    reg.gauge("floor").set(0.0)
    compact = reg.snapshot(compact=True)
    assert "zero" not in compact["counters"]
    assert "never" not in compact["gauges"]
    assert compact["gauges"]["floor"] == 0.0


def test_metrics_prometheus_text():
    reg = MetricsRegistry()
    reg.counter("chaos.drop").inc(3)
    reg.gauge("engine.ho_density_mean").set(0.75)
    reg.histogram("ckpt.save_s", buckets=(0.1, 1.0)).observe(0.05)
    text = reg.to_prometheus()
    assert "# TYPE round_tpu_chaos_drop counter" in text
    assert "round_tpu_chaos_drop 3" in text
    assert "round_tpu_engine_ho_density_mean 0.75" in text
    assert 'round_tpu_ckpt_save_s_bucket{le="0.1"} 1' in text
    assert 'round_tpu_ckpt_save_s_bucket{le="+Inf"} 1' in text
    assert "round_tpu_ckpt_save_s_count 1" in text


def test_metrics_type_clash_raises():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(ValueError):
        reg.gauge("x")
    with pytest.raises(ValueError):
        reg.histogram("x")
    reg.histogram("h", buckets=(1, 10), unit="ms")
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=(0.1, 1.0), unit="s")
    with pytest.raises(ValueError):
        reg.histogram("h", buckets=(1, 10), unit="s")
    assert reg.histogram("h", buckets=(1, 10), unit="ms") is not None
    with pytest.raises(ValueError):
        reg.histogram("bad", buckets=(10, 1))


def test_metrics_reset_keeps_cached_instruments_live(tmp_path):
    reg = MetricsRegistry()
    c = reg.counter("host.rounds")
    h = reg.histogram("lat", buckets=(1, 10), unit="ms")
    g = reg.gauge("deadline")
    c.inc(5)
    h.observe(3)
    g.set(7)
    reg.reset()
    snap = reg.snapshot()
    assert snap["counters"]["host.rounds"] == 0
    assert snap["histograms"]["lat"]["count"] == 0
    assert snap["gauges"]["deadline"] == 0.0
    c.inc(2)
    h.observe(5)
    assert reg.counter("host.rounds") is c
    assert reg.snapshot()["counters"]["host.rounds"] == 2
    assert reg.snapshot()["histograms"]["lat"]["count"] == 1
    path = str(tmp_path / "m" / "metrics.json")
    reg.dump_json(path, compact=True)
    with open(path) as fh:
        assert json.load(fh) == reg.snapshot(compact=True)


def test_stats_facade_is_registry_backed():
    s = Stats()
    s.counter("off")  # disabled: nothing recorded
    s.enabled = True
    s.counter("msgs", 2)
    with s.timer("phase"):
        pass
    snap = s.registry.snapshot()
    assert "off" not in snap["counters"]
    assert snap["counters"]["msgs"] == 2
    assert snap["histograms"]["phase"]["count"] == 1
    rep = s.report()
    assert "counter msgs: 2" in rep and "timer phase:" in rep
    assert tmetrics.stats.registry is METRICS


# -- the HO-stat surfaces against round_tpu's arrays ---------------------------

def _port_mix(mix):
    return interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}, device=CPU)


def _same_stats(got, want):
    for k in ("density", "heard_mean", "heard_min"):
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_mix_ho_stats_density_and_quorum_floor():
    key = jax.random.PRNGKey(0)
    jclean = jfast.fault_free(key, 4, 8)
    clean = tfast.mix_ho_stats(_port_mix(jclean), 3)
    _same_stats(clean, jfast.mix_ho_stats(jclean, 3))
    assert clean["density"].shape == (3,)
    assert np.allclose(clean["density"], 1.0)
    assert (clean["heard_min"] == 8).all()
    jlossy = jclean.replace(p8=jnp.full((4,), 64, jnp.int32))  # 25% drop
    st = tfast.mix_ho_stats(_port_mix(jlossy), 5)
    _same_stats(st, jfast.mix_ho_stats(jlossy, 5))
    assert (st["density"] < 1.0).all() and (st["density"] > 0.5).all()
    assert (st["heard_min"] <= st["heard_mean"]).all()
    assert (st["heard_min"] >= 1).all()


def test_mix_ho_stats_on_the_four_families():
    jmix = jfast.standard_mix(jax.random.PRNGKey(4), 12, 16, p_drop=0.25,
                              f=3, crash_round=1)
    _same_stats(tfast.mix_ho_stats(_port_mix(jmix), 7),
                jfast.mix_ho_stats(jmix, 7))


def test_sampler_ho_stats_shares_the_reducer():
    """The plain-sampler form agrees with round_tpu's on the same key (the
    hash omission sampler reads the key's two salt words), and with the
    mix form on the equivalent one-scenario FaultMix."""
    n, p, rounds = 8, 0.25, 4
    key = jax.random.PRNGKey(5)
    want = jfast.sampler_ho_stats(jscen.omission(n, p, impl="hash"), key,
                                  rounds)
    s0, s1 = (int(w) for w in np.asarray(jax.random.key_data(key)))
    via_sampler = tfast.sampler_ho_stats(
        tscen.omission(n, p, impl="hash", device=CPU), (s0, s1), rounds)
    _same_stats(via_sampler, want)
    mix = tfast.fault_free(torch.Generator().manual_seed(0), 1, n,
                           device=CPU).replace(
        p8=torch.full((1,), max(1, round(p * 256)), dtype=torch.int32),
        salt0=torch.from_numpy(np.array([s0], np.uint32).view(np.int32)),
        salt1=torch.from_numpy(np.array([s1], np.uint32).view(np.int32)))
    via_mix = tfast.mix_ho_stats(mix, rounds)
    for k in ("density", "heard_mean", "heard_min"):
        np.testing.assert_array_equal(via_sampler[k], via_mix[k], err_msg=k)
    assert (via_sampler["density"] < 1.0).all()


# -- the engine counters ---------------------------------------------------

def test_hist_runs_and_loop_runs_counted():
    """run_hist counts engine.hist_runs and run_otr_loop engine.loop_runs
    once a call, at Python entry (round_tpu/engine/fast.py:1272, :1327)."""
    from round_tpu_torch.models.otr import OtrState

    n, S, V = 8, 4, 4
    gen = torch.Generator().manual_seed(3)
    mix = tfast.standard_mix(gen, S, n, device=CPU)
    st = OtrState.fresh(torch.arange(n, dtype=torch.int32) % V, S, n)
    rnd = tfast.OtrHist(n_values=V)
    hist0 = METRICS.counter("engine.hist_runs").value
    loop0 = METRICS.counter("engine.loop_runs").value
    for _ in range(2):
        tfast.run_hist(rnd, st, lambda s: s.decided, mix, 3, mode="hash")
    tfast.run_otr_loop(rnd, st, mix, 3, mode="hash")
    assert METRICS.counter("engine.hist_runs").value == hist0 + 2
    assert METRICS.counter("engine.loop_runs").value == loop0 + 1
    # a refused resume is still a call: counted at entry, as in round_tpu
    with pytest.raises(ValueError, match="fresh state0"):
        tfast.run_otr_loop(rnd, st.replace(decided=~st.decided), mix, 3)
    assert METRICS.counter("engine.loop_runs").value == loop0 + 2
