"""Spans on the port's tracer (round_tpu_torch/obs/trace.py) and on the
engine path.

The tracer: a disabled span site records nothing and allocates nothing;
nesting sets `parent` (roots have none, a second thread keeps its own
stack); an overflowing ring counts `dropped`; span times are on the clock
of torch.profiler's host events.  The engine: `run_hist` records its
round steps under one `engine.run_hist` root, the K1 entries their host
reads of `state0` (`engine.require_fresh`, field `reads`).  On the CPU the
kernels' plain versions run, so K1's and K2's launch spans
(`fused.inputs`, `fused.launch`) are checked on the card, in the tests
marked `cuda`:

    python -m pytest tests/test_torch_spans.py -q -m cuda --noconftest
"""

import gc
import threading
import time
import tracemalloc

import pytest
import torch

from round_tpu_torch.engine import fast
from round_tpu_torch.models.benor import BenOrState
from round_tpu_torch.models.floodmin import FloodMinState
from round_tpu_torch.models.otr import OtrState
from round_tpu_torch.obs.trace import NOSPAN, TRACE, Tracer
from round_tpu_torch.utils.tree import tree_leaves

# tiny tensors on the CPU: more intra-op threads only spin
torch.set_num_threads(1)

CPU = torch.device("cpu")
ROUND_STEPS = ("round.params", "round.exchange", "round.update",
               "round.freeze")


@pytest.fixture
def traced():
    """The process-wide TRACE, cleared and enabled for one test."""
    TRACE.clear()
    TRACE.enable()
    try:
        yield TRACE
    finally:
        TRACE.disable()
        TRACE.clear()


def _spans(tr):
    return [e for e in tr.events() if e["ev"] == "span"]


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _root_of(s, by_id):
    while s["parent"] is not None:
        s = by_id[s["parent"]]
    return s


# -- the tracer ---------------------------------------------------------------

def _peak_bytes(fn, tries: int = 5) -> int:
    """The most memory fn() held at once above what was held before it,
    by tracemalloc: the least of a few tries, since tracemalloc also
    counts what other threads of the process allocate meanwhile."""
    peaks = []
    for _ in range(tries):
        gc.collect()
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            fn()
            peaks.append(tracemalloc.get_traced_memory()[1] - before)
        finally:
            tracemalloc.stop()
    return min(peaks)


def test_disabled_span_records_nothing_and_allocates_nothing():
    tr = Tracer()
    assert tr.span("x", i=1) is NOSPAN  # an unguarded site is a no-op
    with tr.span("x"):
        pass
    assert len(tr) == 0

    def bare():
        for r in range(256):
            with NOSPAN:  # what any `with` holds: its bound __exit__
                pass

    def guarded():
        for r in range(256):
            with tr.span("round.update", round=r) if tr.enabled else NOSPAN:
                pass

    # the peaks, not the net: a fields dict freed at once shows in a peak
    assert _peak_bytes(guarded) <= _peak_bytes(bare)
    assert len(tr) == 0 and tr.dropped == 0


def test_nested_spans_set_parent_and_roots_have_none():
    tr = Tracer(node=5, enabled=True)
    with tr.span("root", k=1):
        with tr.span("child"):
            with tr.span("leaf", round=3):
                pass
        with tr.span("child"):
            pass
    with tr.span("root"):
        pass
    spans = _spans(tr)
    # each span is recorded when it ends
    assert [s["name"] for s in spans] == ["leaf", "child", "child", "root",
                                          "root"]
    leaf, c1, c2, r1, r2 = spans
    assert r1["parent"] is None and r2["parent"] is None
    assert c1["parent"] == r1["id"] and c2["parent"] == r1["id"]
    assert leaf["parent"] == c1["id"]
    assert len({s["id"] for s in spans}) == 5
    assert leaf["round"] == 3 and r1["k"] == 1
    for s in spans:
        assert s["node"] == 5
        assert s["t0_ns"] <= s["t1_ns"]
        assert s["t"] == s["t0_ns"] / 1e9
    assert r1["t0_ns"] <= c1["t0_ns"] <= leaf["t0_ns"]
    assert leaf["t1_ns"] <= c1["t1_ns"] <= c2["t0_ns"] <= r1["t1_ns"]
    # a span raising through still records, and the stack unwinds
    with pytest.raises(KeyError):
        with tr.span("root"):
            with tr.span("child"):
                raise KeyError
    child, root = _spans(tr)[-2:]
    assert child["parent"] == root["id"] and root["parent"] is None
    with tr.span("after"):
        pass
    assert _spans(tr)[-1]["parent"] is None


def test_each_thread_has_its_own_stack():
    tr = Tracer(enabled=True)
    opened, release = threading.Event(), threading.Event()

    def other():
        with tr.span("other_root"):
            opened.set()
            release.wait(10)

    t = threading.Thread(target=other)
    with tr.span("main_root"):
        t.start()
        assert opened.wait(10)
        with tr.span("main_child"):
            pass
        release.set()
        t.join(10)
    assert not t.is_alive()
    spans = {s["name"]: s for s in _spans(tr)}
    assert spans["other_root"]["parent"] is None
    assert spans["main_child"]["parent"] == spans["main_root"]["id"]


def test_overflowing_ring_counts_dropped():
    tr = Tracer(capacity=4, enabled=True)
    for r in range(3):
        with tr.span("s", round=r):
            pass
    assert tr.dropped == 0
    tr.emit("e")
    for r in range(3, 6):
        with tr.span("s", round=r):
            pass
    assert len(tr) == 4 and tr.dropped == 3
    assert [e.get("round") for e in tr.events()] == [None, 3, 4, 5]
    tr.enable(capacity=2)  # shrinking drops the oldest, and counts them
    assert tr.dropped == 5 and len(tr) == 2
    tr.clear()
    assert tr.dropped == 0 and len(tr) == 0


def test_spans_share_the_profilers_clock():
    """A CPU op run inside a span padded by 1-ms sleeps starts, on the
    profiler's host clock, between the span's t0_ns and t1_ns."""
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer(enabled=True)
    a = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        time.sleep(0.001)
        with tr.span("op"):
            time.sleep(0.001)
            torch.add(a, 1)
            time.sleep(0.001)
        time.sleep(0.001)
    (span,) = _spans(tr)
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::add"]
    assert len(starts) == 1
    assert span["t0_ns"] + 1_000_000 <= starts[0] <= span["t1_ns"] - 1_000_000


# -- the engine path ----------------------------------------------------------

def _otr_inputs(n=8, S=4, V=4, seed=3):
    gen = torch.Generator().manual_seed(seed)
    mix = fast.standard_mix(gen, S, n, device=CPU)
    st = OtrState.fresh(torch.arange(n, dtype=torch.int32) % V, S, n)
    return fast.OtrHist(n_values=V), st, mix


def test_run_hist_records_each_rounds_steps_under_one_root(traced):
    rnd, st, mix = _otr_inputs()
    rounds = 3
    want = fast.run_hist(rnd, st, lambda s: s.decided, mix, rounds,
                         mode="hash")
    spans = _spans(traced)
    by_id = _by_id(spans)
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "engine.run_hist"
    for s in spans:
        assert _root_of(s, by_id) is root
    steps = [(s["name"], s["round"]) for s in spans
             if s["name"] in ROUND_STEPS]
    assert sorted(steps) == sorted((name, r) for r in range(rounds)
                                   for name in ROUND_STEPS)
    for s in spans:
        if s["name"] in ROUND_STEPS:
            assert s["parent"] == root["id"]
    # in time order within a round: params, exchange, update, freeze
    for r in range(rounds):
        t0 = [next(s["t0_ns"] for s in spans
                   if s["name"] == name and s["round"] == r)
              for name in ROUND_STEPS]
        assert t0 == sorted(t0)
    # the plain versions launch nothing, so no launch span on the CPU
    assert not [s for s in spans if s["name"].startswith("fused.")]
    assert {s["name"] for s in spans} == {"engine.run_hist", *ROUND_STEPS}
    assert traced.dropped == 0
    # tracing changes no result
    TRACE.disable()
    got = fast.run_hist(rnd, st, lambda s: s.decided, mix, rounds,
                        mode="hash")
    assert len(tree_leaves(want)) == 6  # x, decided, decision, after, ...
    for a, b in zip(tree_leaves(want), tree_leaves(got), strict=True):
        assert torch.equal(a, b)


def _entry_spans(tr, root_name):
    spans = _spans(tr)
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == root_name
    (fresh,) = [s for s in spans if s["name"] == "engine.require_fresh"]
    assert fresh["parent"] == root["id"]
    assert root["t0_ns"] <= fresh["t0_ns"] <= fresh["t1_ns"] <= root["t1_ns"]
    return spans, fresh


def test_k1_entries_record_their_reads_of_state0(traced):
    rnd, st, mix = _otr_inputs()
    fast.run_otr_loop(rnd, st, mix, 3, mode="hash")
    _, fresh = _entry_spans(traced, "engine.run_otr_loop")
    assert fresh["reads"] == 2

    traced.clear()
    n, S = 8, 4
    bst = BenOrState.fresh(torch.arange(n) % 2, S, n)
    fast.run_benor_loop(fast.BenOrHist(), bst, mix, 4, mode="hash")
    _, fresh = _entry_spans(traced, "engine.run_benor_loop")
    assert fresh["reads"] == 3

    traced.clear()
    fst = FloodMinState.fresh(torch.arange(n, dtype=torch.int32) % 4, S, n)
    fast.run_floodmin_loop(fast.FloodMinHist(n_values=4, f=1), fst, mix, 3,
                           mode="hash")
    _, fresh = _entry_spans(traced, "engine.run_floodmin_loop")
    assert fresh["reads"] == 1


def test_a_refused_entry_still_closes_its_spans(traced):
    rnd, st, mix = _otr_inputs()
    with pytest.raises(ValueError, match="fresh state0"):
        fast.run_otr_loop(rnd, st.replace(decided=~st.decided), mix, 3)
    spans, _ = _entry_spans(traced, "engine.run_otr_loop")
    assert len(spans) == 2
    fast.run_otr_loop(rnd, st, mix, 3, mode="hash")
    assert [s["parent"] for s in _spans(traced)
            if s["name"] == "engine.run_otr_loop"] == [None, None]


# -- on the card --------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the launch spans wrap the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_launch_spans_on_the_card(dev, traced):
    n, S, V = 64, 16, 4
    gen = torch.Generator(device=dev).manual_seed(5)
    mix = fast.standard_mix(gen, S, n, device=dev)
    st = OtrState.fresh(torch.arange(n, dtype=torch.int32, device=dev) % V,
                        S, n)
    fast.run_otr_loop(fast.OtrHist(n_values=V), st, mix, 6, mode="hw")
    torch.cuda.synchronize()
    spans = _spans(traced)
    by_id = _by_id(spans)
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "engine.run_otr_loop"
    (inputs,) = [s for s in spans if s["name"] == "fused.inputs"]
    (launch,) = [s for s in spans if s["name"] == "fused.launch"]
    assert launch["kernel"] == "otr_loop_hw"
    assert _root_of(inputs, by_id) is root and _root_of(launch, by_id) is root
    assert inputs["t1_ns"] <= launch["t0_ns"]


@pytest.mark.cuda
def test_k2_launch_spans_on_the_card(dev, traced):
    n, S, V, rounds = 64, 16, 4, 4
    gen = torch.Generator(device=dev).manual_seed(6)
    mix = fast.standard_mix(gen, S, n, device=dev)
    st = OtrState.fresh(torch.arange(n, dtype=torch.int32, device=dev) % V,
                        S, n)
    fast.run_hist(fast.OtrHist(n_values=V), st, lambda s: s.decided, mix,
                  rounds, mode="hash")
    torch.cuda.synchronize()
    spans = _spans(traced)
    by_id = _by_id(spans)
    launches = [s for s in spans if s["name"] == "fused.launch"]
    assert [s["kernel"] for s in launches] == ["hist_exchange_counts"] * rounds
    for s in launches + [s for s in spans if s["name"] == "fused.inputs"]:
        parent = by_id[s["parent"]]
        assert parent["name"] == "round.exchange"
        assert by_id[parent["parent"]]["name"] == "engine.run_hist"


# -- the vocabulary lint ------------------------------------------------------

ENGINE_SPANS = {"engine.run_otr_loop", "engine.run_benor_loop",
                "engine.run_floodmin_loop", "engine.run_hist",
                "engine.require_fresh", *ROUND_STEPS, "fused.inputs",
                "fused.launch"}


def test_obs_vocab_sweeps_the_shipped_spans():
    from round_tpu_torch.analysis import runtimerules as rr
    from round_tpu_torch.analysis.runtimelint import default_config

    cfg = default_config()
    sweep = rr.sweep_emissions(cfg.obs_files, cfg.dynamic_names)
    assert set(sweep.spans) == ENGINE_SPANS
    assert set(rr.parse_doc_spans(cfg.docs_file)) == ENGINE_SPANS
    assert "span" in sweep.events
    assert rr.obs_vocab(sweep, cfg.docs_file) == []


def test_obs_vocab_diffs_spans_both_ways(tmp_path):
    from round_tpu_torch.analysis import runtimerules as rr

    src = tmp_path / "mod.py"
    src.write_text(
        "from round_tpu_torch.obs.trace import NOSPAN, TRACE\n"
        "def f(name):\n"
        "    with TRACE.span('a.opened') if TRACE.enabled else NOSPAN:\n"
        "        pass\n"
        "    with TRACE.span('a.documented'):\n"
        "        pass\n"
        "    with TRACE.span(name):\n"
        "        pass\n")
    doc = tmp_path / "OBS.md"
    doc.write_text(
        "| ev | fields | by |\n| --- | --- | --- |\n"
        "| `span` | `name` | spans |\n\n"
        "| span | fields | read as |\n| --- | --- | --- |\n"
        "| `a.documented` | — | x |\n| `a.stale` | — | y |\n\n"
        "Prose may name `a.documented` too.\n")
    sweep = rr.sweep_emissions([str(src)], ())
    assert set(sweep.spans) == {"a.opened", "a.documented"}
    assert [f.rule for f in sweep.findings] == [
        "counter-accounting/dynamic-name"]
    found = {(f.rule, f.message.split("'")[1])
             for f in rr.obs_vocab(sweep, str(doc))}
    assert found == {("obs-vocab/undocumented", "a.opened"),
                     ("obs-vocab/unemitted", "a.stale")}
