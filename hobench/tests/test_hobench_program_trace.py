"""The program's spans against a trace, on events written by hand: each
device operation under the spans open at its runtime call, idle gaps
named `<step>:<span>` whose entries sum by step to reduce_trace's, and
readings that read nothing from a trace the tracer truncated.  Then one
tiny run of each cell through hobench/program_trace.py on the CPU."""

import contextlib
import io
import json

import pytest
import torch

from hobench import program_trace as pt
from hobench import trace
from hobench.tests.hobench_util import cells, copy_root

torch.set_num_threads(1)


def _span(i, name, t0, t1, parent=None, **fields):
    return dict(ev="span", name=name, t0_ns=t0, t1_ns=t1, id=i,
                parent=parent, t=t0 / 1e9, **fields)


EVS = [
    ("span", "batch", 0, 100), ("span", "salts", 0, 10),
    ("span", "engine", 10, 60), ("span", "summary", 60, 100),
    ("span", "batch", 100, 200), ("span", "engine", 100, 150),
    ("span", "summary", 150, 200),
    ("launch", 1, 5), ("launch", 2, 22), ("launch", 3, 31),
    ("launch", 4, 40), ("launch", 5, 65), ("launch", 6, 121),
    ("launch", 7, 9),
    ("device", "draw", 6, 8, 1),
    ("device", "fill", 9, 10, 7),
    ("device", "compare", 23, 25, 2),                  # require_fresh
    ("device", "void hist_exchange_kernel<true>", 32, 45, 3),
    ("device", "add", 45, 52, 4),                      # round.update
    ("device", "scatter", 66, 70, 5),                  # summary, no span
    ("device", "void hist_exchange_kernel<true>", 122, 180, 6),
]
PROGRAM = [
    _span(1, "engine.run_hist", 11, 58),
    _span(2, "engine.require_fresh", 20, 28, 1, reads=2),
    _span(3, "round.exchange", 30, 35, 1, round=0),
    _span(4, "fused.launch", 31, 33, 3, kernel="hist_exchange"),
    _span(5, "round.update", 38, 42, 1, round=0),
    _span(6, "engine.run_hist", 110, 148),
    _span(7, "round.exchange", 120, 125, 6, round=0),
    _span(8, "fused.launch", 121, 122, 7, kernel="hist_exchange"),
    _span(9, "round.freeze", 130, 140, 6, round=0),
]


def test_ops_take_the_path_of_the_spans_open_at_their_launch():
    got = pt.reduce_program(EVS, PROGRAM, dropped=0)
    assert got.batches == 2
    assert [(path, name) for path, name, _ in got.ops] == [
        ("", "draw"), ("", "fill"),
        ("engine.run_hist/engine.require_fresh", "compare"),
        ("engine.run_hist/round.exchange/fused.launch",
         "void hist_exchange_kernel<true>"),
        ("engine.run_hist/round.update", "add"),
        ("", "scatter"),
        ("engine.run_hist/round.exchange/fused.launch",
         "void hist_exchange_kernel<true>"),
    ]
    assert got.host_ns == {"engine.run_hist": 47 + 38,
                           "engine.require_fresh": 8,
                           "round.exchange": 10, "fused.launch": 3,
                           "round.update": 4, "round.freeze": 10}


def test_idle_gaps_name_the_innermost_span_and_sum_by_step():
    got = pt.reduce_program(EVS, PROGRAM, dropped=0)
    # gaps 0..6 and 8..9 begin in salts; 10..23 in engine before the
    # root opens; 25..32 inside require_fresh; 52..66 under the root
    # alone; 70..122 and 180..200 in summary, where no span is open
    assert got.idle_ns == {"salts": 6 + 1, "engine": 13,
                           "engine:engine.require_fresh": 7,
                           "engine:engine.run_hist": 14,
                           "summary": 52 + 20}
    by_step = {}
    for name, ns in got.idle_ns.items():
        step = name.split(":")[0]
        by_step[step] = by_step.get(step, 0) + ns
    assert by_step == trace.reduce_trace(EVS).idle_by_step
    assert got.idle_gaps(2) == [["summary", 72e-9],
                                ["engine:engine.run_hist", 14e-9]]


def test_readings_from_the_spans_and_none_when_dropped():
    got = pt.reduce_program(EVS, PROGRAM, dropped=0)
    r = got.readings()
    assert r["engine_sync_ms"] == 8 / 1e6 / 2
    assert r["round_exchange_ms"] == 0.0  # K2 left out
    assert r["round_update_ms"] == 7 / 1e6 / 2
    # round.freeze opened and launched nothing; round.params never opened
    assert r["round_freeze_ms"] == 0.0 and r["round_params_ms"] is None
    truncated = pt.reduce_program(EVS, PROGRAM, dropped=1).readings()
    assert truncated == dict.fromkeys(pt.READINGS)
    # a program that opens no span reads nothing, not 0
    silent = pt.reduce_program(EVS, [], dropped=0)
    assert silent.readings() == dict.fromkeys(pt.READINGS)
    assert silent.idle_ns == trace.reduce_trace(EVS).idle_by_step
    # no K2 launch, no round readings; no require_fresh, no sync reading
    k1 = [e for e in EVS if "hist_exchange" not in str(e[1])]
    r = pt.reduce_program(k1, PROGRAM[:2], dropped=0).readings()
    assert r["engine_sync_ms"] == 8 / 1e6 / 2
    assert all(r[k] is None for k in pt.READINGS[1:])
    assert pt.reduce_program([("device", "k", 0, 1, 0)], PROGRAM, 0) is None


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("traced", [0, 1])
def test_one_tiny_run_of_each_cell(tmp_path, cell, traced):
    root = copy_root(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pt.main(["--workload", cell, "--seed", str(2**31 + 5),
                      "--seconds", "0", "--trace", str(traced)],
                     root=root, device="cpu")
    assert rc == 0
    *_, result, spans = [json.loads(x) for x in
                         out.getvalue().strip().splitlines()]
    assert result["correct"] is True
    line = spans["program_spans"]
    assert line["dropped"] == 0 and line["batches"] >= 4
    root_span = ("engine.run_hist" if cell.endswith("perround") else
                 "engine.run_benor_loop" if cell.startswith("benor")
                 else "engine.run_otr_loop")
    assert line["host_ms"][root_span] > 0
    if root_span == "engine.run_hist":
        assert {"round.params", "round.exchange", "round.update",
                "round.freeze"} <= set(line["host_ms"])
    else:
        assert line["readings"]["engine_sync_ms"] > 0
        assert line["readings"]["engine_sync_ms"] <= line["step_ms"][
            "engine"]
    from round_tpu_torch.obs.trace import TRACE
    assert not TRACE.enabled
    # the hooks are gone again
    assert trace.reduce_trace.__module__ == "hobench.trace"
    assert trace.Spans.__module__ == "hobench.trace"
