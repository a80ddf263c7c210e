"""Every cell of BENCHMARK.json at a tiny size through the program's plain
CPU path: correct against the reference, and not correct when the timed
path is broken underneath or the control stands in its place."""

import json

import pytest
import torch

from hobench import control, run
from hobench.tests.hobench_util import cells, copy_root, run_cell

torch.set_num_threads(1)


@pytest.mark.parametrize("cell", cells())
def test_cell_correct_on_cpu(tmp_path, cell):
    rc, res = run_cell(copy_root(tmp_path), cell)
    assert rc == 0
    assert res["correct"] is True
    assert list(res)[-1] == "check"
    assert all(v["value"] == 0 for v in res["check"].values())
    names = {m["name"] for m in json.loads(
        (tmp_path / "root" / "BENCHMARK.json").read_text())["end_to_end"]}
    assert set(res["metrics"]) == names
    assert res["metrics"]["scen_rounds_per_s"]["value"] > 0


@pytest.mark.parametrize("cell", cells())
def test_traced_cell_on_cpu(tmp_path, cell):
    rc, res = run_cell(copy_root(tmp_path), cell, trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["device"]["window_s"] > 0
    assert "breakdown" in res


def _unchanged(prog, state0, mix):
    """A step that returns its state unchanged."""
    out = {name: getattr(state0, name) for name in vars(state0)
           if getattr(state0, name) is not None}
    out["done"] = torch.zeros_like(state0.decided)
    out["decided_round"] = torch.full_like(state0.x, -1, dtype=torch.int32)
    return {k: out[k] for k in prog.FIELDS}


def _half(prog, state0, mix):
    """Half of the batch left out: the second half's answers are copies of
    the first half's."""
    out = prog.real_run(state0, mix)
    half = out["x"].shape[0] // 2
    return {k: torch.cat([v[:half], v[:half], v[2 * half:]])
            for k, v in out.items()}


def _altered(prog, state0, mix):
    """An answer altered where it is produced: one lane's decision in every
    scenario."""
    out = dict(prog.real_run(state0, mix))
    dec = out["decision"].clone()
    lane = torch.arange(dec.shape[0]) % dec.shape[1]
    rows = torch.arange(dec.shape[0])
    if dec.dtype == torch.bool:
        dec[rows, lane] = ~dec[rows, lane]
    else:
        dec[rows, lane] = dec[rows, lane] + 1
    out["decision"] = dec
    return out


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", cells())
def test_broken_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root = copy_root(tmp_path)
    loaded = run.load_cell(root, cell)
    algo = loaded.algo
    real = algo.Program.run

    def broken(self, state0, mix):
        self.FIELDS = algo.FIELDS
        self.real_run = lambda s, m: real(self, s, m)
        return fault(self, state0, mix)

    monkeypatch.setattr(algo.Program, "run", broken)
    monkeypatch.setattr(run, "load_cell", lambda r, w: loaded)
    rc, res = run_cell(root, cell)
    assert rc == 0
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values())


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(tmp_path, capsys, monkeypatch, cell):
    """The reference drawing from Philox4x32-7 in the program's place
    fails the check on every seed; the program passes it."""
    monkeypatch.setattr(control, "WINDOW_S", 0.2)
    root = copy_root(tmp_path)
    control.main(["--workload", cell, "--seeds", "3,4",
                  "--control-seeds", "3,4"], root=root, device="cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    for line in lines:
        assert all(v == 0 for v in line["program"].values())
        assert any(v > 0 for v in line["control"].values())
