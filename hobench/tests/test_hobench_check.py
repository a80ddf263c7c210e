"""The check samples its batches from the whole window, not from its start:
a fault that shows only late in the window is caught."""

import pytest
import torch

from hobench import check, run
from hobench.tests.hobench_util import copy_root, edit_json, run_cell

torch.set_num_threads(1)


def _batch(i: int, S: int = 8, n: int = 3) -> dict:
    """A stand-in for one batch of the window: its inputs and outputs, each
    holding the batch's ordinal."""
    full = torch.full((S, n), i, dtype=torch.int32)
    return {"structure": {"crashed": full.bool(), "p8": full[:, 0]},
            "salt0": full[:, 0], "salt1": full[:, 0], "init": full,
            "out": {"x": full, "done": full.bool()}}


def _ordinals(seed: int, batches: int):
    sample = check.Sample(seed, per_family=2, families=2)
    for i in range(batches):
        sample.offer(_batch(i))
    return sample


def test_sample_is_drawn_from_the_seed_and_spans_the_window():
    late = 0
    for seed in range(50):
        sample = _ordinals(seed, 1000)
        ords = sample.ordinals()
        assert len(ords) == check.SAMPLE_BATCHES
        assert ords == _ordinals(seed, 1000).ordinals()
        late += sum(o >= 500 for o in ords)
        rows, init, outs = sample.gather()
        # every kept row is its batch's, in window order
        assert init[:, 0].tolist() == [o for o in ords for _ in range(4)]
        assert outs["x"].dtype == torch.int64
        assert torch.equal(rows["salt0"], init[:, 0])
    # about half of a uniform sample lies in the window's second half
    assert 0.35 * 200 <= late <= 0.65 * 200


def test_short_window_keeps_every_batch():
    assert _ordinals(7, check.SAMPLE_BATCHES).ordinals() == list(
        range(check.SAMPLE_BATCHES))


@pytest.mark.parametrize("cell", ["otr_n1024.mixed4", "otr_n1024.perround"])
def test_fault_late_in_the_window_is_not_correct(tmp_path, monkeypatch,
                                                 cell):
    """Every answer right until the window's 24th batch, one decision
    altered in every scenario after it: a 40-batch traced window reads
    not correct."""
    root = copy_root(tmp_path)
    edit_json(root / "hobench" / "traffic" /
              f"{cell.split('.')[1]}.json", trace_batches=40)
    loaded = run.load_cell(root, cell)
    real = loaded.algo.Program.run
    calls = []

    def late_fault(self, state0, mix):
        out = dict(real(self, state0, mix))
        calls.append(None)
        if len(calls) > 2 + 24:  # the warm-up's two, then the window's
            dec = out["decision"].clone()
            dec[:, 0] += 1
            out["decision"] = dec
        return out

    monkeypatch.setattr(loaded.algo.Program, "run", late_fault)
    monkeypatch.setattr(run, "load_cell", lambda r, w: loaded)
    rc, res = run_cell(root, cell, trace=1, seconds=1e9)
    assert rc == 0 and res["attempted"] == 40
    assert res["correct"] is False
    assert res["check"]["lanes_differing"]["value"] > 0
