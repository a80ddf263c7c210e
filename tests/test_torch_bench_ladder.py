"""The bench's ladder arm and --lite (round_tpu_torch/bench.py).

Option meanings and precedence follow round_tpu's bench.py:162-181 and
apply_lite: --lite runs S=1,000 x 10 rounds and implies --no-ladder
(overriding --ladder), --ladder-only names rungs and runs them whatever
--lite or --no-ladder say, and the ladder is on by default only on a CUDA
device.  The runs are tiny, on the CPU: the flagship line first, then one
line per named rung in the ladder's order, and ``main`` returns the
flagship's dict."""

import json

import pytest
import torch

from round_tpu_torch import bench

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
CUDA = torch.device("cuda")


@pytest.mark.parametrize("argv,cpu_rungs,cuda_rungs", [
    ([], [], ["otr4", "floodmin", "lv", "benor", "epsilon"]),
    (["--ladder"], ["otr4", "floodmin", "lv", "benor", "epsilon"],
     ["otr4", "floodmin", "lv", "benor", "epsilon"]),
    (["--no-ladder"], [], []),
    (["--ladder", "--no-ladder"], ["otr4", "floodmin", "lv", "benor",
                                   "epsilon"],
     ["otr4", "floodmin", "lv", "benor", "epsilon"]),
    (["--lite"], [], []),
    (["--lite", "--ladder"], [], []),
    (["--ladder-only", "epsilon,lv"], ["lv", "epsilon"], ["lv", "epsilon"]),
    (["--ladder-only", "epsilon,lv", "--lite"], ["lv", "epsilon"],
     ["lv", "epsilon"]),
    (["--ladder-only", "benor", "--no-ladder"], ["benor"], ["benor"]),
])
def test_ladder_options(argv, cpu_rungs, cuda_rungs):
    args = bench.parse_args(argv)
    assert bench.ladder_rungs(args, CPU) == cpu_rungs
    assert bench.ladder_rungs(args, CUDA) == cuda_rungs


def test_lite_overrides():
    args = bench.parse_args(["--lite", "--scenarios", "50", "--phases", "3",
                             "--repeats", "5", "--parity", "8"])
    assert (args.scenarios, args.phases, args.repeats, args.parity) == (
        1000, 10, 2, 4)
    assert args.no_ladder and not args.ladder
    args = bench.parse_args(["--scenarios", "50", "--repeats", "5"])
    assert (args.scenarios, args.repeats, args.lite) == (50, 5, False)


def test_unknown_rung_fails_before_the_run():
    with pytest.raises(SystemExit, match="unknown ladder rung"):
        bench.main(["--device", "cpu", "--ladder-only", "epsilon,pbft"])


def _lines(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_lite_run_on_cpu(capsys):
    res = bench.main(["--device", "cpu", "--n", "16", "--lite",
                      "--repeats", "1", "--parity", "2"])
    lines = _lines(capsys.readouterr().out)
    assert lines == [res]
    assert res["metric"] == "otr_n16_s1000_rounds_per_sec"
    ex = res["extra"]
    assert ex["lite"] is True and ex["scenarios"] == 1000
    assert ex["rounds_per_run"] == 10 and ex["parity_frac"] == 1.0
    # S=1,000 of the full 10,000: a tenth of the rate, rounded to 2 places
    # (the value to 3)
    assert ex["extrapolated_flagship_rps"] == pytest.approx(
        res["value"] / 10, abs=0.0051)


def test_ladder_only_run_on_cpu(capsys):
    res = bench.main(["--device", "cpu", "--n", "16", "--scenarios", "8",
                      "--phases", "4", "--repeats", "1", "--parity", "0",
                      "--ladder-only", "epsilon,lv", "--ladder-n", "16",
                      "--ladder-scenarios", "4"])
    lines = _lines(capsys.readouterr().out)
    assert [ln["metric"] for ln in lines] == [
        "otr_n16_s8_rounds_per_sec", "ladder_lv_n16", "ladder_epsilon_n16"]
    assert lines[0] == res
    lv, eps = lines[1]["extra"], lines[2]["extra"]
    assert lv["parity_frac"] == 1.0 and lv["backend"] == "cpu"
    assert eps["parity_exact"] is True and eps["property_parity"] is True
