"""The port's bisect tool (round_tpu_torch.tools.bisect), run on the CPU
through the plain versions: every stage of tools/tpu_bisect.py's list (with
hist_tiny in loop_flat_tiny's place), one JSON line each, and an exit code
that says whether a stage failed."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from round_tpu_torch.tools import bisect

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _run(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "round_tpu_torch.tools.bisect", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_bisect_driver_on_cpu():
    out = _run("--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.strip()]
    assert [next(iter(r)) for r in lines] == bisect.STAGES
    results = {k: v for r in lines for k, v in r.items()}
    assert all(r["ok"] for r in results.values())
    assert results["probe"]["out"] == "probe: 28"
    assert results["kernel_min"]["out"] == "kernel_min: 32768.0"
    assert results["kernel_prng"]["out"] == "kernel_prng: 1"
    assert results["loop_tiny"]["out"].startswith("loop_tiny: decided=")
    assert results["hist_tiny"]["out"] == results["loop_tiny"]["out"].replace(
        "loop_tiny", "hist_tiny")
    # the CPU runs plain versions: no kernel launches
    assert all(r["launches"] == {} for r in results.values())


def test_bisect_single_stage_prints_its_launches():
    out = _run("--device", "cpu", "kernel_prng")
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["kernel_prng: 1", "launches: {}"]


def test_bisect_driver_exits_1_when_a_stage_fails(monkeypatch, capsys):
    """Asking for the card where there is none fails the stage; the
    reference's driver would still exit 0."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the stage would pass")
    monkeypatch.setattr(bisect, "STAGES", ["probe"])
    assert bisect.main(["--device", "cuda"]) == 1
    line = json.loads(capsys.readouterr().out.strip())
    assert line["probe"]["ok"] is False
    assert "CUDA is not available" in line["probe"]["err"]
