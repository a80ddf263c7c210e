"""Helpers of the benchmark's CPU tests: a copy of the benchmark's data and
code under a temporary root, shrunk to a size the CPU runs in seconds."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY_N = 16


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def cells():
    return [w["name"] for w in bench()["workloads"]]


def copy_root(tmp: Path, shrink: bool = True) -> Path:
    """BENCHMARK.json and hobench/ under `tmp`; with `shrink`, every
    configuration at n = 16 and every traffic at 8 scenarios."""
    root = tmp / "root"
    shutil.copytree(REPO / "hobench", root / "hobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    if shrink:
        for c in bench()["configs"]:
            edit_json(root / c["file"], n=TINY_N)
        for path in (root / "hobench" / "traffic").glob("*.json"):
            tr = json.loads(path.read_text())
            tr.update(scenarios=8, trace_batches=20)
            tr["check"]["per_family"] = 2
            path.write_text(json.dumps(tr))
    return root


def edit_json(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def run_cell(root: Path, cell: str, seed: int = 2**31 + 11,
             trace: int = 0, seconds: float = 0.0):
    """(exit code, the result line as a dict or None) of one run of `cell`
    on the CPU, through run.main."""
    from hobench import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
