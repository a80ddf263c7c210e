"""What the harness and its reference load, by whole top-level module
names: neither JAX, jaxlib, flax, the JAX package (round_tpu) nor the
root bench.py; the reference not even the program (round_tpu_torch)."""

import json
import os
import subprocess
import sys

import pytest

from hobench.tests.hobench_util import REPO, copy_root

FORBIDDEN = {"jax", "jaxlib", "flax", "round_tpu", "bench"}

HARNESS = """
import json, sys
sys.path.insert(0, {root!r})
from pathlib import Path
import hobench.run as run, hobench.control, hobench.check, hobench.trace
for cell in [w["name"] for w in json.load(open({bench!r}))["workloads"]]:
    c = run.load_cell(Path({root!r}), cell)
    for m in c.end_to_end + c.per_layer:
        run.load_module(Path({root!r}), "metrics", m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import hobench.reference.otr, hobench.reference.benor
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_nor_round_tpu():
    names = _top_level(HARNESS.format(root=str(REPO),
                                      bench=str(REPO / "BENCHMARK.json")))
    assert "round_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _top_level(REFERENCE.format(root=str(REPO)))
    assert not names & (FORBIDDEN | {"round_tpu_torch"})


def test_run_refuses_without_cards():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "hobench/run.py", "--workload", "otr_n1024.mixed4",
         "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_run_fails_without_the_program(tmp_path):
    root = copy_root(tmp_path, shrink=False)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "hobench/run.py", "--workload", "otr_n1024.mixed4",
         "--seed", "1", "--seconds", "1"],
        cwd=root, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
