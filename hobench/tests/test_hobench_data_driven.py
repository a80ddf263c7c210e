"""A cell, a configuration, a traffic mix and a per-layer metric are added
with new files and new entries of BENCHMARK.json alone: the harness finds
and runs them, and no file it already had changes."""

import hashlib
import json

import torch

from hobench.tests.hobench_util import copy_root, run_cell

torch.set_num_threads(1)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "hobench").rglob("*") if p.is_file()}


def test_throwaway_cell_from_data_files(tmp_path):
    root = copy_root(tmp_path, shrink=False)
    before = _digests(root)
    hb = root / "hobench"
    (hb / "configs" / "otr_n12.json").write_text(json.dumps({
        "algorithm": "otr", "n": 12, "num_values": 3, "after_decision": 3,
        "rounds": 9, "link_mode": "hash"}))
    (hb / "traffic" / "crash_only.json").write_text(json.dumps({
        "engine": "hist", "scenarios": 6, "init": {"values": 3},
        "families": [{"name": "crash", "crash_fraction": 0.3,
                      "crash_round": 2}],
        "check": {"per_family": 3}, "trace_batches": 6}))
    (hb / "metrics" / "batches_traced.py").write_text(
        '"""Batches in the traced window."""\n\n\n'
        "def read(ctx):\n    return float(len(ctx.record.window))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "otr_n12", "source": "https://example.org/otr",
        "file": "hobench/configs/otr_n12.json", "reduced": [],
        "why": "a throwaway"})
    bench["workloads"].append({
        "name": "otr_n12.crash_only", "config": "otr_n12",
        "traffic": "crash_only", "chips": 1, "why": "a throwaway"})
    bench["per_layer"].append({
        "name": "batches_traced", "unit": "batches", "better": "higher",
        "source": "host_clock", "layer": "harness",
        "moves": "scen_rounds_per_s", "workloads": ["otr_n12.crash_only"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    rc, res = run_cell(root, "otr_n12.crash_only")
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"scen_rounds_per_s", "batch_p95_ms",
                                   "setup_s"}
    rc, res = run_cell(root, "otr_n12.crash_only", trace=1)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["batches_traced"]["value"] >= 4
    # the per-layer metrics of the other cells are not read here
    assert "k1_roofline" not in res["metrics"]
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
