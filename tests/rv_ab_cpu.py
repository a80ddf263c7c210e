"""The runtime-verification overhead A/B of both packages on the CPU, at
round_tpu's soak gate settings (tools/soak.py::check_host_rv: LastVoting,
n=4, 24 instances, 8 lanes, 300-ms rounds, 3 interleaved pairs, 1 warmup
pair).

Each run is a fresh process that calls one package's
``apps.host_perftest.measure_rv_ab`` (the port's with ``device="cpu"``);
the runs alternate between the packages.  One JSON line per run (the
ratio monitors-on / monitors-off, mean and median, and the gate's
verdict), then a summary line.  Not collected by pytest: run it as

    JAX_PLATFORMS=cpu python tests/rv_ab_cpu.py [--runs 3]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETTINGS = dict(n=4, instances=24, lanes=8, timeout_ms=300, pairs=3,
                warmup=1, algo="lv")

_RUN = """
import json, torch
torch.set_num_threads(1)
{imports}
res = measure_rv_ab(**{settings}{extra})
ex = res["extra"]
print(json.dumps(dict(package={package!r}, ratio=res["value"],
                      median_ratio=ex["median_on"] / max(ex["median_off"],
                                                         1e-9),
                      dps_off=ex["dps_off"], dps_on=ex["dps_on"],
                      rv_checks=ex["rv_checks"],
                      rv_violations=ex["rv_violations"],
                      logs_identical=ex["logs_identical"],
                      gate_ok=rv_gate(res)["ok"])))
"""

_IMPORTS = {
    "round_tpu": (
        "import jax\njax.config.update('jax_platforms', 'cpu')\n"
        "from round_tpu.apps.host_perftest import measure_rv_ab\n"
        "from round_tpu_torch.apps.host_perftest import rv_gate\n"),
    "round_tpu_torch": (
        "from round_tpu_torch.apps.host_perftest import measure_rv_ab, "
        "rv_gate\n"),
}


def run_one(package: str) -> dict:
    extra = ", device='cpu'" if package == "round_tpu_torch" else ""
    code = _RUN.format(imports=_IMPORTS[package], settings=SETTINGS,
                       extra=extra, package=package)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-2000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3,
                    help="runs of each package, alternating")
    args = ap.parse_args()
    rows = []
    for _ in range(args.runs):
        for package in ("round_tpu", "round_tpu_torch"):
            row = run_one(package)
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {"settings": SETTINGS}
    for package in ("round_tpu", "round_tpu_torch"):
        r = [x["ratio"] for x in rows if x["package"] == package]
        summary[package] = dict(ratios=r, mean=statistics.mean(r),
                                spread=max(r) - min(r))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
