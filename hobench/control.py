"""The readings that the correctness check's limits are set from, for one
cell, on the card it names (or on the CPU for a test):

    python3 hobench/control.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3]

For each seed it runs the cell's set-up and a short window (WINDOW_S, at
least check.SAMPLE_BATCHES batches) at the cell's own sizes, whose
batches are sampled as a benchmark run samples them, and prints one JSON
line: `program`, the numbers the run's check compares, and for the
control seeds `control`, the same numbers when the reference drawing its
links from Philox4x32-7 (three rounds short of the configuration's
Philox4x32-10) stands in the program's place.  The limits lie above the
program's largest reading and below the control's smallest; the
benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from hobench import check, run  # noqa: E402
from hobench.drivers import batch  # noqa: E402

CONTROL_PHILOX_ROUNDS = 7
WINDOW_S = 2.0


def readings(cell, seed: int, device, control: bool) -> dict:
    rec = batch.run(cell, seed, WINDOW_S, False, device, time.perf_counter())
    got = {"seed": seed, "batches": len(rec.window),
           "lanes_checked": int(rec.check_init.numel()),
           "program": rec.numbers}
    if control:
        cfg = cell.config
        want = cell.reference.run(rec.check_rows, rec.check_init, cfg)
        weak = cell.reference.run(rec.check_rows, rec.check_init, cfg,
                                  philox_rounds=CONTROL_PHILOX_ROUNDS)
        got["control"] = check.compare(weak, want, cell.algo.FIELDS)
    return got


def main(argv=None, root: Path = ROOT, device=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = run.load_cell(root, args.workload)
    import torch

    if device is None:
        run.require_cards(cell.chips)
        device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(control - set(seeds)):
        print(json.dumps(readings(cell, seed, torch.device(device),
                                  seed in control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
