"""The benchmark of round_tpu_torch: one run of one cell.

    python3 hobench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

run from the root of a checkout that holds BENCHMARK.json, this folder and
round_tpu_torch.  The cell is an entry of BENCHMARK.json's `workloads`; its
configuration's file (hobench/configs/), its traffic
(hobench/traffic/<traffic>.json) and the algorithm the configuration
names (hobench/algos/ and hobench/reference/) are found by name, and so is
the reader of each metric (hobench/metrics/<metric>.py).  One driver
(hobench/drivers/batch.py) runs every cell.  Adding a cell, a
configuration, a traffic mix or a metric adds files and entries and edits
none.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `check`, each compared number with its limit.  The compared
numbers are also the last lines of standard error.  The run exits with 2,
and prints no result, where torch finds fewer CUDA cards than the cell
asks for, and with 3 where the JAX package, JAX, jaxlib, flax or the root
bench.py was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "round_tpu", "bench")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_module(root: Path, kind: str, name: str):
    """hobench/<kind>/<name>.py under `root`, loaded by its path."""
    path = root / "hobench" / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"hobench: no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"hobench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell's entry, configuration, traffic, algorithm, reference and
    metrics, all found by name from BENCHMARK.json."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"hobench: no workload {workload!r}; "
                         f"known: {sorted(cells)}")
    entry = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (root / "hobench" / "traffic" / f"{entry['traffic']}.json")
        .read_text())

    def ours(metric):
        return workload in metric.get("workloads", (workload,))

    e2e = [m for m in bench["end_to_end"] if ours(m)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if ours(m) and ("workloads" in m or m["moves"] in moved)]
    return SimpleNamespace(
        name=workload, entry=entry, config=config, traffic=traffic,
        chips=entry["chips"], end_to_end=e2e, per_layer=per_layer,
        algo=load_module(root, "algos", config["algorithm"]),
        reference=load_module(root, "reference", config["algorithm"]),
        root=root)


def require_cards(chips: int) -> None:
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"hobench: the cell asks for {chips} CUDA card(s); torch "
              f"finds {found}", file=sys.stderr)
        raise SystemExit(2)


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def read_metrics(cell, metrics, ctx) -> dict:
    out = {}
    for m in metrics:
        value = load_module(cell.root, "metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, root: Path = ROOT, device=None, t0: float = T0) -> int:
    """One run.  `device` None asks for the cell's CUDA cards; the tests
    pass a CPU device, which runs the program's plain versions."""
    args = parse_args(argv)
    cell = load_cell(root, args.workload)
    import torch

    from hobench.drivers import batch

    torch.set_num_threads(1)  # one process, few threads: a steadier host
    if device is None:
        require_cards(cell.chips)
        device = torch.device("cuda", 0)
    rec = batch.run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device(device), t0)
    ctx = SimpleNamespace(cell=cell, record=rec)
    metrics = read_metrics(
        cell, cell.per_layer if args.trace else cell.end_to_end, ctx)
    found = forbidden_modules()
    if found:
        print(f"hobench: the run loaded {found}", file=sys.stderr)
        return 3
    from hobench import check

    numbers = rec.numbers
    device = torch.device(device)
    result = {
        "correct": check.passed(numbers),
        "attempted": len(rec.window),
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": rec.memory_peak_bytes,
        },
    }
    if args.trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["check"] = {k: {"value": v, "limit": check.LIMITS[k]}
                       for k, v in numbers.items()}
    print("setup " + " ".join(f"{k}={v:.3f}s" for k, v in
                              rec.setup_parts.items()), file=sys.stderr)
    print(f"check sampled batches {rec.check_ordinals} of "
          f"{len(rec.window)}", file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k}={v} limit={check.LIMITS[k]}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
