"""Bisect which device program fails on the card: the port of
tools/tpu_bisect.py.

Each stage is a tiny self-contained program.  The driver runs every stage
as its own subprocess with a hard timeout, so a hung stage costs its
timeout and not the session, and prints one JSON line per stage.

    python -m round_tpu_torch.tools.bisect [--device cpu] STAGE  # one stage
    python -m round_tpu_torch.tools.bisect [--device cpu]        # driver

Stages, in the reference's order:

  probe         a torch.arange sum on the device (stage_probe)
  kernel_min    P1, probe_double on [128, 128] float32 (stage_pallas_min)
  kernel_prng   P2, philox_bits from seed (1, 2), [128, 128]
                (stage_pallas_prng); prints 1 when it drew more than 100
                distinct words, and fails otherwise
  loop_tiny     K1-OTR in hw mode, n=128, S=8, V=4, 5 rounds (stage_loop_tiny)
  hist_tiny     takes the place of stage_loop_flat_tiny: variant="flat" is
                a Mosaic lowering knob the port does not carry, so this
                stage runs the per-round engine (run_hist, K2 in hw mode)
                at loop_tiny's shape
  general_tiny  the ladder's otr4 rung (stage_general_tiny)
  loop_mid      K1-OTR in hw mode, n=256, S=256, V=8, 20 rounds
                (stage_loop_mid)

A stage run alone prints its result line, then ``launches: {...}`` with
the kernel launches it made; the driver carries those into the stage's
JSON line.  Unlike the reference, whose driver exits 0 whatever happened,
the driver exits 1 when any stage failed or timed out.  ``--device cpu``
runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from round_tpu_torch.utils.device import resolve_device

STAGES = ["probe", "kernel_min", "kernel_prng", "loop_tiny", "hist_tiny",
          "general_tiny", "loop_mid"]
# seconds a stage may take under the driver: a stage takes ~10 s on an
# H100, process start included, and the seven together stay under 15 min
STAGE_TIMEOUT_S = 120.0
_ROOT = Path(__file__).resolve().parents[2]
_LAUNCHES = "launches: "


def stage_probe(dev):
    """tools/tpu_bisect.py::stage_probe: a sum on the device."""
    print("probe:", int(torch.arange(8, device=dev).sum()))


def stage_kernel_min(dev):
    """tools/tpu_bisect.py::stage_pallas_min: P1 at [128, 128]."""
    from round_tpu_torch.ops import fused

    y = fused.probe_double(torch.ones((128, 128), dtype=torch.float32,
                                      device=dev))
    print("kernel_min:", float(y.sum()))


def stage_kernel_prng(dev):
    """tools/tpu_bisect.py::stage_pallas_prng: P2 from seed (1, 2)."""
    from round_tpu_torch.ops import fused

    y = fused.philox_bits(torch.tensor([1, 2], dtype=torch.int32,
                                       device=dev), (128, 128))
    many = int(torch.unique(y).numel() > 100)
    print("kernel_prng:", many)
    if not many:
        raise SystemExit("kernel_prng: 100 or fewer distinct words")


def _otr(dev, n: int, S: int, V: int, rounds: int, engine: str):
    """OTR over the four-family mix at p_drop 0.25 in hw mode, on the
    whole-run kernel ("loop") or the per-round engine ("hist")."""
    from round_tpu_torch.engine import fast
    from round_tpu_torch.models.otr import OtrState

    gen = torch.Generator(device=dev).manual_seed(0)
    mix = fast.standard_mix(gen, S, n, p_drop=0.25, device=dev)
    init = torch.randint(0, V, (n,), generator=gen, dtype=torch.int32,
                         device=dev)
    rnd = fast.OtrHist(n_values=V, after_decision=2)
    state0 = OtrState.fresh(init, S, n)
    if engine == "loop":
        state, _done, _dr = fast.run_otr_loop(rnd, state0, mix, rounds,
                                              mode="hw")
    else:
        state, _done, _dr = fast.run_hist(rnd, state0, lambda s: s.decided,
                                          mix, rounds, mode="hw")
    return state


def stage_loop_tiny(dev):
    """tools/tpu_bisect.py::stage_loop_tiny: K1-OTR in hw mode."""
    state = _otr(dev, 128, 8, 4, 5, "loop")
    print(f"loop_tiny: decided={int(state.decided.sum())}")


def stage_hist_tiny(dev):
    """In place of tools/tpu_bisect.py::stage_loop_flat_tiny: K2 in hw
    mode at loop_tiny's shape."""
    state = _otr(dev, 128, 8, 4, 5, "hist")
    print(f"hist_tiny: decided={int(state.decided.sum())}")


def stage_general_tiny(dev):
    """tools/tpu_bisect.py::stage_general_tiny: the ladder's otr4 rung."""
    from round_tpu_torch.apps.ladder import rung_otr4

    print("general_tiny:", json.dumps(rung_otr4(repeats=1, device=dev))[:200])


def stage_loop_mid(dev):
    """tools/tpu_bisect.py::stage_loop_mid: K1-OTR in hw mode, n=256."""
    t0 = time.perf_counter()
    state = _otr(dev, 256, 256, 8, 20, "loop")
    decided = int(state.decided.sum())
    print(f"loop_mid: decided={decided} "
          f"wall={time.perf_counter() - t0:.1f}s")


def run_stage(name: str, dev) -> None:
    """Run one stage in this process, then print its kernel launches."""
    from round_tpu_torch.ops import fused

    fused.reset_launches()
    globals()[f"stage_{name}"](dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: v for k, v in fused.LAUNCHES.items() if v}
    print(_LAUNCHES + json.dumps(launches), flush=True)


def main_driver(device: str) -> dict:
    """Every stage in its own subprocess with a hard timeout; one JSON line
    per stage (tools/tpu_bisect.py::main_driver)."""
    results = {}
    for name in STAGES:
        t0 = time.perf_counter()
        try:
            cp = subprocess.run(
                [sys.executable, "-m", "round_tpu_torch.tools.bisect",
                 "--device", device, name],
                capture_output=True, text=True, timeout=STAGE_TIMEOUT_S,
                cwd=_ROOT)
            dt = time.perf_counter() - t0
            ok = cp.returncode == 0
            lines = cp.stdout.strip().splitlines()
            launches = {}
            if lines and lines[-1].startswith(_LAUNCHES):
                launches = json.loads(lines.pop()[len(_LAUNCHES):])
            results[name] = {
                "ok": ok, "wall_s": round(dt, 1),
                "out": "\n".join(lines)[-200:], "launches": launches,
                **({} if ok else {"err": cp.stderr.strip()[-400:]}),
            }
        except subprocess.TimeoutExpired:
            results[name] = {"ok": False, "wall_s": STAGE_TIMEOUT_S,
                             "err": "TIMEOUT (hang)"}
        print(json.dumps({name: results[name]}), flush=True)
        if not results[name]["ok"]:
            print(f"stage {name} failed; continuing", file=sys.stderr)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stage", nargs="?", choices=STAGES,
                    help="run this stage alone, in this process")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.stage:
        run_stage(args.stage, resolve_device(args.device))
        return 0
    results = main_driver(args.device)
    return 0 if all(r["ok"] for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
