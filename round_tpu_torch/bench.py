"""The flagship benchmark of the port: OTR over the four-family fault mix.

Port of the worker of bench.py (round_tpu).  Run as

    python -m round_tpu_torch.bench [--n 1024 --scenarios 10000 --phases 50]

It prints one JSON line: ``otr_n{n}_s{S}_rounds_per_sec`` with ``value``,
``unit`` and ``extra`` (decision health, the card's name and power limit,
and with ``--parity K`` the fraction of lanes on which the benched engine,
replayed in hash mode, and the general engine agree over K scenarios).
``--rng hw`` (the default, as in round_tpu) draws the links from the
Philox stream; ``--rng hash`` from the hash, bit for bit as round_tpu.

On the card the timed region is bracketed by CUDA events and ends with an
on-device reduction of the outputs to an O(1) summary (decided_summary);
only that summary is copied to the host.  ``--device cpu`` runs the plain
versions and times with the host clock.  A failing kernel or device fails
the run: there is no fallback engine.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from round_tpu_torch.engine import fast, scenarios
from round_tpu_torch.engine.executor import run_instance
from round_tpu_torch.models.common import consensus_io
from round_tpu_torch.models.otr import OTR, OtrState
from round_tpu_torch.utils.benchstat import decided_summary, speed_extra
from round_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--scenarios", type=int, default=10_000)
    ap.add_argument("--phases", type=int, default=50)
    ap.add_argument("--values", type=int, default=16,
                    help="initial-value domain size")
    ap.add_argument("--p-drop", type=float, default=0.25)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--engine", choices=["loop", "fused", "reference"],
                    default="loop")
    ap.add_argument("--workload", choices=["mixed", "omission"],
                    default="mixed")
    ap.add_argument("--rng", choices=["hash", "hw"], default="hw",
                    help="per-link RNG: hw (the Philox stream that takes "
                         "the place of the TPU's hardware PRNG) or hash "
                         "(bit-exact with round_tpu and the general engine)")
    ap.add_argument("--parity", type=int, default=8, metavar="K",
                    help="also run K scenarios through the general engine "
                         "and report agreement (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def card_info() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    name, _, limit = out.splitlines()[0].partition(",")
    return {"device_kind": name.strip(), "power_limit": limit.strip()}


def _gen(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


class Bench:
    """The benched configuration: one place that builds the mix, the
    initial values and the engine call, shared by the timed run and the
    parity replay so they cannot drift apart."""

    def __init__(self, args, dev):
        self.args = args
        self.dev = dev

    def make_mix(self, gen, S):
        a = self.args
        if a.workload == "omission":
            mix = fast.fault_free(gen, S, a.n, device=self.dev)
            return mix.replace(p8=torch.full(
                (S,), max(1, round(a.p_drop * 256)), dtype=torch.int32,
                device=self.dev))
        return fast.standard_mix(gen, S, a.n, p_drop=a.p_drop,
                                 device=self.dev)

    def init_values(self, gen):
        a = self.args
        return torch.randint(0, a.values, (a.n,), generator=gen,
                             dtype=torch.int32, device=self.dev)

    def run_fast(self, engine, mix, init, rounds, mode):
        a = self.args
        S = mix.crashed.shape[0]
        rnd = fast.OtrHist(n_values=a.values, after_decision=2)
        state0 = OtrState.fresh(init, S, a.n)
        if engine == "loop":
            return fast.run_otr_loop(rnd, state0, mix, rounds, mode=mode)
        return fast.run_hist(rnd, state0, lambda s: s.decided, mix, rounds,
                             mode=mode)

    def run_reference(self, mix, init, rounds):
        """The general engine over every scenario row of the mix."""
        a = self.args
        algo = OTR(after_decision=2, n_values=a.values)
        decided, dround, decision = [], [], []
        for s in range(mix.crashed.shape[0]):
            res = run_instance(algo, consensus_io(init), a.n, (s, a.seed),
                               scenarios.from_mix_row(mix, s), rounds,
                               device=self.dev)
            decided.append(res.state.decided)
            dround.append(res.decided_round)
            decision.append(res.state.decision)
        return torch.stack(decided), torch.stack(dround), torch.stack(decision)

    def summary(self, seed: int, S: int):
        """One benched run, reduced on the device: (cnt, hist, checksum)."""
        a = self.args
        gen = _gen(seed, self.dev)
        mix = self.make_mix(gen, S)
        init = self.init_values(gen)
        if a.engine == "reference":
            decided, dround, decision = self.run_reference(mix, init,
                                                           a.phases)
        else:
            state, _done, dround = self.run_fast(a.engine, mix, init,
                                                 a.phases, a.rng)
            decided, decision = state.decided, state.decision
        return decided_summary(decided, dround, a.phases, decision)

    def parity(self, k: int) -> float:
        """Fraction of lanes where the benched fast engine, replayed in hash
        mode whatever ``--rng`` is, and the general engine agree on
        (decided, decision) over k scenarios (round_tpu bench.py's
        parity_check): only the hash stream replays in the general
        engine."""
        a = self.args
        rounds = min(a.phases, 10)
        gen = _gen(a.seed, self.dev)
        mix = self.make_mix(gen, k)
        init = self.init_values(gen)
        engine = a.engine if a.engine != "reference" else "fused"
        state, _done, _dr = self.run_fast(engine, mix, init, rounds, "hash")
        decided, _dround, decision = self.run_reference(mix, init, rounds)
        agree = (state.decided == decided) & (state.decision == decision)
        return float(agree.to(torch.float64).mean())


def timed(fn, dev):
    """(seconds, result) of fn(); CUDA events on the card, the host clock
    on the CPU.  The result is copied to the host inside the window."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        secs = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
    return secs, [t.cpu() for t in out]


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.scenarios < 1:
        raise SystemExit("--scenarios must be >= 1")
    dev = resolve_device(args.device)
    bench = Bench(args, dev)
    S = args.scenarios

    warm_s, _ = timed(lambda: bench.summary(args.seed, S), dev)
    best = None
    for i in range(args.repeats):
        secs, (cnt, hist, _ck) = timed(
            lambda i=i: bench.summary(args.seed + 1 + i, S), dev)
        best = secs if best is None else min(best, secs)

    rounds = args.phases  # OTR has one round per phase
    extra = speed_extra(best, rounds, cnt, hist, S * args.n)
    del extra["rounds_per_sec"]  # it IS the metric value
    extra.update({
        "n": args.n,
        "scenarios": S,
        "engine": args.engine,
        "rng": args.rng,
        "dot": "i8",  # the kernels count in int32; kept for round_tpu's shape
        "backend": dev.type,
        "workload": args.workload,
        "p_drop": args.p_drop,
        "warmup_s": round(warm_s, 3),
        "repeats": args.repeats,
        "seed": args.seed,
    })
    if dev.type == "cuda":
        extra.update(card_info())
    if args.parity > 0:
        extra["parity_frac"] = round(bench.parity(args.parity), 4)
    result = {
        "metric": f"otr_n{args.n}_s{S}_rounds_per_sec",
        "value": round(rounds / best, 3),
        "unit": "rounds/sec",
        "extra": extra,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
