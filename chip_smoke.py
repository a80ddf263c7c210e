#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of round_tpu_torch from
round_tpu_torch/csrc, holds each kernel bit for bit against its plain
PyTorch version at n=1024, drives the flagship path (OTR, n=1024 x 10,000
four-family fault scenarios x 50 rounds) through the whole-run kernel and
the per-round path through the exchange kernel, replays 8 scenarios through
the port's general engine, and prints:

  - one line per phase;
  - the card's name and power limit as nvidia-smi reports them;
  - a {"kernels": [...]} line with each kernel's launches on its path, its
    time, its bound, its plain version's time and a library call's time;
  - last, {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Any failure raises and the script exits non-zero without the last line.
It needs the round_tpu_torch package beside it and a CUDA card; it imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# flagship shape (README / bench defaults)
N, S_FLAG, ROUNDS, V, P_DROP = 1024, 10_000, 50, 16, 0.25
S_FUSED = 1_000          # run_hist (K2, one launch per round)
S_CHECK = 64             # kernel-vs-plain comparisons
PARITY_K, PARITY_ROUNDS = 8, 10
SEED = 0

# Published peaks of one H100 SXM at its 700 W limit: HBM bandwidth from
# NVIDIA's data sheet; integer issue rates from the Hopper white paper over
# 132 SMs at the 1.98 GHz boost clock.  Shifts, LOP3, IADD3 and ISETP issue
# on the ALU pipe (64 INT32 lanes per SM per clock); IMAD and IMUL issue on
# the FMA pipe (64 lanes per SM per clock, half the FP32 rate), which runs
# alongside the ALU pipe.  The bound is the busier pipe.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 132 * 64 * 1.98e9
IMAD_OPS_PER_S = 132 * 64 * 1.98e9
# Per hashed link (csrc/hash.cuh::rt_link_keep), on the ALU pipe: the xor
# with the round salt, fmix32's three shift/xor pairs (the last xor and the
# & 0xFF fold into one LOP3) and the >= p8 compare; on the FMA pipe: the
# index multiply-add and fmix32's two multiplies.  The count increments are
# left out, so the bound is a floor.
ALU_PER_LINK = 8
IMAD_PER_LINK = 3


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def event_ms(fn, reps: int = 1):
    """Mean milliseconds of fn() over `reps` calls, by CUDA events, after
    one warm-up call.  Returns (ms, last result)."""
    import torch

    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound_ms(nbytes: float, links: float):
    """(ms, "bytes" or "operations", pipe): the least time of the work, the
    larger of the byte time and the busier integer pipe's time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_alu = links * ALU_PER_LINK / ALU_OPS_PER_S * 1e3
    t_imad = links * IMAD_PER_LINK / IMAD_OPS_PER_S * 1e3
    t_ops, pipe = (t_alu, "ALU") if t_alu >= t_imad else (t_imad, "FMA")
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "HBM"
    return t_ops, "operations", pipe


def _on_cpu(args):
    return tuple(a.cpu() if hasattr(a, "cpu") else a for a in args)


def loop_links(mix, dround, rounds: int, after_decision: int = 2) -> float:
    """Links (i -> j, i != j) whose hash this run needed: for every round and
    every scenario with 0 < p8 < 256, each sender times each receiver still
    active.  A lane that decides at round d exits at the end of round
    d + after_decision - 1, so it is active through that round."""
    import torch

    from round_tpu_torch.engine.fast import round_params

    last = torch.where(dround >= 0, dround + max(after_decision - 1, 0),
                       rounds)
    hashed = ((mix.p8 > 0) & (mix.p8 < 256)).to(torch.float64)
    total = 0.0
    for r in range(rounds):
        active = r <= last
        senders = (round_params(mix, r)[0] & active).sum(1).to(torch.float64)
        receivers = active.sum(1).to(torch.float64)
        total += float((hashed * senders * (receivers - 1)).sum())
    return total


def main() -> None:
    if not (ROOT / "round_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: round_tpu_torch/csrc is not beside "
                         "this script")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")

    from round_tpu_torch import bench
    from round_tpu_torch.engine import fast, scenarios
    from round_tpu_torch.engine.executor import run_instance
    from round_tpu_torch.models.common import consensus_io
    from round_tpu_torch.models.otr import OTR, OtrState
    from round_tpu_torch.ops import _native, fused
    from round_tpu_torch.utils.benchstat import decided_summary, p50_from_hist

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build_dir, compile_s = _native.build()
    for name in _native.KERNELS:
        _native.lib(name)
        for line in _native.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say("ptxas", kernel=name, info=line.strip())
    say("build", dir=build_dir.relative_to(ROOT), nvcc_s=round(compile_s, 2),
        total_s=round(time.perf_counter() - t0, 2))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.arange(V, dtype=torch.int32, device=dev)

    # -- 3. K2 against its plain version (tolerance 0: integer counts) -------
    k2_err = 0.0
    for n, S in ((N, S_CHECK), (1000, 7)):
        vals = torch.randint(0, V, (S, n), generator=gen, device=dev,
                             dtype=torch.int32)
        active = torch.rand((S, n), generator=gen, device=dev) < 0.9
        colmask = torch.rand((S, n), generator=gen, device=dev) < 0.8
        rowmask = torch.rand((S, n), generator=gen, device=dev) < 0.9
        side = torch.randint(0, 2, (S, n), generator=gen, device=dev,
                             dtype=torch.int32)
        s0 = fast._salts(gen, S, 0, dev)
        s1 = fast._salts(gen, S, 1, dev)
        p8 = torch.tensor([0, 1, 13, 64, 128, 255, 256], dtype=torch.int32,
                          device=dev).repeat(S // 7 + 1)[:S]
        senders = colmask & active & (p8 < 256)[:, None]
        for rm in (None, rowmask):
            for sd in (None, side):
                got = fused._hist_exchange_cuda(vals, senders, rm, sd, s0, s1,
                                                p8, V)
                want = fused._hist_exchange_plain(vals, senders, rm, sd, s0,
                                                  s1, p8, V)
                err = float((got - want).abs().max())
                k2_err = max(k2_err, err)
                require(torch.equal(got, want),
                        f"K2 differs from its plain version (n={n}, S={S}, "
                        f"rowmask={rm is not None}, side={sd is not None}, "
                        f"max_abs_err={err})")
                if n != N:
                    continue
                # the public wrapper (sender silencing, the self-delivery
                # diagonal) on the card against the same call on CPU copies
                cut = slice(0, 14)  # every p8 twice
                wargs = (vals[cut], active[cut], colmask[cut],
                         None if rm is None else rm[cut],
                         None if sd is None else sd[cut], s0[cut], s1[cut],
                         p8[cut], V)
                got = fused.hist_exchange(*wargs).cpu()
                want = fused.hist_exchange(*_on_cpu(wargs))
                err = float((got - want).abs().max())
                k2_err = max(k2_err, err)
                require(torch.equal(got, want),
                        f"hist_exchange on the card differs from the CPU "
                        f"(rowmask={rm is not None}, side={sd is not None}, "
                        f"max_abs_err={err})")
    say("K2-vs-plain", n=N, S=S_CHECK, V=V, p8="0,1,13,64,128,255,256",
        cases="rowmask x side, plus n=1000, plus the public wrapper vs CPU",
        tolerance=0, max_abs_err=k2_err, equal=True)

    # -- 4. K1 against its plain version (tolerance 0: integer state) --------
    algo = fused.OtrLoop(num_values=V, after_decision=2)
    k1_err = 0.0
    for n, S in ((N, S_CHECK), (1000, 7)):
        mix = fast.standard_mix(gen, S, n, p_drop=P_DROP, device=dev)
        blackout = torch.arange(S, device=dev) % 9 == 5
        mix = mix.replace(p8=torch.where(blackout, 256, mix.p8).to(
            torch.int32))
        x0 = torch.randint(0, V, (n,), generator=gen, device=dev,
                           dtype=torch.int32).expand(S, n).contiguous()
        args = (x0, mix.crashed, mix.side, mix.crash_round, mix.heal_round,
                mix.rotate_down, mix.p8, mix.salt0, mix.salt1)
        got = fused._otr_loop_cuda(algo, *args, PARITY_ROUNDS)
        want = fused._hist_loop_plain(algo, *args, PARITY_ROUNDS, "hash")
        for name, g, w in zip(("x", "decided", "decision", "after", "done",
                               "decided_round"), got, want):
            err = float((g - w).abs().max())
            k1_err = max(k1_err, err)
            require(torch.equal(g, w),
                    f"K1 output {name} differs from its plain version "
                    f"(n={n}, S={S}, max_abs_err={err})")
        if n != N:
            continue
        # the public wrapper on the card against the same call on CPU copies
        wargs = tuple(a[:9] for a in args)  # the four families + a blackout
        kw = dict(num_values=V, rounds=PARITY_ROUNDS, after_decision=2)
        got = fused.otr_loop(*wargs, **kw)
        want = fused.otr_loop(*_on_cpu(wargs), **kw)
        for name, g, w in zip(("x", "decided", "decision", "after", "done",
                               "decided_round"), got, want):
            g = g.cpu()
            err = float((g.to(torch.int32) - w.to(torch.int32)).abs().max())
            k1_err = max(k1_err, err)
            require(torch.equal(g, w),
                    f"otr_loop output {name} on the card differs from the "
                    f"CPU (max_abs_err={err})")
    say("K1-vs-plain", n=N, S=S_CHECK, rounds=PARITY_ROUNDS, V=V,
        rows="standard_mix + blackout p8=256, plus n=1000, plus the public "
             "wrapper vs CPU", outputs=6,
        tolerance=0, max_abs_err=k1_err, equal=True)

    # -- 5. the main paths, through the bench's entry point ------------------
    common = ["--n", str(N), "--phases", str(ROUNDS), "--values", str(V),
              "--p-drop", str(P_DROP), "--seed", str(SEED), "--parity", "0",
              "--device", "cuda"]
    fused.reset_launches()
    flag = bench.main(common + ["--scenarios", str(S_FLAG), "--engine",
                                "loop", "--repeats", "2"])
    k1_launches = fused.LAUNCHES["otr_loop"]
    require(k1_launches > 0, "the flagship path launched no K1 kernel")
    fe = flag["extra"]
    say("flagship", engine="loop", n=N, S=S_FLAG, rounds=ROUNDS,
        rounds_per_sec=flag["value"],
        frac_lanes_decided=fe["frac_lanes_decided"],
        decided_round_p50=fe["decided_round_p50"], K1_launches=k1_launches)
    require(fe["frac_lanes_decided"] > 0.5, "the flagship decided too little")

    fused.reset_launches()
    per_round = bench.main(common + ["--scenarios", str(S_FUSED), "--engine",
                                     "fused", "--repeats", "1"])
    k2_launches = fused.LAUNCHES["hist_exchange"]
    require(k2_launches > 0, "the per-round path launched no K2 kernel")
    say("per-round", engine="fused", n=N, S=S_FUSED, rounds=ROUNDS,
        rounds_per_sec=per_round["value"],
        frac_lanes_decided=per_round["extra"]["frac_lanes_decided"],
        K2_launches=k2_launches)

    # -- 6. parity against the general engine --------------------------------
    pgen = torch.Generator(device=dev).manual_seed(SEED)
    mix = fast.standard_mix(pgen, S_FLAG, N, p_drop=P_DROP, device=dev)
    init = torch.randint(0, V, (N,), generator=pgen, dtype=torch.int32,
                         device=dev)
    rows_k = slice(0, PARITY_K)
    sub = fast.FaultMix(**{k: getattr(mix, k)[rows_k] for k in (
        "crashed", "crash_round", "side", "heal_round", "rotate_down", "p8",
        "salt0", "salt1")})
    rnd = fast.OtrHist(n_values=V, after_decision=2)
    st, _, _ = fast.run_otr_loop(rnd, OtrState.fresh(init, PARITY_K, N), sub,
                                 PARITY_ROUNDS)
    algo_g = OTR(after_decision=2, n_values=V)
    agree = 0
    for s in range(PARITY_K):
        res = run_instance(algo_g, consensus_io(init), N, (s, SEED),
                           scenarios.from_mix_row(sub, s), PARITY_ROUNDS,
                           device=dev)
        agree += int(((st.decided[s] == res.state.decided)
                      & (st.decision[s] == res.state.decision)).sum())
    parity = agree / (PARITY_K * N)
    say("parity", scenarios=PARITY_K, rounds=PARITY_ROUNDS,
        families="0,1,2,3,0,1,2,3", parity_frac=parity)
    require(parity == 1.0, f"parity {parity} != 1.0")

    # -- 7. kernel times, bounds, plain and library times --------------------
    # K1 at the flagship shape (the flagship mix of seed SEED)
    x0 = init.expand(S_FLAG, N).contiguous()
    args = (x0, mix.crashed, mix.side, mix.crash_round, mix.heal_round,
            mix.rotate_down, mix.p8, mix.salt0, mix.salt1)
    k1_ms, out = event_ms(lambda: fused._otr_loop_cuda(algo, *args, ROUNDS),
                          reps=3)
    cnt, hist = decided_summary(out[1] != 0, out[5], ROUNDS)
    k1_links = loop_links(mix, out[5], ROUNDS)
    k1_bytes = 4 * S_FLAG * N * (3 + 6) + 4 * 6 * S_FLAG
    k1_bound, k1_by, k1_pipe = bound_ms(k1_bytes, k1_links)
    t0 = time.perf_counter()
    plain = fused._hist_loop_plain(algo, *args, ROUNDS, "hash")
    torch.cuda.synchronize()
    k1_plain_ms = (time.perf_counter() - t0) * 1e3
    require(all(torch.equal(a, b) for a, b in zip(out, plain)),
            "K1 differs from its plain version at the flagship shape")
    say("K1-time", ms=round(k1_ms, 3), plain_ms=round(k1_plain_ms, 1),
        bound_ms=round(k1_bound, 3), bound_by=k1_by, pipe=k1_pipe,
        bytes_ms=round(k1_bytes / HBM_BYTES_PER_S * 1e3, 4),
        hashed_links=f"{k1_links:.4g}",
        frac_lanes_decided=round(float(cnt) / (S_FLAG * N), 4),
        decided_round_p50=p50_from_hist(hist.cpu()))

    # K2 at round 0 of the per-round path (S_FUSED scenarios, every lane
    # active): one launch's work
    fgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    fmix = fast.standard_mix(fgen, S_FUSED, N, p_drop=P_DROP, device=dev)
    finit = torch.randint(0, V, (N,), generator=fgen, dtype=torch.int32,
                          device=dev)
    colmask, side_r, p8, salt0, salt1r = fast.round_params(fmix, 0)
    vals = finit.expand(S_FUSED, N).contiguous()
    senders = colmask & (p8 < 256)[:, None]
    k2_args = (vals, senders, None, side_r, salt0, salt1r, p8, V)
    k2_ms, got = event_ms(lambda: fused._hist_exchange_cuda(*k2_args), reps=5)
    t0 = time.perf_counter()
    want = fused._hist_exchange_plain(*k2_args)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    require(torch.equal(got, want),
            "K2 differs from its plain version at the per-round shape")
    hashed = ((p8 > 0) & (p8 < 256)).to(torch.float64)
    k2_links = float((hashed * senders.sum(1).to(torch.float64)
                      * (N - 1)).sum())
    k2_bytes = 4 * S_FUSED * N * 3 + 4 * 3 * S_FUSED + 4 * S_FUSED * V * N
    k2_bound, k2_by, k2_pipe = bound_ms(k2_bytes, k2_links)
    # yardstick only (the port never calls it): one torch.bmm of the
    # one-hot senders and the materialised keep mask
    keep = torch.empty((S_FUSED, N, N), dtype=torch.float32, device=dev)
    for sl in fused._chunks(S_FUSED, N):
        k = fused._keep_mask(N, "hash", salt0[sl], salt1r[sl], p8[sl])
        k = k & (side_r[sl][:, :, None] == side_r[sl][:, None, :])
        keep[sl] = k.to(torch.float32)
    onehot = ((vals[:, None, :] == rows[None, :, None])
              & senders[:, None, :]).to(torch.float32)
    lib_ms, lib_out = event_ms(
        lambda: torch.bmm(onehot, keep.transpose(1, 2)), reps=5)
    require(torch.equal(lib_out, got), "the bmm yardstick disagrees with K2")
    del keep, lib_out
    say("K2-time", ms=round(k2_ms, 3), plain_ms=round(k2_plain_ms, 1),
        bound_ms=round(k2_bound, 4), bound_by=k2_by, pipe=k2_pipe,
        bytes_ms=round(k2_bytes / HBM_BYTES_PER_S * 1e3, 4),
        library_ms=round(lib_ms, 3), hashed_links=f"{k2_links:.4g}")

    kernels = [
        {"name": "otr_loop", "route": "cuda",
         "source": "round_tpu_torch/csrc/otr_loop.cu",
         "replaces": "round_tpu/ops/fused.py:557",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "hist_exchange", "route": "cuda",
         "source": "round_tpu_torch/csrc/hist_exchange.cu",
         "replaces": "round_tpu/ops/fused.py:167",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": lib_ms},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
