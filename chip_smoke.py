#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels of round_tpu_torch from
round_tpu_torch/csrc and holds each against its plain PyTorch version, bit
for bit (tolerance 0: every output is an integer, or twice a float), before
driving the paths that run them.  The kernels, in both link streams where
they have two (hash, and hw: the Philox stream that takes the place of the
TPU's hardware PRNG):

  hist_exchange(_hw)   K2, csrc/hist_exchange.cu (one round's exchange,
                       counted on the tensor cores: csrc/count_mma.cuh)
  otr_loop(_hw)        K1, csrc/hist_loop.cu, OTR instance (the whole run,
                       counted on the tensor cores)
  floodmin_loop(_hw)   K1, csrc/hist_loop.cu, FloodMin instance (per-side
                       minima, or chunks of 16 drawn links per lane)
  benor_loop(_hw)      K1, csrc/hist_loop.cu, Ben-Or instance (tensor cores)
  lv_loop              K3, csrc/lv_loop.cu (the whole LastVoting run, a
                       warp per scenario)
  ring_exchange(_i8)   K4, csrc/ring_exchange.cu (the sharded engines'
                       all-gather: int32 codes, int8 bit-planes)
  probe_double         P1, csrc/probe.cu (the bisect tool's o = 2 x)
  philox_bits          P2, csrc/probe.cu (the bisect tool's PRNG probe)

Phases, each printed as one line:

  env / build      the card, torch and CUDA versions; nvcc of every source
  sass             the draw loop of each tensor-core kernel (K1 OTR and
                   Ben-Or, K2, each stream) in the SASS just built:
                   instructions per drawn link, per pipe, mma products,
                   spill loads (round_tpu_torch/tools/sass_links.py)
  K2-vs-plain      n=1024, n=1000 and n=1008, every rowmask/side
                   combination, the public hist_exchange on the card
                   against the CPU
  K1-vs-plain      OTR at n=1024, n=1000 and n=1008, the public otr_loop vs
                   CPU
  K1-FloodMin-vs-plain, K1-BenOr-vs-plain, K3-vs-plain
                   n=1024 x 64, n=1000 and n=1008 (K3: n=1024 and n=1000)
                   scenarios of the four-family mix
                   with the p8 grid 0..256 (blackout rows included),
                   FloodMin at V=16 and V=1000 (and with 8 and 12 sides,
                   per-side minima and the chunked walk, both streams),
                   Ben-Or over 12 rounds,
                   LastVoting over 20 rounds with the partition healing
                   mid-run; the public run_floodmin_loop, run_benor_loop
                   and lv_loop on the card against the CPU
  P-vs-plain       P1 and P2 at the bisect shape against their plain
                   versions; P2 also against Random123's known answers
  hw-vs-plain      K2 and the three K1 instances in hw mode, n=1024 x 64,
                   n=1000 x 7 and n=1008 x 7, the p8 grid, against their
                   plain hw
                   versions; the public hw wrappers on the card against
                   the CPU; run_hist(hw) against run_otr_loop(hw)
  flagship-hash    OTR, n=1024 x 10,000 scenarios x 50 rounds, hash links,
                   through the bench's entry point on K1 (launches counted)
  flagship         the same in hw mode, the bench's default, with the
                   bench's parity (a hash replay against the general
                   engine); its decision statistics against the hash run
  per-round(-hw)   the same on K2, S=1,000, hash and hw
  parity           8 flagship scenarios replayed through the general engine
  ladder-<rung>    otr4, floodmin, lv and benor at their reference shapes
                   through round_tpu_torch.apps.ladder (timed in hw, parity
                   on hash replays): rounds/sec, parity, spec parities and
                   the launches of the rung's kernels
  bisect           python -m round_tpu_torch.tools.bisect: every stage ok,
                   each in its own process, with the launches it reports
  K*-time, P*-time each kernel's time at its path's shape (K3 also at
                   n=1024 x 10,000 x 40 rounds; FloodMin also at the
                   flagship's widths, n=1024 x 10,000, V=16, the four-family
                   mix: K1-FloodMin-wide-time), its plain version's time,
                   its bound and what bounds it (rows that draw links also
                   the bound of a walk that compares each link on its
                   own); K1 at the flagship shape timed again after its
                   plain versions, with nvidia-smi's SM clock, power,
                   temperature and throttle reasons read during each;
                   P1, P2, K2, K3 and FloodMin (like K4) queued behind a
                   sleep kernel (the card's time) and back to back (the
                   host's issue time; K2, K3 and FloodMin also the host's
                   wall time a call, host_ms), torch.mul beside P1 timed
                   both ways
  host-breakdown   the host's steps of one P1 call, one P2 call, one
                   one-card K4 exchange and one K3 call at the lv rung's
                   shape, each timed over 10,000 calls, on the lean launch
                   route and on the route before it
  K1-totals        K1 on the flagship's partition family alone (p8 = 0,
                   five sided rounds): two sides counted by per-side
                   totals against nine, counted by the product
  K4-sass          the SASS of K4's local kernel: bulk copies, and no
                   flag wait, system-scope access or %globaltimer read
  K4-vs-plain      the all-gather over p = 2, 4, 8 shards on cuda:0, int32
                   and int8, aligned and odd widths, chunks one element
                   off a 16-byte boundary, feature dims, 50 calls back to
                   back, p = 1, a 2 x 2 mesh; launches per path
  sharded-families hist, benor, tpc, erb and lattice at n=64 on a 2 x 2 mesh
                   of cuda:0: the hand-written exchange against the library
                   gather, pipelined and straight, and each against its
                   single-device runner (TPC and ERB launch K2 there)
  sharded-loop     sharded_hist_loop over 4 scenario shards, hw and hash,
                   against one K1 launch
  sharded-flagship run_hist_proc_sharded(OtrHist(V=16)) at n=1024 on a 1 x 4
                   mesh of cuda:0 through K4, against the library gather
                   and the single-device hash run (launches counted)
  K4-time          K4's time at the sharded flagship's and the lattice
                   family's shapes, queued (card) and back to back (issue),
                   the kernel and path it took, with its plain, library
                   and bound times
  ring-peers       the same checks and time over distinct cards, where more
                   than one is visible; otherwise it says it skipped

With ``--only sharded`` the script builds the kernels and runs the K4 and
sharded phases alone; with ``--only peers`` just K4-vs-plain and ring-peers
(for a machine with several cards).

Then the card's name and power limit as nvidia-smi reports them, a
{"kernels": [...]} line (per kernel: launches on its path, max_abs_err
against its plain version, ms, plain_ms, bound_ms, bound_by, library_ms;
for the tensor-core kernels also sass_per_link; for P1, P2, K2, K3, K4
and FloodMin also issue_ms, the time from one call to the next issued
back to back; for K4 the kernel and path it took; for FloodMin its wide
row and for K3 its rung's row)
and last {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
N}}.  Any failure raises and the script exits non-zero without the last
line.  It needs the round_tpu_torch package beside it and a CUDA card; it
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# flagship shape (README / bench defaults)
N, S_FLAG, ROUNDS, V, P_DROP = 1024, 10_000, 50, 16, 0.25
S_PLAIN_HW = 512         # scenarios of the flagship K1-hw plain comparison
S_FUSED = 1_000          # run_hist (K2, one launch per round)
S_CHECK = 64             # kernel-vs-plain comparisons
# K1 and K2 against their plain versions: the flagship width, an n that is
# not a multiple of 16 (a receiver row starts inside a Philox call) and one
# that is not a multiple of 64 (a padded sender block)
CHECK_SHAPES = ((N, S_CHECK), (1000, 7), (1008, 7))
PARITY_K, PARITY_ROUNDS = 8, 10
SEED = 0
P8_GRID = (0, 1, 13, 64, 128, 255, 256)
# the ladder rungs (round_tpu_torch/apps/ladder.py) and the kernels each
# runs: the timed one (hw on the card) and its hash-mode parity replay
RUNG_KERNELS = {"otr4": ("otr_loop_hw", "otr_loop"),
                "floodmin": ("floodmin_loop_hw", "floodmin_loop"),
                "lv": ("lv_loop",),
                "benor": ("benor_loop_hw", "benor_loop")}
# Random123's Philox4x32-10 known-answer vectors: counter, key, output
PHILOX_KAT = (
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
)
PROBE_SHAPE = (128, 128)  # the bisect tool's P1 and P2 shape
# K3 beyond the lv rung (whose crash mix has p8 = 0 and hashes nothing)
LV_N, LV_S, LV_ROUNDS = 1024, 10_000, 40

# the sharded phases: the families' mesh and shape, and the sharded
# flagship, whose scenarios and rounds are cut from the flagship's 10,000
# and 50: the receiver-block mask and count outside K4 are plain PyTorch (as
# they are plain XLA in round_tpu) and set the time of a run
FAM_N, FAM_S, FAM_ROUNDS = 64, 16, 6
# a sleep kernel of ~30 ms: launches queued behind it run back to back on
# the card, so their event time is the card's, not the host's issue time
SLEEP_CYCLES = 60_000_000
SHARD_S, SHARD_ROUNDS, SHARDS = 2_000, 10, 4
# calls of each route timed step by step in the host-breakdown phase
BREAKDOWN_CALLS = 10_000

# Published peaks of one H100 SXM at its 700 W limit: HBM bandwidth from
# NVIDIA's data sheet; integer issue rates from the Hopper white paper over
# 132 SMs at the 1.98 GHz boost clock.  LOP3, PRMT and funnel shifts issue
# on the ALU pipe, multiplies (IMAD) on the FMA pipe, each 64 lanes per SM
# per clock, and the two run alongside; an add, or a right shift by a
# constant (IMAD.HI by a power of two), can issue on either.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 132 * 64 * 1.98e9  # per pipe
# The least work a link stream needs, as (ALU pipe only, FMA pipe only,
# either pipe) operations per link; the bound puts the either-pipe work
# where it evens the two pipes out.  Per hashed link, with every fold the
# kernels' own code shows (csrc/count_mma.cuh::RtKeepStream::keep16):
#   ALU: fmix32's first two xors, the round salt folded into the first
#        through the per-round constant s1r ^ (s1r >> 16) (2); its last
#        shift and xor made on four packed draws, rt_pack_last's three PRMT,
#        funnel shift and xor (5/4); the keep compare, two LOP3 a word of
#        four draws with the LUT picked per round by threshold < 128 (2/4);
#   FMA: fmix32's two multiplies (2);
#   either: the link index (an add of the per-link stride), fmix32's first
#        two shifts, the compare's subtract (1 + 2 + 1/4).
# Packing the draws' words for the products and the count (on the tensor
# cores) are left out, so the bound is a floor.
HASH_OPS = (2 + 5 / 4 + 2 / 4, 2, 1 + 2 + 1 / 4)
# Per Philox4x32-10 call (csrc/hash.cuh::rt_philox4x32_10; counter (c, 0,
# 0, 0)): 19 three-way xors (LOP3) on the ALU pipe; 18 multiplies (one wide
# product in round 0, whose other factor is 0, one in round 1, whose other
# product is the key's, the same all round, two in each of rounds 2-9); the
# counter's add on either pipe.  The key schedule is one per (scenario,
# round) and is left out.  Per hw link: 1/16 of a call and a quarter of the
# keep compare (two LOP3 and a subtract a word).
PHILOX_OPS = (19, 18, 1)
HW_OPS = ((PHILOX_OPS[0] + 4 * 2) / 16, PHILOX_OPS[1] / 16,
          (PHILOX_OPS[2] + 4) / 16)
# The bounds of a walk that compares each link on its own, reported
# beside (walk_bound_ms).  Hash: the salt xor, three shift/xor pairs and
# the compare on the ALU pipe, the index multiply-add and two multiplies
# on the FMA pipe; hw: a byte's shift, mask and compare beside 1/16 of a
# call of 19 LOP3 and 20 multiplies.
HASH_OPS_WALK = (8, 3, 0)
HW_OPS_WALK = (3 + 19 / 16, 20 / 16, 0)
# the nvidia-smi readings kept beside the K1 times
SMI_FIELDS = ("clocks.sm", "power.draw", "temperature.gpu",
              "clocks_throttle_reasons.active")


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


def bound_ms(nbytes: float, links: float, ops=HASH_OPS):
    """(ms, "bytes" or "operations", pipe): the least time of the work, the
    larger of the byte time and the integer pipes' time for `links` units of
    work of `ops` = (ALU, FMA, either) operations each, the either-pipe
    work split to even the pipes out (pipe "ALU+FMA" where both fill)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    alu, fma, either = ops
    per_pipe = max(alu, fma, (alu + fma + either) / 2)
    pipe = ("ALU" if per_pipe == alu else "FMA" if per_pipe == fma
            else "ALU+FMA")
    t_ops = links * per_pipe / INT_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "HBM"
    return t_ops, "operations", pipe


def sampled(fn, every_ms: int = 20):
    """(fn(), readings): what nvidia-smi read of card 0 every `every_ms` ms
    while fn ran, from a sampler started before it and stopped after the
    card is idle: the lowest and highest SM clock (MHz), the highest power
    (W) and temperature (C) and the throttle reasons seen ({} where
    nvidia-smi gave no reading)."""
    import torch

    cmd = ["nvidia-smi", "--format=csv,noheader,nounits", "-i", "0"]
    fields = SMI_FIELDS
    if subprocess.run(cmd + ["--query-gpu=" + ",".join(fields)],
                      capture_output=True).returncode != 0:
        fields = fields[:3]  # an nvidia-smi that names them otherwise
    proc = subprocess.Popen(
        cmd + ["--query-gpu=" + ",".join(fields), "-lms", str(every_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)  # its first readings: the card before fn
        out = fn()
        torch.cuda.synchronize()
        time.sleep(2 * every_ms / 1e3)
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
    rows = [r.split(", ") for r in text.splitlines()
            if r.count(", ") == len(fields) - 1]
    if not rows:
        return out, {}

    def col(q):
        vals = []
        for r in rows:
            try:
                vals.append(float(r[q]))
            except ValueError:
                pass
        return vals or [float("nan")]

    got = {"samples": len(rows), "sm_mhz_min": min(col(0)),
           "sm_mhz_max": max(col(0)), "power_w_max": max(col(1)),
           "temp_c_max": max(col(2))}
    if len(fields) == 4:
        got["throttle"] = "|".join(sorted({r[3] for r in rows}))
    return out, got


def _on_cpu(args):
    return tuple(a.cpu() if hasattr(a, "cpu") else a for a in args)


def hashed(mix):
    """[S] 1.0 where the scenario's links need a hash (0 < p8 < 256)."""
    import torch

    return ((mix.p8 > 0) & (mix.p8 < 256)).to(torch.float64)


def loop_bytes(S: int, n: int, outputs: int) -> int:
    """Bytes a K1 or K3 run must move: x0 and side (int32) and the crash set
    (bool) read, `outputs` int32 [S, n] outputs written, six [S] int32
    scalars read."""
    return S * n * (4 * 2 + 1 + 4 * outputs) + 4 * 6 * S


def loop_links(mix, dround, rounds: int, linger: int) -> float:
    """Links (i -> j, i != j) whose hash a K1 run needed: for every round and
    every scenario with 0 < p8 < 256, each sender times each receiver still
    active.  A lane that decides at round d exits at the end of round
    d + linger (OTR: after_decision - 1; FloodMin and Ben-Or: 0), so it is
    active through that round."""
    import torch

    from round_tpu_torch.engine.fast import round_params

    last = torch.where(dround >= 0, dround + linger, rounds)
    h = hashed(mix)
    total = 0.0
    for r in range(rounds):
        active = r <= last
        senders = (round_params(mix, r)[0] & active).sum(1).to(torch.float64)
        receivers = active.sum(1).to(torch.float64)
        total += float((h * senders * (receivers - 1)).sum())
    return total


def lv_links(mix, dround, rounds: int) -> float:
    """Links K3 hashes: n per round (one mask row or column) for every
    round in which a scenario with 0 < p8 < 256 still has an active lane.
    A LastVoting lane exits in the round it decides."""
    import torch

    n = mix.crashed.shape[1]
    last = torch.where(dround >= 0, dround, rounds - 1).max(dim=1).values
    running = torch.clamp(last + 1, max=rounds).to(torch.float64)
    return float((hashed(mix) * running).sum()) * n


def compare(what: str, got, want) -> float:
    """max |got - want| over paired outputs; fails unless all are equal."""
    import torch

    got, want = list(got), list(want)
    require(len(got) == len(want), f"{what}: {len(got)} outputs, not "
            f"{len(want)}")
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        require(g.dtype == w.dtype and g.shape == w.shape,
                f"{what}: output {i} is {g.dtype}{tuple(g.shape)}, not "
                f"{w.dtype}{tuple(w.shape)}")
        g, w = g.to(torch.int64), w.to(g.device).to(torch.int64)
        e = float((g - w).abs().max()) if g.numel() else 0.0
        err = max(err, e)
        require(torch.equal(g, w),
                f"{what}: output {i} differs (max_abs_err={e})")
    return err


def plain_ms(fn):
    """(milliseconds, result) of one call of a plain version on the card."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _ring_devices(torch, p, cards=1):
    """p ring positions over the first `cards` cards, neighbours first."""
    return [torch.device("cuda", (i * cards) // p) for i in range(p)]


def ring_case(torch, what, chunks, calls=1, offset=False):
    """K4 on one chunk per shard (each on its shard's device) against the
    plain version: every shard's output of every call, bit for bit, and
    one launch per exchange and card on the path the topology picks.  With
    calls > 1 the shards exchange `calls` times back to back, on fresh
    inputs (chunk * (i + 1) + i).  With `offset` each chunk lies one
    element past a 16-byte boundary, so no bulk copy may take it."""
    from round_tpu_torch.ops import fused
    from round_tpu_torch.parallel import ici, mesh as M

    p = len(chunks)
    grid = [c.device for c in chunks]
    ring = M.Mesh.line(grid, "ring")

    def body(x_l):
        outs = []
        for i in range(calls):
            x = x_l * (i + 1) + i
            if offset:
                flat = torch.empty(x.numel() + 1, dtype=x.dtype,
                                   device=x.device)[1:]
                x = flat.view_as(x).copy_(x)
            outs.append(ici.ring_exchange(x, axis="ring", p=p))
        return torch.stack(outs)[None]

    cards = len(set(grid))
    path = "ring_exchange_local" if cards == 1 else "ring_exchange_peers"
    before = fused.LAUNCHES[path]
    x = torch.cat([c.to(grid[0]) for c in chunks], dim=1)
    got = M.shard_map(body, ring, in_specs=(M.P(None, "ring"),),
                      out_specs=M.P("ring"))(x)          # [p, calls, S_l, ..]
    require(fused.LAUNCHES[path] - before == calls * cards,
            f"{what}: {fused.LAUNCHES[path] - before} {path} launches for "
            f"{calls} exchanges over {cards} card(s)")
    err = 0.0
    for i in range(calls):
        want = ici._ring_exchange_plain([c * (i + 1) + i for c in chunks])
        err = max(err, compare(f"{what}, call {i}",
                               [got[d, i] for d in range(p)], want))
    return err


def ring_items(torch, chunks, streams=None):
    """K4's launch items for one exchange of `chunks`, as ring_exchange
    builds them: per rank its chunk, a fresh output and the event of its
    stream (`streams`: one per rank, default the current one)."""
    items = []
    for rank, x in enumerate(chunks):
        with torch.cuda.device(x.device):
            stream = (torch.cuda.current_stream(x.device) if streams is None
                      else streams[rank])
            out = torch.empty((x.shape[0], len(chunks) * x.shape[1]),
                              dtype=x.dtype, device=x.device)
            ready = torch.cuda.Event()
            ready.record(stream)
            items.append({"x": x, "out": out, "ready": ready,
                          "stream": stream, "raw": stream.cuda_stream})
    return items


def time_ring(torch, chunks, reps=50):
    """(ms, issue_ms, outputs, plan): K4 launched `reps` times through its
    launcher, without the shards' threads, timed by CUDA events on the
    first device's stream.  `ms` is the card's time for one exchange (the
    launches queued behind a sleep kernel); `issue_ms` is the time from one
    exchange to the next when the host issues them back to back."""
    from round_tpu_torch.parallel import ici

    state = ici._RingState(len(chunks))
    items = ring_items(torch, chunks)
    ici._launch_all(state, items)  # warm-up
    plan = state.plan
    first = items[0]["stream"]

    def run(queued):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(chunks[0].device):
            if queued:
                torch.cuda._sleep(SLEEP_CYCLES)
            start.record(first)
            for _ in range(reps):
                ici._launch_all(state, items)
            end.record(first)
        for x in chunks:
            torch.cuda.synchronize(x.device)
        return start.elapsed_time(end) / reps

    issue_ms, ms = run(False), run(True)
    for status in state.status:
        require(status is None or int(status.item()) == 0,
                "K4 gave up waiting for a peer")
    return ms, issue_ms, [it["out"] for it in items], plan


def queued_ms(torch, fn, reps):
    """Milliseconds of fn() on the card, with `reps` calls queued behind a
    sleep kernel so that the host's issue time does not set the pace."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_times(torch, fn, reps):
    """(ms, issue_ms, host_ms, last result) of fn(): its time on the card
    (`reps` calls queued behind a sleep kernel), the time from one call to
    the next issued back to back (CUDA events), and the host's wall time
    per call without a synchronise (the launch route's cost)."""
    ms = queued_ms(torch, fn, reps)
    issue_ms, out = event_ms(fn, reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms, issue_ms, host_ms, out


def ring_rows(torch, name, chunks, launches, err, reps=50, link_rate=None):
    """One K4 entry of the kernels line: its time on the card and issued
    back to back, the path it took, its plain, library and bound times on
    `chunks` (one per shard)."""
    from round_tpu_torch.parallel import ici

    p = len(chunks)
    ms, issue_ms, outs, plan = time_ring(torch, chunks, reps)
    p_ms, want = plain_ms(lambda: ici._ring_exchange_plain(chunks))
    compare(f"{name} at its path's shape", outs, want)
    if link_rate is None:
        # yardstick only: the library's gather of the chunks into p outputs
        lib = lambda: [torch.cat(chunks, dim=1) for _ in range(p)]  # noqa
        lib_ms = queued_ms(torch, lib, reps)
        lib_issue_ms, _ = event_ms(lib, reps)
        # p chunks read, p * p chunk slots written, over the card's memory
        chunk = chunks[0].numel() * chunks[0].element_size()
        bnd = (p + p * p) * chunk / HBM_BYTES_PER_S * 1e3
    else:
        (lib_ms, lib_issue_ms), bnd = link_rate
    return {"name": name, "route": "cuda",
            "source": "round_tpu_torch/csrc/ring_exchange.cu",
            "replaces": "round_tpu/parallel/ici.py:74",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "issue_ms": issue_ms, "plain_ms": p_ms, "bound_ms": bnd,
            "bound_by": "bytes", "library_ms": lib_ms,
            "library_issue_ms": lib_issue_ms,
            "kernel": f"ring_gather_{plan.kernel}", "path": plan.path,
            "plan": plan._asdict()}


def k4_vs_plain(torch, gen, cards=1):
    """The K4-vs-plain phase over `cards` cards; returns its max_abs_err
    per dtype."""
    from round_tpu_torch.ops import fused
    from round_tpu_torch.parallel import ici, mesh as M

    def draw(shape, dtype, dev):
        hi = 127 if dtype == torch.int8 else 2**31 - 1
        return torch.randint(-hi, hi, shape, generator=gen, device="cuda:0",
                             dtype=torch.int64).to(dtype).to(dev)

    errs = {torch.int32: 0.0, torch.int8: 0.0}
    shards = (2, 4, 8) if cards == 1 else (cards, 2 * cards)
    for p in shards:
        devs = _ring_devices(torch, p, cards)
        for dtype, shapes in ((torch.int32, ((64, 256), (7, 250), (1, 1))),
                              (torch.int8, ((64, 256 * 11), (5, 44),
                                            (8, 352)))):
            for shape in shapes:
                chunks = [draw(shape, dtype, d) // 4 for d in devs]
                for offset in (False, True):
                    errs[dtype] = max(errs[dtype], ring_case(
                        torch, f"K4 p={p} {dtype} {shape} offset={offset}",
                        chunks, offset=offset))
        # epochs: 50 exchanges back to back on fresh inputs
        chunks = [draw((7, 250), torch.int32, d) // 64 for d in devs]
        errs[torch.int32] = max(errs[torch.int32], ring_case(
            torch, f"K4 p={p} 50 calls", chunks, calls=50))
        # feature dims through make_ring_gather: [S_l, n_l, m + 1] int8
        ring = M.Mesh.line(devs, "ring")
        x = draw((5, p * 4, 11), torch.int8, devs[0])
        got = M.shard_map(
            lambda x_l: ici.make_ring_gather("ring", p)(x_l)[None], ring,
            in_specs=(M.P(None, "ring"),), out_specs=M.P("ring"))(x)
        errs[torch.int8] = max(errs[torch.int8], compare(
            f"make_ring_gather p={p} [5, 4, 11] int8", list(got), [x] * p))
    # p = 1: the identity, no launch
    before = dict(fused.LAUNCHES)
    x = draw((3, 5), torch.int32, "cuda:0")
    require(ici.make_ring_gather("ring", 1)(x) is x
            and fused.LAUNCHES == before,
            "make_ring_gather(p=1) is not the identity without a launch")
    # a 2 x 2 mesh: each ring stays in its scenario row
    mesh = M.make_mesh(4, proc_shards=2, devices=_ring_devices(torch, 4, cards))
    x = draw((2 * 6, 2 * 10), torch.int32, "cuda:0")
    got = M.shard_map(
        lambda x_l: ici.ring_exchange(x_l, axis=M.PROC_AXIS, p=2), mesh,
        in_specs=(M.P(M.SCENARIO_AXIS, M.PROC_AXIS),),
        out_specs=M.P(M.SCENARIO_AXIS, M.PROC_AXIS))(x)
    errs[torch.int32] = max(errs[torch.int32], compare(
        "K4 on a 2 x 2 mesh", [got], [torch.cat([x, x], dim=1)]))
    say("K4-vs-plain", shards=",".join(map(str, shards)), cards=cards,
        int32="(64,256),(7,250),(1,1)", int8="(64,2816),(5,44),(8,352)",
        cases="each shard's out vs torch.cat, chunks 16-byte aligned and "
              "one element past; [5,4,11] int8 through make_ring_gather; "
              "50 calls back to back; p=1 identity, no launch; 2x2 mesh "
              "rows; one launch per exchange and card on the topology's "
              "path", tolerance=0,
        max_abs_err=max(errs.values()), equal=True)
    return errs


def nvlink_rate():
    """Bytes per second one card sends over its NVLinks, summed over the
    links `nvidia-smi nvlink -s` lists for GPU 0; None when it lists none."""
    cp = subprocess.run(["nvidia-smi", "nvlink", "-s", "-i", "0"],
                        capture_output=True, text=True)
    rates = [float(m) for m in re.findall(r"Link \d+: ([0-9.]+) GB/s",
                                          cp.stdout)]
    return sum(rates) * 1e9 if rates else None


def ring_peers(torch, gen):
    """K4 over distinct cards, where more than one is visible."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print(json.dumps({"phase": "ring-peers",
                          "skipped": "one card visible"}), flush=True)
        return None
    errs = k4_vs_plain(torch, gen, cards=cards)
    devs = _ring_devices(torch, cards, cards)
    chunks = [torch.randint(0, 17, (SHARD_S, N // SHARDS), generator=gen,
                            device="cuda:0", dtype=torch.int32).to(d)
              for d in devs]
    rate = nvlink_rate()
    chunk = chunks[0].numel() * chunks[0].element_size()
    bnd = (cards - 1) * chunk / rate * 1e3 if rate else None
    outs = [torch.empty((cards * SHARD_S, N // SHARDS), dtype=torch.int32,
                        device=d) for d in devs]

    def nccl():  # yardstick only: the library's all-gather over the cards
        torch.cuda.nccl.all_gather(chunks, outs)

    lib_ms = queued_ms(torch, nccl, 20)
    lib_issue_ms, _ = event_ms(nccl, 20)
    for d in devs:
        torch.cuda.synchronize(d)
    compare("nccl all_gather yardstick", outs,
            [torch.cat([c.to(o.device) for c in chunks]) for o in outs])
    row = ring_rows(torch, "ring_exchange_peers", chunks, 0,
                    errs[torch.int32], reps=20,
                    link_rate=((lib_ms, lib_issue_ms), bnd))
    say("ring-peers", cards=cards, shape=f"[{SHARD_S},{N // SHARDS}] int32",
        kernel=row["kernel"], path=row["path"], ms=round(row["ms"], 5),
        issue_ms=round(row["issue_ms"], 5),
        plain_ms=round(row["plain_ms"], 3),
        nccl_all_gather_ms=round(lib_ms, 5),
        nccl_issue_ms=round(lib_issue_ms, 5),
        bound_ms=None if bnd is None else round(bnd, 5),
        nvlink_bytes_per_s=rate, bound_by="bytes over NVLink",
        max_abs_err=row["max_abs_err"])
    return row


class _Ticks:
    """Nanoseconds per named host step, summed over calls: tick(name)
    charges the time since the last tick (or start()) to `name`."""

    def __init__(self):
        self.ns = {}
        self.t = 0

    def start(self):
        self.t = time.perf_counter_ns()

    def __call__(self, name):
        t = time.perf_counter_ns()
        self.ns[name] = self.ns.get(name, 0) + t - self.t
        self.t = t

    def per_call_us(self, calls):
        return {k: round(v / calls / 1e3, 3) for k, v in self.ns.items()}


def host_breakdown(torch, x, calls=BREAKDOWN_CALLS):
    """The host's steps of one P1 call (on x), of one P2 call at the
    bisect shape, of one one-card K4 exchange (the sharded flagship's four
    [2,000, 256] int32 chunks, a stream each, as shard_map gives them) and
    of one K3 call at the lv rung's shape, each step timed with
    perf_counter_ns over `calls` calls, on the lean route the wrappers take
    and on the route they took before (the device context, the Stream
    object, the library's lock, the flags' pointers), which the script
    rebuilds here around the same kernels.  Also each wrapper's whole
    time per call, and the cost of a tick alone."""
    from round_tpu_torch.ops import _native, fused
    from round_tpu_torch.parallel import ici

    counts = {"probe_double": 0, "philox_bits": 0, "ring_exchange": 0,
              "lv_loop": 0}

    def p1_lean(t):
        t.start()
        if x.dtype != torch.float32 or not x.is_cuda:
            raise ValueError("probe_double")
        t("checks")
        launch = fused._entries(*fused._PROBE_ENTRIES)[0]
        t("bound entry")
        xc = x.contiguous()
        t("contiguous")
        out = torch.empty_like(xc)
        t("empty_like")
        index = xc.get_device()
        args = (xc.data_ptr(), out.data_ptr(), xc.numel(), index)
        t("pointers")
        raw = _native.raw_stream(index)
        t("raw stream")
        err = launch(*args, raw)
        t("launch")
        counts["probe_double"] += 1
        if err:
            _native.check(err, "probe_double launch")
        t("count and check")

    def p1_before(t):
        t.start()
        if x.dtype != torch.float32 or x.device.type == "cpu" \
                or not x.is_cuda:
            raise ValueError("probe_double")
        t("checks")
        so = _native.lib("probe")
        t("library lock")
        xc = x.contiguous()
        t("contiguous")
        out = torch.empty_like(xc)
        t("empty_like")
        with torch.cuda.device(xc.device):
            t("device context")
            stream = torch.cuda.current_stream(xc.device).cuda_stream
            t("Stream object")
            err = so.probe_double_launch(xc.data_ptr(), out.data_ptr(),
                                         xc.numel(), xc.device.index, stream)
            t("launch")
        t("device context")
        counts["probe_double"] += 1
        _native.check(err, "probe_double launch")
        t("count and check")

    seed = torch.tensor([1, 2], dtype=torch.int32, device=x.device)

    def p2_lean(t):
        t.start()
        sd = seed if isinstance(seed, torch.Tensor) else torch.as_tensor(seed)
        if sd.shape != (2,):
            raise ValueError("philox_bits")
        shape = tuple(PROBE_SHAPE)
        counter = tuple(map(int, (0, 0, 0, 0)))
        if not sd.is_cuda:
            raise ValueError("philox_bits")
        t("checks and shape")
        launch = fused._entries(*fused._PROBE_ENTRIES)[1]
        t("bound entry")
        key = (sd if sd.dtype == torch.int32 and sd.is_contiguous()
               else sd.to(torch.int32).contiguous())
        t("key")
        out = key.new_empty(shape)
        t("new_empty")
        index = key.get_device()
        args = (key.data_ptr(), out.data_ptr(), out.numel(),
                *[c & 0xFFFFFFFF for c in counter], index)
        t("pointers")
        raw = _native.raw_stream(index)
        t("raw stream")
        err = launch(*args, raw)
        t("launch")
        counts["philox_bits"] += 1
        if err:
            _native.check(err, "philox_bits launch")
        t("count and check")

    dev = x.device
    p = SHARDS
    chunks = [torch.randint(0, V + 1, (SHARD_S, N // SHARDS), device=dev,
                            dtype=torch.int32) for _ in range(p)]
    streams = [torch.cuda.Stream(dev) for _ in range(p)]
    items = ring_items(torch, chunks, streams)
    state = ici._RingState(p)
    lock = ici._LOCK
    local_launch = (ici._RING or ici._bind_ring())[0]

    def k4_lean(t):
        t.start()
        n = len(items)
        x0 = items[0]["x"]
        rows, cols = x0.shape
        row_bytes = cols * x0.element_size()
        out_ptrs = [it["out"].data_ptr() for it in items]
        x_ptrs = [it["x"].data_ptr() for it in items]
        outs = (ctypes.c_void_p * n)(*out_ptrs)
        xs = (ctypes.c_void_p * n)(*x_ptrs)
        t("pointer arrays")
        align = ici._alignment(out_ptrs + x_ptrs)
        index = x0.get_device()
        if not all(it["x"].get_device() == index for it in items):
            raise ValueError("the breakdown's chunks lie on one device")
        t("alignment and one device")
        plan = state.plan = ici._ring_plan(rows, row_bytes, n,
                                           ici._sms(index), align=align)
        t("plan")
        stream, raw = items[0]["stream"], items[0]["raw"]
        for it in items[1:]:
            if it["raw"] != raw:
                stream.wait_event(it["ready"])
        t("stream waits")
        err = local_launch(outs, xs, n, rows, row_bytes,
                           int(plan.path == "bulk"), plan.unit, plan.lanes,
                           plan.band_rows, plan.blocks, index, raw)
        t("launch")
        with lock:
            counts["ring_exchange"] += 2  # by dtype and by path
        if err:
            _native.check(err, "ring_exchange launch")
        t("count and check")
        done = torch.cuda.Event()
        done.record(stream)
        t("done event")

    def k4_before(t):
        t.start()
        _native.lib("ring_exchange")
        t("library lock")
        n = len(items)
        x0 = items[0]["x"]
        rows, cols = x0.shape
        runs = ici._device_runs(items)
        devices = [items[run[0]]["x"].device for run in runs]
        t("device runs")
        with lock:
            min(ici._SMS.get(d.index, 0) for d in devices)
        t("residency under the lock")
        state.epoch += 1
        outs = _native.pointer_array([it["out"] for it in items])
        xs = _native.pointer_array([it["x"] for it in items])
        flags = (ctypes.c_void_p * n)(*([0] * n))
        t("pointer arrays")
        plan = ici._ring_plan(rows, cols * x0.element_size(), n,
                              ici._sms(x0.get_device()),
                              align=ici._alignment(list(outs) + list(xs)))
        stream = items[0]["stream"]
        for it in items:
            stream.wait_event(it["ready"])
        t("stream waits")
        with torch.cuda.device(devices[0]):
            t("device context")
            err = local_launch(outs, xs, n, rows, cols * x0.element_size(),
                               int(plan.path == "bulk"), plan.unit,
                               plan.lanes, plan.band_rows, plan.blocks,
                               devices[0].index, stream.cuda_stream)
            t("launch")
        t("device context")
        with lock:
            counts["ring_exchange"] += 1
        _native.check(err, "ring_exchange launch")
        t("count and check")
        done = torch.cuda.Event()
        done.record(stream)
        t("done event")
        return flags

    # K3 at the lv rung's shape (crash mix, n=256 x 256, 16 rounds): the
    # lean route _lv_loop_cuda takes, and the route before rebuilt around
    # the same kernel (the library's lock, its shared-memory query on every
    # call, each input converted to int32, the bool crash set too, a device
    # context and a Stream object, nine output allocations and their
    # pointer array; the C side's per-launch cudaFuncSetAttribute of that
    # route is not rebuilt)
    from round_tpu_torch.apps import ladder
    from round_tpu_torch.engine import fast

    lgen = torch.Generator(device=dev).manual_seed(SEED + 4)
    ln, ls, lrounds = 256, 256, 16
    lmix = ladder._crash_mix(lgen, ls, ln, ln // 32, dev)
    lx0 = torch.randint(0, 64, (ln,), generator=lgen, device=dev,
                        dtype=torch.int32).expand(ls, ln).contiguous()
    largs = (lx0, *fast._mix_args(lmix))
    lbuf = torch.empty((9, ls, ln), dtype=torch.int32, device=dev)

    def k3_lean(t):
        t.start()
        S, n = largs[0].shape
        if not fused.lv_key_fits(n, lrounds):
            raise ValueError("lv_loop key")
        t("checks")
        launch, smem_bytes = fused._entries(
            "lv_loop", "lv_loop_launch", "lv_loop_smem_bytes")
        t("bound entries")
        if fused._smem(smem_bytes, n) > fused._MAX_SMEM:
            raise ValueError("lv_loop smem")
        t("smem (cached)")
        x0, side, *scalars = fused._kernel_inputs(
            largs[0].device, S, n, (largs[0], largs[2]), largs[3:])
        crashed = fused._crash_bytes(largs[1], x0.device, S, n)
        t("inputs")
        out = x0.new_empty((9, S, n), dtype=torch.int32)
        t("new_empty")
        index = x0.get_device()
        ptrs = [x0.data_ptr(), crashed.data_ptr(), side.data_ptr(),
                *[a.data_ptr() for a in scalars]]
        t("pointers")
        raw = _native.raw_stream(index)
        t("raw stream")
        err = launch(*ptrs, out.data_ptr(), S, n, lrounds, index, raw)
        t("launch")
        counts["lv_loop"] += 1
        if err:
            _native.check(err, "lv_loop launch")
        t("count and check")
        out.unbind(0)
        t("unbind")

    def k3_before(t):
        t.start()
        so = _native.lib("lv_loop")
        t("library lock")
        S, n = largs[0].shape
        smem = so.lv_loop_smem_bytes(n)
        if smem > fused._MAX_SMEM:
            raise ValueError("lv_loop smem")
        t("smem query")
        ins = []
        for a, shape in zip(largs, [(S, n)] * 3 + [(S,)] * 6):
            if a.device != largs[0].device or tuple(a.shape) != shape:
                raise ValueError("lv_loop input")
            ins.append(a.to(torch.int32).contiguous())
        t("inputs")
        outs = [torch.empty((S, n), dtype=torch.int32, device=dev)
                for _ in range(9)]
        _native.pointer_array(outs)
        t("nine outputs")
        with torch.cuda.device(largs[0].device):
            t("device context")
            stream = torch.cuda.current_stream(largs[0].device).cuda_stream
            t("Stream object")
            # the kernel reads the crash set as bytes: the bool input
            ptrs = [a.data_ptr() for a in ins]
            ptrs[1] = largs[1].data_ptr()
            err = so.lv_loop_launch(*ptrs, lbuf.data_ptr(), S, n, lrounds,
                                    largs[0].device.index, stream)
            t("launch")
        t("device context")
        counts["lv_loop"] += 1
        _native.check(err, "lv_loop launch")
        t("count and check")

    out = {}
    for name, route in (("p1_lean", p1_lean), ("p1_before", p1_before),
                        ("p2_lean", p2_lean), ("k4_lean", k4_lean),
                        ("k4_before", k4_before), ("k3_lean", k3_lean),
                        ("k3_before", k3_before)):
        ticks = _Ticks()
        route(ticks)  # warm-up
        ticks = _Ticks()
        for _ in range(calls):
            route(ticks)
        torch.cuda.synchronize()
        steps = ticks.per_call_us(calls)
        out[name] = {"sum_us": round(sum(steps.values()), 3), **steps}
    ticks = _Ticks()
    for _ in range(calls):
        ticks.start()
        ticks("tick")
    out["tick_us"] = ticks.per_call_us(calls)["tick"]
    for name, fn in (("probe_double", lambda: fused.probe_double(x)),
                     ("philox_bits",
                      lambda: fused.philox_bits(seed, PROBE_SHAPE)),
                     ("torch_mul", lambda: torch.mul(x, 2.0)),
                     ("lv_loop", lambda: fused._lv_loop_cuda(*largs,
                                                             lrounds)),
                     ("ring_launch_all",
                      lambda: ici._launch_all(state, items))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        out[f"{name}_wrapper_us"] = round(
            (time.perf_counter_ns() - t0) / calls / 1e3, 3)
        torch.cuda.synchronize()
    compare("K4 after the host breakdown", [it["out"] for it in items],
            ici._ring_exchange_plain(chunks))
    compare("K3 after the host breakdown", lbuf.unbind(0),
            fused._lv_loop_plain(*largs, lrounds))
    say("host-breakdown", calls=calls,
        k4=f"[{SHARD_S},{N // SHARDS}] int32 x {SHARDS} on cuda:0, a stream "
           "each; the route before rebuilt around the same local kernel",
        k3=f"lv rung, n={ln} x {ls} x {lrounds} crash mix; the route before "
           "rebuilt around the same kernel, less its per-launch "
           "cudaFuncSetAttribute",
        us=json.dumps(out).replace(" ", ""))
    return out


def k4_sass():
    """The SASS of K4's two kernels just built: the local kernel moves its
    bands with bulk copies (UBLKCP) and holds no flag wait, no system-scope
    access or fence and no %globaltimer read; the peers kernel, which the
    same patterns must find, holds all three."""
    from round_tpu_torch.ops import _native
    from round_tpu_torch.tools import sass_links

    funcs = sass_links.functions(_native.build_dir() / "libring_exchange.so")
    marks = {"bulk": r"UBLKCP", "system": r"\.SYS\b",
             "globaltimer": r"GLOBALTIMER", "sleep": r"NANOSLEEP"}
    found = {}
    for kernel in ("ring_gather_local", "ring_gather_peers"):
        name = next((f for f in funcs if kernel in f), None)
        require(name is not None, f"no {kernel} in the SASS")
        found[kernel] = {k: len(re.findall(v, funcs[name]))
                         for k, v in marks.items()}
    local, peers = found["ring_gather_local"], found["ring_gather_peers"]
    say("K4-sass", local=json.dumps(local).replace(" ", ""),
        peers=json.dumps(peers).replace(" ", ""))
    require(local["bulk"] > 0 and local["system"] == 0
            and local["globaltimer"] == 0 and local["sleep"] == 0,
            f"ring_gather_local's SASS: {local}")
    require(peers["system"] > 0 and peers["globaltimer"] > 0,
            f"ring_gather_peers' SASS does not show its flags: {peers}")


def sharded_phases(torch, gen):
    """The K4 phases and the sharded paths; returns K4's two entries of the
    kernels line."""
    from round_tpu_torch.engine import fast
    from round_tpu_torch.models.otr import OtrState
    from round_tpu_torch.ops import fused
    from round_tpu_torch.parallel import ici, mesh as M

    dev = torch.device("cuda:0")
    k4_sass()
    errs = k4_vs_plain(torch, gen)

    # -- the five families on a 2 x 2 mesh of cuda:0 -------------------------
    mesh = M.make_mesh(4, proc_shards=2, devices=[dev] * 4)
    fused.reset_launches()
    for family in ici.FAMILIES:
        fgen = torch.Generator(device=dev).manual_seed(SEED + 5)
        state0, mix, run = ici._family_runner(family, FAM_N, FAM_S,
                                              FAM_ROUNDS, fgen, dev)
        single = ici.single_device_run(family, state0, mix, FAM_ROUNDS)
        M.reset_collective()
        runs = {"collective": run(state0, mix, mesh, "collective", False)}
        gathers = M.COLLECTIVE["calls"]
        M.reset_collective()
        runs["ici pipelined"] = run(state0, mix, mesh, "ici", True)
        runs["ici straight"] = run(state0, mix, mesh, "ici", False)
        require(gathers > 0 and M.COLLECTIVE["calls"] == 0,
                f"{family}: the ici runs called the library gather "
                f"{M.COLLECTIVE['calls']} times (collective run: {gathers})")
        for label, got in runs.items():
            require(ici._trees_equal(got, single),
                    f"sharded {family} ({label}) differs from its "
                    "single-device run")
        require(ici.family_parity(family, n=FAM_N, S=FAM_S, proc_shards=2,
                                  rounds=FAM_ROUNDS, devices=[dev] * 4),
                f"family_parity({family}) is false")
    fam_launches = {k: v for k, v in fused.LAUNCHES.items() if v}
    say("sharded-families", families=",".join(ici.FAMILIES), n=FAM_N, S=FAM_S,
        rounds=FAM_ROUNDS, mesh="2x2 of cuda:0",
        cases="ici pipelined, ici straight and collective, each equal to "
              "run_hist / run_tpc_fast / run_erb_fast / run_lattice_fast "
              "(hash); family_parity", equal=True,
        launches=json.dumps(fam_launches).replace(" ", ""))
    require(fam_launches.get("hist_exchange", 0) > 0,
            "run_tpc_fast and run_erb_fast launched no K2 kernel")
    for name in ("ring_exchange", "ring_exchange_i8"):
        require(fam_launches.get(name, 0) > 0,
                f"the sharded families launched no {name} kernel")
    require(fam_launches.get("ring_exchange_local", 0)
            == fam_launches["ring_exchange"] + fam_launches["ring_exchange_i8"]
            and "ring_exchange_peers" not in fam_launches,
            "the sharded families' exchanges on one card did not all take "
            "the local kernel")

    # -- the whole-run loop over 4 scenario shards ---------------------------
    loop_mesh = M.Mesh.line([dev] * SHARDS, M.SCENARIO_AXIS)
    lgen = torch.Generator(device=dev).manual_seed(SEED + 6)
    mix = fast.standard_mix(lgen, SHARD_S, N, p_drop=P_DROP, device=dev)
    init = torch.randint(0, V, (N,), generator=lgen, dtype=torch.int32,
                         device=dev)
    x0 = init.expand(SHARD_S, N).contiguous()
    algo = fused.OtrLoop(num_values=V, after_decision=2)
    fused.reset_launches()
    for mode in ("hw", "hash"):
        got = M.sharded_hist_loop(algo, x0, mix, SHARD_ROUNDS, loop_mesh,
                                  mode=mode)
        want = fused.hist_loop(algo, x0, *fast._mix_args(mix),
                               rounds=SHARD_ROUNDS, mode=mode)
        compare(f"sharded_hist_loop ({mode})", [*got[0], *got[1:]],
                [*want[0], *want[1:]])
    say("sharded-loop", n=N, S=SHARD_S, rounds=SHARD_ROUNDS,
        shards=f"{SHARDS} scenario shards of cuda:0", modes="hw,hash",
        equal=True, launches=json.dumps(
            {k: v for k, v in fused.LAUNCHES.items() if v}).replace(" ", ""))

    # -- the sharded flagship: the sharded path at full width -----------------
    mesh = M.make_mesh(SHARDS, proc_shards=SHARDS, devices=[dev] * SHARDS)
    rnd = fast.OtrHist(n_values=V, after_decision=2)
    st0 = OtrState.fresh(init, SHARD_S, N)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    fused.reset_launches()
    M.reset_collective()
    got, ici_s = timed(lambda: M.run_hist_proc_sharded(
        rnd, st0, mix, SHARD_ROUNDS, mesh, exchange="ici"))
    k4_launches = fused.LAUNCHES["ring_exchange"]
    require(k4_launches == SHARD_ROUNDS
            and fused.LAUNCHES["ring_exchange_local"] == SHARD_ROUNDS
            and M.COLLECTIVE["calls"] == 0,
            f"the sharded flagship launched K4 {k4_launches} times in "
            f"{SHARD_ROUNDS} rounds and called the library gather "
            f"{M.COLLECTIVE['calls']} times")
    coll, coll_s = timed(lambda: M.run_hist_proc_sharded(
        rnd, st0, mix, SHARD_ROUNDS, mesh, exchange="collective"))
    gathers = M.COLLECTIVE["calls"]
    single, single_s = timed(lambda: fast.run_hist(
        rnd, st0, lambda s: s.decided, mix, SHARD_ROUNDS, mode="hash"))
    require(ici._trees_equal(got, single),
            "the sharded flagship (ici) differs from run_hist(hash)")
    require(ici._trees_equal(coll, single),
            "the sharded flagship (collective) differs from run_hist(hash)")
    decided = float(got[0].decided.float().mean())
    say("sharded-flagship", n=N, S=SHARD_S, rounds=SHARD_ROUNDS, V=V,
        mesh=f"1x{SHARDS} of cuda:0", n_local=N // SHARDS,
        cut_from="S=10000, rounds=50: the mask and count around K4 are "
                 "plain PyTorch and set the time",
        ici_wall_s=round(ici_s, 3), collective_wall_s=round(coll_s, 3),
        single_device_wall_s=round(single_s, 3),
        frac_lanes_decided=round(decided, 4), K4_launches=k4_launches,
        ici_all_gather_calls=0, collective_all_gather_calls=gathers,
        peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2),
        equal=True)
    require(decided > 0.5, "the sharded flagship decided too little")

    # -- K4's time at the shapes of its paths --------------------------------
    tgen = torch.Generator(device=dev).manual_seed(SEED + 7)
    codes = [torch.randint(0, V + 1, (SHARD_S, N // SHARDS), generator=tgen,
                           device=dev, dtype=torch.int32)
             for _ in range(SHARDS)]
    planes = [torch.randint(0, 2, (FAM_S // 2, (FAM_N // 2) * 11),
                            generator=tgen, device=dev,
                            dtype=torch.int64).to(torch.int8)
              for _ in range(2)]
    rows = [ring_rows(torch, "ring_exchange", codes, k4_launches,
                      errs[torch.int32]),
            ring_rows(torch, "ring_exchange_i8", planes,
                      fam_launches["ring_exchange_i8"], errs[torch.int8])]
    for row, shape in zip(rows, (f"[{SHARD_S},{N // SHARDS}] int32 p={SHARDS}",
                                 f"[{FAM_S // 2},{(FAM_N // 2) * 11}] int8 "
                                 "p=2")):
        say("K4-time", kernel=row["name"], shape=shape,
            launches=row["launches"], path=f"{row['kernel']}/{row['path']}",
            plan=json.dumps(row["plan"]).replace(" ", ""),
            ms=round(row["ms"], 5), issue_ms=round(row["issue_ms"], 5),
            plain_ms=round(row["plain_ms"], 4),
            library_ms=round(row["library_ms"], 5),
            library_issue_ms=round(row["library_issue_ms"], 5),
            library="torch.cat of the chunks, once per shard",
            bound_ms=f"{row['bound_ms']:.3g}", bound_by=row["bound_by"])
    ring_peers(torch, gen)
    return rows


def main() -> None:
    if not (ROOT / "round_tpu_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: round_tpu_torch/csrc is not beside "
                         "this script")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")

    from round_tpu_torch import bench
    from round_tpu_torch.apps import ladder
    from round_tpu_torch.engine import fast, scenarios
    from round_tpu_torch.engine.executor import run_instance
    from round_tpu_torch.models.benor import BenOrState
    from round_tpu_torch.models.common import consensus_io
    from round_tpu_torch.models.floodmin import FloodMinState
    from round_tpu_torch.models.otr import OTR, OtrState
    from round_tpu_torch.ops import _native, fused
    from round_tpu_torch.tools import sass_links
    from round_tpu_torch.utils.benchstat import decided_summary, p50_from_hist
    from round_tpu_torch.utils.tree import tree_map

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
            if any(w in line for w in ("registers", "spill",
                                       "entry function")):
                say("ptxas", kernel=name, info=line.strip())
    say("build", dir=build_dir.relative_to(ROOT), nvcc_s=round(compile_s, 2),
        total_s=round(time.perf_counter() - t0, 2))
    # the draw loops of the tensor-core count in the SASS just built
    sass = {}
    for name in ("hist_loop", "hist_exchange"):
        for row in sass_links.report(build_dir / f"lib{name}.so"):
            sass[row["kernel"]] = row
            say("sass", kernel=row["kernel"],
                loop_instructions=row["instructions"],
                per_link=round(row["per_link"], 3),
                alu_per_link=round(row["alu_per_link"], 3),
                fma_per_link=round(row["fma_per_link"], 3),
                imma=row["imma"], spill_loads=row["spill_loads"])
    missing = sorted(set(sass_links.KERNELS.values()) - set(sass))
    require(not missing, f"no draw loop with mma products in {missing}")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = torch.arange(V, dtype=torch.int32, device=dev)

    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv \
        else None
    if only is not None:
        require(only in ("sharded", "peers"), f"unknown --only {only}")
        if only == "sharded":
            part = sharded_phases(torch, gen)
        else:
            k4_vs_plain(torch, gen)
            part = [ring_peers(torch, gen)]
        print(card, flush=True)
        print(json.dumps({"kernels": part}), flush=True)
        print(json.dumps({"ok": True, "only": only, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    # -- 3. K2 against its plain version (tolerance 0: integer counts) -------
    k2_err = 0.0
    for n, S in CHECK_SHAPES:
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
                k2_err = max(k2_err, compare(
                    f"K2 vs its plain version (n={n}, S={S}, rowmask="
                    f"{rm is not None}, side={sd is not None})",
                    [fused._hist_exchange_cuda(vals, senders, rm, sd, s0, s1,
                                               p8, V, "hash")],
                    [fused._hist_exchange_plain(vals, senders, rm, sd, s0,
                                                s1, p8, V, "hash")]))
                if n != N:
                    continue
                # the public wrapper (sender silencing, the self-delivery
                # diagonal) on the card against the same call on CPU copies
                cut = slice(0, 14)  # every p8 twice
                wargs = (vals[cut], active[cut], colmask[cut],
                         None if rm is None else rm[cut],
                         None if sd is None else sd[cut], s0[cut], s1[cut],
                         p8[cut], V)
                k2_err = max(k2_err, compare(
                    f"hist_exchange on the card vs the CPU (rowmask="
                    f"{rm is not None}, side={sd is not None})",
                    [fused.hist_exchange(*wargs, mode="hash").cpu()],
                    [fused.hist_exchange(*_on_cpu(wargs), mode="hash")]))
    say("K2-vs-plain", n=N, S=S_CHECK, V=V, p8="0,1,13,64,128,255,256",
        cases="rowmask x side, plus n=1000 and n=1008, plus the public "
              "wrapper vs CPU",
        tolerance=0, max_abs_err=k2_err, equal=True)

    # -- 4. K1 against its plain version (tolerance 0: integer state) --------
    algo = fused.OtrLoop(num_values=V, after_decision=2)
    k1_err = 0.0
    for n, S in CHECK_SHAPES:
        mix = fast.standard_mix(gen, S, n, p_drop=P_DROP, device=dev)
        blackout = torch.arange(S, device=dev) % 9 == 5
        mix = mix.replace(p8=torch.where(blackout, 256, mix.p8).to(
            torch.int32))
        x0 = torch.randint(0, V, (n,), generator=gen, device=dev,
                           dtype=torch.int32).expand(S, n).contiguous()
        args = (x0, mix.crashed, mix.side, mix.crash_round, mix.heal_round,
                mix.rotate_down, mix.p8, mix.salt0, mix.salt1)
        k1_err = max(k1_err, compare(
            f"K1 vs its plain version (n={n}, S={S})",
            fused._hist_loop_cuda(algo, *args, PARITY_ROUNDS, "hash"),
            fused._hist_loop_plain(algo, *args, PARITY_ROUNDS, "hash")))
        if n != N:
            continue
        # the public wrapper on the card against the same call on CPU copies
        wargs = tuple(a[:9] for a in args)  # the four families + a blackout
        kw = dict(num_values=V, rounds=PARITY_ROUNDS, after_decision=2,
                  mode="hash")
        k1_err = max(k1_err, compare(
            "otr_loop on the card vs the CPU",
            [t.cpu() for t in fused.otr_loop(*wargs, **kw)],
            fused.otr_loop(*_on_cpu(wargs), **kw)))
    say("K1-vs-plain", n=N, S=S_CHECK, rounds=PARITY_ROUNDS, V=V,
        rows="standard_mix + blackout p8=256, plus n=1000 and n=1008, plus "
             "the public wrapper vs CPU", outputs=6,
        tolerance=0, max_abs_err=k1_err, equal=True)

    # -- 4b. the new K1 instances and K3 against their plain versions -------
    def loop_inputs(n, S, x_values, heal_round=5):
        """The four-family mix with the p8 grid (blackout included) laid
        over every third row, and one initial vector for all scenarios."""
        mix = fast.standard_mix(gen, S, n, p_drop=P_DROP,
                                heal_round=heal_round, device=dev)
        grid = torch.tensor(P8_GRID, dtype=torch.int32, device=dev).repeat(
            S // len(P8_GRID) + 1)[:S]
        over = torch.arange(S, device=dev) % 3 == 0
        mix = mix.replace(p8=torch.where(over, grid, mix.p8).to(torch.int32))
        x0 = torch.randint(0, x_values, (n,), generator=gen, device=dev,
                           dtype=torch.int32).expand(S, n).contiguous()
        return mix, x0

    errs = {"floodmin_loop": 0.0, "benor_loop": 0.0, "lv_loop": 0.0}
    S_PUB = 14  # the public wrappers: the four families, every p8 of the grid
    for label, lalgo, rounds, xv in (
            ("V=16", fused.FloodMinLoop(num_values=16, f=2), 6, 16),
            ("V=1000", fused.FloodMinLoop(num_values=1000, f=2), 6, 1000),
            ("", fused.BenOrLoop(), 12, 2)):
        for n, S in CHECK_SHAPES:
            mix, x0 = loop_inputs(n, S, xv)
            args = (x0, *fast._mix_args(mix))
            errs[lalgo.kernel] = max(errs[lalgo.kernel], compare(
                f"{lalgo.kernel} {label} n={n}",
                fused._hist_loop_cuda(lalgo, *args, rounds, "hash"),
                fused._hist_loop_plain(lalgo, *args, rounds, "hash")))
        # the public runner on the card against the same call on CPU copies
        wmix, wx0 = loop_inputs(N, S_PUB, xv)
        if isinstance(lalgo, fused.FloodMinLoop):
            rnd = fast.FloodMinHist(lalgo.num_values, lalgo.f)
            st0 = FloodMinState.fresh(wx0[0], S_PUB, N)
            run, fields = fast.run_floodmin_loop, ("x", "decided", "decision")
        else:
            rnd, st0 = fast.BenOrHist(), BenOrState.fresh(wx0[0], S_PUB, N)
            run = fast.run_benor_loop
            fields = ("x", "can_decide", "vote", "decided", "decision")
        got = run(rnd, st0, wmix, rounds, mode="hash")
        want = run(rnd, tree_map(lambda t: t.cpu(), st0),
                   tree_map(lambda t: t.cpu(), wmix), rounds, mode="hash")
        errs[lalgo.kernel] = max(errs[lalgo.kernel], compare(
            f"{run.__name__} on the card vs the CPU",
            [getattr(got[0], f) for f in fields] + list(got[1:]),
            [getattr(want[0], f) for f in fields] + list(want[1:])))
    # FloodMin's per-side minima take up to eight sides; more take the
    # chunked walk with every link kept: 8 and 12 sides, healing at round
    # 3, payloads outside [0, V) among them, both streams
    algo_fm = fused.FloodMinLoop(num_values=16, f=2)
    many_sides_hw_err = 0.0
    for sides in (8, 12):
        for n, S in CHECK_SHAPES:
            mix, x0 = loop_inputs(n, S, 16, heal_round=3)
            mix = mix.replace(side=torch.randint(
                0, sides, (S, n), generator=gen, device=dev,
                dtype=torch.int32))
            x0 = torch.randint(-1, 18, (S, n), generator=gen, device=dev,
                               dtype=torch.int32)
            args = (x0, *fast._mix_args(mix))
            for mode in ("hash", "hw"):
                name = fused._launch_name("floodmin_loop", mode)
                err = compare(
                    f"{name} {sides} sides n={n}",
                    fused._hist_loop_cuda(algo_fm, *args, 5, mode),
                    fused._hist_loop_plain(algo_fm, *args, 5, mode))
                if mode == "hash":
                    errs["floodmin_loop"] = max(errs["floodmin_loop"], err)
                else:
                    many_sides_hw_err = max(many_sides_hw_err, err)
    say("K1-FloodMin-vs-plain", n=f"{N},1000,1008", S=f"{S_CHECK},7,7",
        rounds=6,
        V="16,1000", p8=",".join(map(str, P8_GRID)),
        cases="standard_mix + p8 grid, plus run_floodmin_loop vs CPU; 8 and "
              "12 sides (hash and hw), payloads -1..17 at V=16",
        outputs=5, tolerance=0, max_abs_err=errs["floodmin_loop"],
        hw_sides_max_abs_err=many_sides_hw_err, equal=True)
    say("K1-BenOr-vs-plain", n=f"{N},1000,1008", S=f"{S_CHECK},7,7",
        rounds=12,
        p8=",".join(map(str, P8_GRID)),
        cases="standard_mix + p8 grid, plus run_benor_loop vs CPU",
        outputs=7, tolerance=0, max_abs_err=errs["benor_loop"], equal=True)

    for n, S in ((N, S_CHECK), (1000, 7)):
        mix, x0 = loop_inputs(n, S, 64, heal_round=9)
        args = (x0, *fast._mix_args(mix))
        errs["lv_loop"] = max(errs["lv_loop"], compare(
            f"lv_loop n={n}", fused._lv_loop_cuda(*args, 20),
            fused._lv_loop_plain(*args, 20)))
    wmix, wx0 = loop_inputs(N, S_PUB, 64, heal_round=9)
    wargs = (wx0, *fast._mix_args(wmix))
    errs["lv_loop"] = max(errs["lv_loop"], compare(
        "lv_loop on the card vs the CPU", fused.lv_loop(*wargs, rounds=20),
        fused.lv_loop(*_on_cpu(wargs), rounds=20)))
    say("K3-vs-plain", n=f"{N},1000", S=f"{S_CHECK},7", rounds=20,
        heal_round=9, p8=",".join(map(str, P8_GRID)),
        cases="standard_mix + p8 grid, plus lv_loop vs CPU", outputs=9,
        tolerance=0, max_abs_err=errs["lv_loop"], equal=True)

    # -- 4c. the probes and the hw link stream against their plain versions -
    x = torch.randn(PROBE_SHAPE, generator=gen, device=dev)
    got, want = fused.probe_double(x).cpu(), fused.probe_double(x.cpu())
    p1_err = float((got - want).abs().max())
    require(torch.equal(got, want),
            f"probe_double differs from x * 2 (max_abs_err={p1_err})")
    seed = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    p2_err = compare("philox_bits vs its plain version",
                     [fused.philox_bits(seed, PROBE_SHAPE)],
                     [fused.philox_bits(seed.cpu(), PROBE_SHAPE)])
    for counter, key, words in PHILOX_KAT:
        kat = fused.philox_bits(fused._i32(torch.tensor(key)).to(dev), (4,),
                                counter=counter)
        require([w & 0xFFFFFFFF for w in kat.tolist()] == list(words),
                f"philox_bits at counter {counter}, key {key}: not "
                "Random123's known answer")
    say("P-vs-plain", shape="128x128", tolerance=0, p1_max_abs_err=p1_err,
        p2_max_abs_err=p2_err, known_answers=len(PHILOX_KAT), equal=True)

    hw_err = {"hist_exchange_hw": 0.0, "otr_loop_hw": 0.0,
              "floodmin_loop_hw": many_sides_hw_err, "benor_loop_hw": 0.0}
    hw_algos = ((fused.OtrLoop(num_values=V, after_decision=2),
                 PARITY_ROUNDS, V),
                (fused.FloodMinLoop(num_values=16, f=2), 6, 16),
                (fused.BenOrLoop(), 12, 2))
    for n, S in CHECK_SHAPES:
        vals = torch.randint(0, V, (S, n), generator=gen, device=dev,
                             dtype=torch.int32)
        active = torch.rand((S, n), generator=gen, device=dev) < 0.9
        colmask = torch.rand((S, n), generator=gen, device=dev) < 0.8
        rowmask = torch.rand((S, n), generator=gen, device=dev) < 0.9
        side = torch.randint(0, 2, (S, n), generator=gen, device=dev,
                             dtype=torch.int32)
        s0 = fast._salts(gen, S, 0, dev)
        s1 = fast._salts(gen, S, 1, dev)
        p8 = torch.tensor(P8_GRID, dtype=torch.int32,
                          device=dev).repeat(S // 7 + 1)[:S]
        senders = colmask & active & (p8 < 256)[:, None]
        for rm in (None, rowmask):
            for sd in (None, side):
                hw_err["hist_exchange_hw"] = max(
                    hw_err["hist_exchange_hw"], compare(
                        f"K2-hw vs its plain version (n={n}, rowmask="
                        f"{rm is not None}, side={sd is not None})",
                        [fused._hist_exchange_cuda(vals, senders, rm, sd, s0,
                                                   s1, p8, V, "hw")],
                        [fused._hist_exchange_plain(vals, senders, rm, sd,
                                                    s0, s1, p8, V, "hw")]))
        for lalgo, rounds, xv in hw_algos:
            mix, x0 = loop_inputs(n, S, xv)
            args = (x0, *fast._mix_args(mix))
            name = lalgo.kernel + "_hw"
            hw_err[name] = max(hw_err[name], compare(
                f"{name} n={n}",
                fused._hist_loop_cuda(lalgo, *args, rounds, "hw"),
                fused._hist_loop_plain(lalgo, *args, rounds, "hw")))
    # the public hw wrappers on the card against the same calls on CPU
    # copies, and the per-round engine against the whole-run kernel
    cut = slice(0, 14)  # every p8 of the grid twice
    wargs = (vals[cut], active[cut], colmask[cut], rowmask[cut], side[cut],
             s0[cut], s1[cut], p8[cut], V)
    hw_err["hist_exchange_hw"] = max(hw_err["hist_exchange_hw"], compare(
        "hist_exchange(hw) on the card vs the CPU",
        [fused.hist_exchange(*wargs, mode="hw").cpu()],
        [fused.hist_exchange(*_on_cpu(wargs), mode="hw")]))
    mix, x0 = loop_inputs(N, S_CHECK, V)
    wargs = (x0[cut], *(a[cut] for a in fast._mix_args(mix)))
    kw = dict(num_values=V, rounds=PARITY_ROUNDS, after_decision=2)
    hw_err["otr_loop_hw"] = max(hw_err["otr_loop_hw"], compare(
        "otr_loop(hw) on the card vs the CPU",
        [t.cpu() for t in fused.otr_loop(*wargs, **kw)],
        fused.otr_loop(*_on_cpu(wargs), **kw)))
    rnd = fast.OtrHist(n_values=V, after_decision=2)
    st_h, done_h, dr_h = fast.run_hist(
        rnd, OtrState.fresh(x0[0], S_CHECK, N), lambda s: s.decided, mix,
        PARITY_ROUNDS)
    st_l, done_l, dr_l = fast.run_otr_loop(
        rnd, OtrState.fresh(x0[0], S_CHECK, N), mix, PARITY_ROUNDS)
    fields = ("x", "decided", "decision", "after")
    compare("run_hist(hw) vs run_otr_loop(hw)",
            [getattr(st_h, f) for f in fields] + [done_h, dr_h],
            [getattr(st_l, f) for f in fields] + [done_l, dr_l])
    say("hw-vs-plain", n=f"{N},1000,1008", S=f"{S_CHECK},7,7",
        p8=",".join(map(str, P8_GRID)),
        cases="K2 rowmask x side; K1 OTR, FloodMin V=16, Ben-Or; the public "
              "hist_exchange and otr_loop vs CPU; run_hist(hw) vs "
              "run_otr_loop(hw)", tolerance=0,
        max_abs_err=json.dumps(hw_err).replace(" ", ""),
        run_hist_equals_loop=True)

    # -- 5. the main paths, through the bench's entry point ------------------
    common = ["--n", str(N), "--phases", str(ROUNDS), "--values", str(V),
              "--p-drop", str(P_DROP), "--seed", str(SEED), "--parity", "0",
              "--device", "cuda"]
    flag_args = ["--scenarios", str(S_FLAG), "--engine", "loop",
                 "--repeats", "2"]
    fused.reset_launches()
    flag_hash = bench.main(common + flag_args + ["--rng", "hash"])
    k1_launches = fused.LAUNCHES["otr_loop"]
    require(k1_launches > 0, "the hash flagship launched no K1 kernel")
    fe = flag_hash["extra"]
    say("flagship-hash", engine="loop", rng="hash", n=N, S=S_FLAG,
        rounds=ROUNDS, rounds_per_sec=flag_hash["value"],
        frac_lanes_decided=fe["frac_lanes_decided"],
        decided_round_p50=fe["decided_round_p50"], K1_launches=k1_launches)
    require(fe["frac_lanes_decided"] > 0.5, "the flagship decided too little")

    # the bench's default, hw links, with its parity (a hash-mode replay of
    # PARITY_K scenarios against the general engine)
    fused.reset_launches()
    flag = bench.main(common + flag_args + ["--parity", str(PARITY_K)])
    k1_hw_launches = fused.LAUNCHES["otr_loop_hw"]
    require(k1_hw_launches > 0, "the hw flagship launched no K1-hw kernel")
    hx = flag["extra"]
    require(hx["rng"] == "hw", f"the bench's default rng is {hx['rng']}")
    # Both runs draw the same mixes and initial values; only the link
    # stream differs.  Scenarios are the independent units, so the decided
    # fractions may differ by 4 standard deviations of the difference of
    # two binomial fractions over S_FLAG scenarios (the variance floored at
    # that of one scenario in S_FLAG); the p50 decided round by one round.
    f_hash = fe["frac_lanes_decided"]
    tol = 4 * math.sqrt(2 * max(f_hash * (1 - f_hash), 1 / S_FLAG) / S_FLAG)
    say("flagship", engine="loop", rng="hw", n=N, S=S_FLAG, rounds=ROUNDS,
        rounds_per_sec=flag["value"], hash_rounds_per_sec=flag_hash["value"],
        frac_lanes_decided=hx["frac_lanes_decided"],
        hash_frac_lanes_decided=f_hash, tolerance=round(tol, 6),
        decided_round_p50=hx["decided_round_p50"],
        hash_decided_round_p50=fe["decided_round_p50"],
        parity_frac=hx["parity_frac"], K1_hw_launches=k1_hw_launches)
    require(abs(hx["frac_lanes_decided"] - f_hash) <= tol,
            "the hw flagship's decided fraction is off the hash one's")
    require(abs(hx["decided_round_p50"] - fe["decided_round_p50"]) <= 1,
            "the hw flagship's p50 decided round is off the hash one's")
    require(hx["parity_frac"] == 1.0,
            f"hw flagship parity {hx['parity_frac']} != 1.0")

    round_args = ["--scenarios", str(S_FUSED), "--engine", "fused",
                  "--repeats", "1"]
    fused.reset_launches()
    per_round = bench.main(common + round_args + ["--rng", "hash"])
    k2_launches = fused.LAUNCHES["hist_exchange"]
    require(k2_launches > 0, "the per-round path launched no K2 kernel")
    say("per-round", engine="fused", rng="hash", n=N, S=S_FUSED,
        rounds=ROUNDS, rounds_per_sec=per_round["value"],
        frac_lanes_decided=per_round["extra"]["frac_lanes_decided"],
        K2_launches=k2_launches)
    fused.reset_launches()
    per_round_hw = bench.main(common + round_args)
    k2_hw_launches = fused.LAUNCHES["hist_exchange_hw"]
    require(k2_hw_launches > 0, "the hw per-round path launched no K2-hw")
    say("per-round-hw", engine="fused", rng="hw", n=N, S=S_FUSED,
        rounds=ROUNDS, rounds_per_sec=per_round_hw["value"],
        frac_lanes_decided=per_round_hw["extra"]["frac_lanes_decided"],
        K2_hw_launches=k2_hw_launches)

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
                                 PARITY_ROUNDS, mode="hash")
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

    # -- 6b. the config ladder at its reference shapes -----------------------
    rung_launches = {}
    for name, kernels in RUNG_KERNELS.items():
        fused.reset_launches()
        res = ladder.RUNGS[name](repeats=2, device=dev)
        launches = {k: v for k, v in fused.LAUNCHES.items() if v}
        rung_launches[name] = launches
        ex = res["extra"]
        parity = ex.get("parity_frac", ex.get("loop_parity_frac"))
        spec = {k: v for k, v in ex.items() if k.endswith("_parity")}
        say(f"ladder-{name}", metric=res["metric"],
            rounds_per_sec=ex["rounds_per_sec"],
            **({"loop_rounds_per_sec": ex["loop_rounds_per_sec"]}
               if "loop_rounds_per_sec" in ex else {}),
            frac_lanes_decided=ex["frac_lanes_decided"], parity_frac=parity,
            **spec, launches=json.dumps(launches).replace(" ", ""))
        require(parity == 1.0, f"ladder rung {name}: parity {parity} != 1.0")
        require(all(v is True for v in spec.values()),
                f"ladder rung {name}: a spec parity is false: {spec}")
        for kernel in kernels:
            require(launches.get(kernel, 0) > 0,
                    f"ladder rung {name} launched no {kernel} kernel")

    # -- 6c. the bisect tool, each stage in its own process ------------------
    t0 = time.perf_counter()
    cp = subprocess.run(
        [sys.executable, "-m", "round_tpu_torch.tools.bisect"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    stages = {}
    for line in cp.stdout.splitlines():
        if line.startswith("{"):
            stages.update(json.loads(line))
    bisect_launches = {}
    for res in stages.values():
        for k, v in res.get("launches", {}).items():
            bisect_launches[k] = bisect_launches.get(k, 0) + v
    say("bisect", stages=len(stages),
        ok=sum(bool(r["ok"]) for r in stages.values()),
        wall_s=round(time.perf_counter() - t0, 1),
        launches=json.dumps(bisect_launches).replace(" ", ""))
    require(cp.returncode == 0 and stages and all(
        r["ok"] for r in stages.values()),
        f"bisect failed (exit {cp.returncode}):\n{cp.stdout[-3000:]}\n"
        f"{cp.stderr[-3000:]}")
    for kernel in ("probe_double", "philox_bits", "otr_loop_hw",
                   "hist_exchange_hw"):
        require(bisect_launches.get(kernel, 0) > 0,
                f"the bisect tool launched no {kernel} kernel")

    # -- 7. kernel times, bounds, plain and library times --------------------
    # K1 at the flagship shape (the flagship mix of seed SEED), in both
    # streams, timed before their plain versions run and again after them,
    # with the card's clock, power and temperature read while each ran
    x0 = init.expand(S_FLAG, N).contiguous()
    args = (x0, mix.crashed, mix.side, mix.crash_round, mix.heal_round,
            mix.rotate_down, mix.p8, mix.salt0, mix.salt1)

    def k1_timed(mode):
        return sampled(lambda: event_ms(
            lambda: fused._hist_loop_cuda(algo, *args, ROUNDS, mode),
            reps=10))

    (k1_ms, out), k1_smi = k1_timed("hash")
    (k1hw_ms, out_hw), k1hw_smi = k1_timed("hw")
    k1_links = loop_links(mix, out[5], ROUNDS, linger=1)
    k1_bytes = loop_bytes(S_FLAG, N, 6)
    k1_bound, k1_by, k1_pipe = bound_ms(k1_bytes, k1_links)
    k1_bound_walk = bound_ms(k1_bytes, k1_links, HASH_OPS_WALK)[0]
    (k1_plain_ms, plain), plain_smi = sampled(lambda: plain_ms(
        lambda: fused._hist_loop_plain(algo, *args, ROUNDS, "hash")), 500)
    compare("K1 at the flagship shape", out, plain)
    # K1-hw's plain version on the first S_PLAIN_HW scenarios (each
    # scenario's run depends on its own row alone)
    k1hw_links = loop_links(mix, out_hw[5], ROUNDS, linger=1)
    k1hw_bound, k1hw_by, k1hw_pipe = bound_ms(k1_bytes, k1hw_links, HW_OPS)
    k1hw_bound_walk = bound_ms(k1_bytes, k1hw_links, HW_OPS_WALK)[0]
    cut = slice(0, S_PLAIN_HW)
    k1hw_plain_ms, plain = plain_ms(lambda: fused._hist_loop_plain(
        algo, *(a[cut] for a in args), ROUNDS, "hw"))
    compare(f"K1-hw at the flagship shape (first {S_PLAIN_HW} scenarios)",
            [o[cut] for o in out_hw], plain)
    (k1_ms_after, _), k1_smi_after = k1_timed("hash")
    (k1hw_ms_after, _), k1hw_smi_after = k1_timed("hw")

    def smi_json(d):
        return json.dumps(d, separators=(",", ":"))

    for line, ms, after, smi_b, smi_a, p_ms, bnd, by, pipe, walk, links, \
            o in (("K1-time", k1_ms, k1_ms_after, k1_smi, k1_smi_after,
                   k1_plain_ms, k1_bound, k1_by, k1_pipe, k1_bound_walk,
                   k1_links, out),
                  ("K1-hw-time", k1hw_ms, k1hw_ms_after, k1hw_smi,
                   k1hw_smi_after, k1hw_plain_ms, k1hw_bound, k1hw_by,
                   k1hw_pipe, k1hw_bound_walk, k1hw_links, out_hw)):
        cnt, hist = decided_summary(o[1] != 0, o[5], ROUNDS)
        say(line, ms=round(ms, 3), ms_after_plain=round(after, 3),
            plain_ms=round(p_ms, 1),
            **({"plain_scenarios": S_PLAIN_HW} if o is out_hw else {}),
            bound_ms=round(bnd, 3), bound_by=by, pipe=pipe,
            walk_bound_ms=round(walk, 3),
            bytes_ms=round(k1_bytes / HBM_BYTES_PER_S * 1e3, 4),
            drawn_links=f"{links:.4g}",
            frac_lanes_decided=round(float(cnt) / (S_FLAG * N), 4),
            decided_round_p50=p50_from_hist(hist.cpu()),
            smi=smi_json(smi_b), smi_after_plain=smi_json(smi_a))
    say("K1-plain-smi", smi=smi_json(plain_smi))

    # K1's two counts of a round that keeps every link, on the flagship's
    # partition family alone (S_FLAG / 4 scenarios, its five sided rounds,
    # p8 = 0): two sides count by per-side totals; nine, more than the
    # kernels give slots (rt_kMaxSides = 8), by the product with the side
    # mask.  No lane decides in either, so only the count differs.
    s_part, r_part = S_FLAG // 4, 5
    pgen = torch.Generator(device=dev).manual_seed(SEED + 5)
    part_ms = {}
    for sides in (2, 9):
        z = torch.zeros(s_part, dtype=torch.int32, device=dev)
        pmix = fast.FaultMix(
            crashed=torch.zeros((s_part, N), dtype=torch.bool, device=dev),
            crash_round=z,
            side=torch.randint(0, sides, (s_part, N), generator=pgen,
                               device=dev, dtype=torch.int32),
            heal_round=z + r_part, rotate_down=z, p8=z,
            salt0=fast._salts(pgen, s_part, 0, dev),
            salt1=fast._salts(pgen, s_part, 1, dev))
        pargs = (init.expand(s_part, N).contiguous(), *fast._mix_args(pmix))
        ms, pout = event_ms(lambda: fused._hist_loop_cuda(
            algo, *pargs, r_part, "hw"), reps=5)
        compare(f"K1 on the partition family, {sides} sides", pout,
                fused._hist_loop_plain(algo, *pargs, r_part, "hw"))
        require(not bool((pout[5] >= 0).any()),
                f"a lane decided in a sided round ({sides} sides)")
        part_ms[sides] = ms
    say("K1-totals", scenarios=s_part, rounds=r_part,
        totals_ms=round(part_ms[2], 4), product_ms=round(part_ms[9], 4),
        kept_links=f"{s_part * r_part * N * (N - 1):.4g}")

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
    onehot = ((vals[:, None, :] == rows[None, :, None])
              & senders[:, None, :]).to(torch.float32)
    hashed = ((p8 > 0) & (p8 < 256)).to(torch.float64)
    k2_links = float((hashed * senders.sum(1).to(torch.float64)
                      * (N - 1)).sum())
    k2_bytes = 4 * S_FUSED * N * 3 + 4 * 3 * S_FUSED + 4 * S_FUSED * V * N
    k2_rows = {}
    for mode, ops, walk in (("hash", HASH_OPS, HASH_OPS_WALK),
                            ("hw", HW_OPS, HW_OPS_WALK)):
        k2m_ms, k2m_issue, k2m_host, got = card_times(
            torch, lambda: fused._hist_exchange_cuda(*k2_args, mode), 20)
        k2m_plain_ms, want = plain_ms(
            lambda: fused._hist_exchange_plain(*k2_args, mode))
        compare(f"K2 ({mode}) at the per-round shape", [got], [want])
        bnd, by, pipe = bound_ms(k2_bytes, k2_links, ops)
        walk_ms = bound_ms(k2_bytes, k2_links, walk)[0]
        # yardstick only (the port never calls it): one torch.bmm of the
        # one-hot senders and the materialised keep mask
        keep = torch.empty((S_FUSED, N, N), dtype=torch.float32, device=dev)
        for sl in fused._chunks(S_FUSED, N):
            k = fused._keep_mask(N, mode, salt0[sl], salt1r[sl], p8[sl])
            k = k & (side_r[sl][:, :, None] == side_r[sl][:, None, :])
            keep[sl] = k.to(torch.float32)
        lib_m_ms, lib_out = event_ms(
            lambda: torch.bmm(onehot, keep.transpose(1, 2)), reps=5)
        require(torch.equal(lib_out, got),
                f"the bmm yardstick disagrees with K2 ({mode})")
        del keep, lib_out
        say("K2-time" if mode == "hash" else "K2-hw-time",
            ms=round(k2m_ms, 4), issue_ms=round(k2m_issue, 4),
            host_ms=round(k2m_host, 4), plain_ms=round(k2m_plain_ms, 1),
            bound_ms=round(bnd, 4), bound_by=by, pipe=pipe,
            walk_bound_ms=round(walk_ms, 4),
            bytes_ms=round(k2_bytes / HBM_BYTES_PER_S * 1e3, 4),
            library_ms=round(lib_m_ms, 3), drawn_links=f"{k2_links:.4g}")
        k2_rows[mode] = (k2m_ms, k2m_plain_ms, bnd, by, lib_m_ms, k2m_issue,
                         k2m_host)
    k2_ms, k2_plain_ms, k2_bound, k2_by, lib_ms = k2_rows["hash"][:5]

    # K1 FloodMin at its rung's shape (crash mix: p8 = 0, nothing hashed)
    fgen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n, S, f, Vf, rounds = 64, 256, 2, 1000, 4
    mix = ladder._crash_mix(fgen, S, n, f, dev)
    x0 = torch.randint(0, Vf, (n,), generator=fgen, device=dev,
                       dtype=torch.int32).expand(S, n).contiguous()
    algo_fm = fused.FloodMinLoop(num_values=Vf, f=f)
    args = (x0, *fast._mix_args(mix))
    fm_bytes = loop_bytes(S, n, 5)
    fm_rows = {}
    for mode, ops in (("hash", HASH_OPS), ("hw", HW_OPS)):
        ms, issue, host, out = card_times(torch, lambda: fused._hist_loop_cuda(
            algo_fm, *args, rounds, mode), 20)
        p_ms, plain = plain_ms(
            lambda: fused._hist_loop_plain(algo_fm, *args, rounds, mode))
        compare(f"floodmin_loop ({mode}) at the rung's shape", out, plain)
        links = loop_links(mix, out[-1], rounds, linger=0)
        bnd, by, pipe = bound_ms(fm_bytes, links, ops)
        name = fused._launch_name("floodmin_loop", mode)
        say("K1-FloodMin-time" if mode == "hash" else "K1-FloodMin-hw-time",
            n=n, S=S, V=Vf, rounds=rounds,
            launches=rung_launches["floodmin"].get(name, 0),
            ms=round(ms, 5), issue_ms=round(issue, 5), host_ms=round(host, 5),
            plain_ms=round(p_ms, 2), bound_ms=round(bnd, 5), bound_by=by,
            pipe=pipe, drawn_links=f"{links:.4g}")
        fm_rows[mode] = (ms, p_ms, bnd, by, issue, host)

    # K1 FloodMin at the flagship's widths on the four-family mix (its iid
    # omission rows draw links), V=16, f=2: plain on the first S_PLAIN_HW
    fgen = torch.Generator(device=dev).manual_seed(SEED + 8)
    n, S, f, Vf = N, S_FLAG, 2, V
    rounds = f + 2  # every lane decides in round f + 1
    mix = fast.standard_mix(fgen, S, n, p_drop=P_DROP, device=dev)
    x0 = torch.randint(0, Vf, (n,), generator=fgen, device=dev,
                       dtype=torch.int32).expand(S, n).contiguous()
    algo_fmw = fused.FloodMinLoop(num_values=Vf, f=f)
    args = (x0, *fast._mix_args(mix))
    cut = slice(0, S_PLAIN_HW)
    fmw_bytes = loop_bytes(S, n, 5)
    for mode, ops in (("hash", HASH_OPS), ("hw", HW_OPS)):
        ms, issue, host, out = card_times(torch, lambda: fused._hist_loop_cuda(
            algo_fmw, *args, rounds, mode), 3)
        p_ms, plain = plain_ms(lambda: fused._hist_loop_plain(
            algo_fmw, *(a[cut] for a in args), rounds, mode))
        compare(f"floodmin_loop ({mode}) at n={n} x {S} (first "
                f"{S_PLAIN_HW} scenarios)", [o[cut] for o in out], plain)
        links = loop_links(mix, out[-1], rounds, linger=0)
        bnd, by, pipe = bound_ms(fmw_bytes, links, ops)
        say("K1-FloodMin-wide-time" if mode == "hash"
            else "K1-FloodMin-wide-hw-time", n=n, S=S, V=Vf, rounds=rounds,
            mix="standard", ms=round(ms, 5), issue_ms=round(issue, 5),
            host_ms=round(host, 5), plain_ms=round(p_ms, 2),
            plain_scenarios=S_PLAIN_HW, bound_ms=round(bnd, 5), bound_by=by,
            pipe=pipe, bytes_ms=round(fmw_bytes / HBM_BYTES_PER_S * 1e3, 5),
            drawn_links=f"{links:.4g}")
        fm_rows[mode + "-wide"] = (ms, p_ms, bnd, by, issue, host)

    # K1 Ben-Or at its rung's shape (iid omission at p8 = 13)
    bgen = torch.Generator(device=dev).manual_seed(SEED + 3)
    n, S, rounds = 512, 4096, 16
    mix = ladder.benor_mix(bgen, S, n, 0.05, dev)
    x0 = (torch.rand((n,), generator=bgen, device=dev) < 0.5).to(
        torch.int32).expand(S, n).contiguous()
    algo_bo = fused.BenOrLoop()
    args = (x0, *fast._mix_args(mix))
    bo_bytes = loop_bytes(S, n, 7)
    bo_rows = {}
    for mode, ops, walk in (("hash", HASH_OPS, HASH_OPS_WALK),
                            ("hw", HW_OPS, HW_OPS_WALK)):
        ms, out = event_ms(lambda: fused._hist_loop_cuda(
            algo_bo, *args, rounds, mode), reps=5)
        p_ms, plain = plain_ms(
            lambda: fused._hist_loop_plain(algo_bo, *args, rounds, mode))
        compare(f"benor_loop ({mode}) at the rung's shape", out, plain)
        links = loop_links(mix, out[-1], rounds, linger=0)
        bnd, by, pipe = bound_ms(bo_bytes, links, ops)
        walk_ms = bound_ms(bo_bytes, links, walk)[0]
        name = fused._launch_name("benor_loop", mode)
        say("K1-BenOr-time" if mode == "hash" else "K1-BenOr-hw-time",
            n=n, S=S, rounds=rounds,
            launches=rung_launches["benor"].get(name, 0), ms=round(ms, 4),
            plain_ms=round(p_ms, 2), bound_ms=round(bnd, 5), bound_by=by,
            pipe=pipe, walk_bound_ms=round(walk_ms, 5),
            drawn_links=f"{links:.4g}",
            frac_lanes_decided=round(float((out[3] != 0).float().mean()),
                                     4))
        bo_rows[mode] = (ms, p_ms, bnd, by)

    # K3 at the lv rung's shape (crash mix), then on the four-family mix
    lgen = torch.Generator(device=dev).manual_seed(SEED + 4)
    lv_rows = []
    for n, S, rounds, kind, reps in ((256, 256, 16, "crash", 20),
                                     (LV_N, LV_S, LV_ROUNDS, "standard", 3)):
        mix = (ladder._crash_mix(lgen, S, n, max(1, n // 32), dev)
               if kind == "crash" else
               fast.standard_mix(lgen, S, n, p_drop=P_DROP, device=dev))
        x0 = torch.randint(0, 64, (n,), generator=lgen, device=dev,
                           dtype=torch.int32).expand(S, n).contiguous()
        args = (x0, *fast._mix_args(mix))
        ms, issue, host, out = card_times(
            torch, lambda: fused._lv_loop_cuda(*args, rounds), reps)
        p_ms, plain = plain_ms(lambda: fused._lv_loop_plain(*args, rounds))
        compare(f"lv_loop at n={n} x {S} x {rounds}", out, plain)
        links = lv_links(mix, out[8], rounds)
        nbytes = loop_bytes(S, n, 9)
        bnd, by, pipe = bound_ms(nbytes, links)
        say("K3-time", n=n, S=S, rounds=rounds, mix=kind,
            launches=rung_launches["lv"].get("lv_loop", 0), ms=round(ms, 5),
            issue_ms=round(issue, 5), host_ms=round(host, 5),
            plain_ms=round(p_ms, 2), bound_ms=round(bnd, 5), bound_by=by,
            pipe=pipe, walk_bound_ms=round(
                bound_ms(nbytes, links, HASH_OPS_WALK)[0], 5), bytes_ms=round(nbytes / HBM_BYTES_PER_S * 1e3, 5),
            hashed_links=f"{links:.4g}",
            frac_lanes_decided=round(float((out[5] != 0).float().mean()), 4))
        lv_rows.append((ms, p_ms, bnd, by, issue, host))
    lv_ms, lv_plain_ms, lv_bound, lv_by = lv_rows[-1][:4]

    # P1 and P2 at the bisect shape, timed as K4 is: queued behind a sleep
    # kernel (the card's time) and back to back (the host's issue time).
    # P1's plain version is x * 2.0, the same call as the library's
    # torch.mul, timed both ways too; no PyTorch call draws a keyed Philox
    # stream, so P2 has no library time.
    x = torch.randn(PROBE_SHAPE, generator=gen, device=dev)
    p1_ms = queued_ms(torch, lambda: fused.probe_double(x), 100)
    p1_issue_ms, got = event_ms(lambda: fused.probe_double(x), reps=100)
    p1_plain_ms, want = plain_ms(lambda: x * 2.0)
    require(torch.equal(got, want), "probe_double differs from x * 2")
    p1_lib_ms = queued_ms(torch, lambda: torch.mul(x, 2.0), 100)
    p1_lib_issue_ms, _ = event_ms(lambda: torch.mul(x, 2.0), reps=100)
    p1_bound, p1_by, _pipe = bound_ms(2 * 4 * x.numel(), 0)
    say("P1-time", ms=round(p1_ms, 5), issue_ms=round(p1_issue_ms, 5),
        plain_ms=round(p1_plain_ms, 4), library_ms=round(p1_lib_ms, 5),
        library_issue_ms=round(p1_lib_issue_ms, 5),
        library="torch.mul(x, 2.0)", bound_ms=f"{p1_bound:.3g}",
        bound_by=p1_by)
    m = PROBE_SHAPE[0] * PROBE_SHAPE[1]
    p2_ms = queued_ms(torch, lambda: fused.philox_bits(seed, PROBE_SHAPE),
                      100)
    p2_issue_ms, got = event_ms(lambda: fused.philox_bits(seed, PROBE_SHAPE),
                                reps=100)
    p2_plain_ms, want = plain_ms(
        lambda: fused._philox_bits_plain(seed, m, (0, 0, 0, 0)))
    compare("philox_bits at the bisect shape", [got.reshape(-1)], [want])
    p2_bound, p2_by, p2_pipe = bound_ms(8 + 4 * m, m / 4, PHILOX_OPS)
    say("P2-time", ms=round(p2_ms, 5), issue_ms=round(p2_issue_ms, 5),
        plain_ms=round(p2_plain_ms, 4), bound_ms=f"{p2_bound:.3g}",
        bound_by=p2_by, pipe=p2_pipe)
    host_breakdown(torch, x)

    # -- 8. K4 and the sharded paths ------------------------------------------
    ring_kernels = sharded_phases(torch, gen)

    kernels = [
        {"name": "otr_loop", "route": "cuda",
         "source": "round_tpu_torch/csrc/hist_loop.cu",
         "replaces": "round_tpu/ops/fused.py:557",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "hist_exchange", "route": "cuda",
         "source": "round_tpu_torch/csrc/hist_exchange.cu",
         "replaces": "round_tpu/ops/fused.py:167",
         "launches": k2_launches, "max_abs_err": k2_err,
         "ms": k2_ms, "issue_ms": k2_rows["hash"][5],
         "host_ms": k2_rows["hash"][6], "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": lib_ms},
        {"name": "otr_loop_hw", "route": "cuda",
         "source": "round_tpu_torch/csrc/hist_loop.cu",
         "replaces": "round_tpu/ops/fused.py:557",
         "launches": k1_hw_launches, "max_abs_err": hw_err["otr_loop_hw"],
         "ms": k1hw_ms, "plain_ms": k1hw_plain_ms,
         "plain_scenarios": S_PLAIN_HW, "bound_ms": k1hw_bound,
         "bound_by": k1hw_by, "library_ms": None},
        {"name": "hist_exchange_hw", "route": "cuda",
         "source": "round_tpu_torch/csrc/hist_exchange.cu",
         "replaces": "round_tpu/ops/fused.py:167",
         "launches": k2_hw_launches,
         "max_abs_err": hw_err["hist_exchange_hw"], "ms": k2_rows["hw"][0],
         "issue_ms": k2_rows["hw"][5], "host_ms": k2_rows["hw"][6],
         "plain_ms": k2_rows["hw"][1], "bound_ms": k2_rows["hw"][2],
         "bound_by": k2_rows["hw"][3], "library_ms": k2_rows["hw"][4]},
    ]
    # no single PyTorch call computes a whole run: library_ms is null
    for name, rows, rung, err in (
            ("floodmin_loop", fm_rows, "floodmin", errs["floodmin_loop"]),
            ("benor_loop", bo_rows, "benor", errs["benor_loop"])):
        for mode in ("hash", "hw"):
            kname = fused._launch_name(name, mode)
            ms, p_ms, bnd, by = rows[mode][:4]
            row = {
                "name": kname, "route": "cuda",
                "source": "round_tpu_torch/csrc/hist_loop.cu",
                "replaces": "round_tpu/ops/fused.py:557",
                "launches": rung_launches[rung].get(kname, 0),
                "max_abs_err": err if mode == "hash" else hw_err[kname],
                "ms": ms, "plain_ms": p_ms, "bound_ms": bnd, "bound_by": by,
                "library_ms": None}
            if name == "floodmin_loop":
                row["issue_ms"] = rows[mode][4]
                w = rows[mode + "-wide"]
                row["wide"] = {"shape": f"{N}x{S_FLAG}x4 V={V} standard mix",
                               "ms": w[0], "issue_ms": w[4],
                               "plain_ms": w[1],
                               "plain_scenarios": S_PLAIN_HW,
                               "bound_ms": w[2], "bound_by": w[3]}
            kernels.append(row)
    kernels += [
        {"name": "lv_loop", "route": "cuda",
         "source": "round_tpu_torch/csrc/lv_loop.cu",
         "replaces": "round_tpu/ops/fused.py:965",
         "launches": rung_launches["lv"].get("lv_loop", 0),
         "max_abs_err": errs["lv_loop"], "ms": lv_ms,
         "issue_ms": lv_rows[-1][4], "plain_ms": lv_plain_ms,
         "bound_ms": lv_bound, "bound_by": lv_by, "library_ms": None,
         "rung": {"shape": "256x256x16 crash mix", "ms": lv_rows[0][0],
                  "issue_ms": lv_rows[0][4], "plain_ms": lv_rows[0][1],
                  "bound_ms": lv_rows[0][2], "bound_by": lv_rows[0][3]}},
        {"name": "probe_double", "route": "cuda",
         "source": "round_tpu_torch/csrc/probe.cu",
         "replaces": "tools/tpu_bisect.py:31",
         "launches": bisect_launches["probe_double"], "max_abs_err": p1_err,
         "ms": p1_ms, "issue_ms": p1_issue_ms, "plain_ms": p1_plain_ms,
         "bound_ms": p1_bound, "bound_by": p1_by, "library_ms": p1_lib_ms,
         "library_issue_ms": p1_lib_issue_ms},
        {"name": "philox_bits", "route": "cuda",
         "source": "round_tpu_torch/csrc/probe.cu",
         "replaces": "tools/tpu_bisect.py:45",
         "launches": bisect_launches["philox_bits"], "max_abs_err": p2_err,
         "ms": p2_ms, "issue_ms": p2_issue_ms, "plain_ms": p2_plain_ms,
         "bound_ms": p2_bound, "bound_by": p2_by, "library_ms": None},
    ]
    kernels += ring_kernels
    for row in kernels:
        if row["name"] in sass:
            row["sass_per_link"] = sass[row["name"]]["per_link"]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
