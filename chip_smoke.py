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
                   combination, at V=16 and at V=24 and 32 (the kernel's
                   second value pass; 32 is KSet's doubled domain), the
                   public hist_exchange on the card against the CPU
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
  hw-vs-plain      K2 (V=16, 24, 32) and the three K1 instances in hw
                   mode, n=1024 x 64,
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
  ladder-epsilon   the fifth rung, ε-agreement at n=1024 x 32 x 8 phases,
                   f=100, byzantine-silence masks, on the count-rank engine
                   (no kernel of its own): rounds/sec, parity_exact against
                   the general engine, property_parity, the peak GiB
  eps-breakdown    the ε rung's round split into its steps (masks, the
                   count products, one order statistic, the tree sum)
  dryrun-eps       the dry run's ε segment on a 1 x 2 thread mesh of cuda:0
                   (scenario-sharded, raw-bit against one shard)
  dryrun-pbft-vc   its PBFT view-change segment on the same mesh
                   (scenario-sharded, bit for bit against one shard)
  bench-ladder     the bench's ladder arm: --ladder-only epsilon,lv with
                   --lite (--ladder-only wins over --lite's --no-ladder):
                   the lite flagship line, then one line per named rung
  event-models     LastVotingEvent, TwoPhaseCommitEvent (both modes),
                   ShortLastVoting, MultiLastVoting and LastVotingBytes on
                   the general engine on the card, bit for bit against the
                   same runs on the CPU
  families-wide    the engines of the last histogram slice through their
                   public entry points at their users' widths: KSet
                   (run_hist through K2 at V=32, n=1024 x 10,000 x 18, hw
                   on the four-family mix and hash on a crash-only mix:
                   K2 launches = rounds, at most k decisions, every lane
                   decided), ◇S and Θ (n=1024 x 256, [S, n, n] state),
                   PBFT (n=100 x 10,000) and PBFT with view change
                   (n=100 x 1,000, a primary-crash witness), the token ring
                   and Game of Life (n=1024 x 1,000 x 50), the HO
                   statistics; each bit for bit against CPU copies of its
                   first 8 rows and field by field against a hash replay
                   of 2 rows through the general engine; ms, rounds/sec
                   and peak GiB of a timed run, one line an engine, then a
                   summary line
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
                   both ways, and the launch floor beside P1 and P2: the
                   card time of torch.cuda._sleep(0), a one-thread kernel
                   with nothing to do, queued the same way
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

  fuzz-eval        the fault-schedule fuzzer (round_tpu_torch/fuzz, no kernel
                   of its own): one evaluation of 1,024 OTR genomes (n=4,
                   12 rounds) on the card, every outcome field and the score
                   bit for bit against the CPU, run_round steps = horizon
  fuzz-search      the documented search shape: OTR, n=4, 12 rounds, pop
                   1,024, 30 generations, one evaluation each
  fuzz-value       PBFT and PBFT-VC in-envelope value sweeps (pop 512, 10
                   generations, one liar at most): no honest safety
                   violation; the first generation equal to the CPU's
  fuzz-minimize    the known-bad genome minimized on the card and the CPU
  fuzz-pop         one evaluation at P = 1,024, 4,096, 16,384: ms,
                   schedules/sec, peak GiB above what was held before, the
                   host's launch calls, the device's kernels and copies
                   (torch.profiler) and host syncs; launch calls must not
                   grow with P, syncs stay below one a round

  perftest-otr, perftest-lv
                   the in-process runtime (round_tpu_torch/runtime, no
                   kernel of its own): round_tpu_torch.apps.perftest's
                   run at n=4, a backlog of 4,096 instances at -rt 1,024
                   and its first 512 at -rt 16, omission 0.05, 64
                   phases: decided of total, wall, decisions/sec, a
                   window's launch calls, kernels and copies
                   (torch.profiler) and host syncs, peak GiB; the card's
                   decision log (rounds and values) equal to the CPU's on
                   the same keys (the first 256 instances at -rt 16, all
                   4,096 and the digest at -rt 1,024); launches per
                   window equal at both rates
  smr              ReplicatedStateMachine, LastVoting, n=4, batches of 64,
                   4,096 commands (64 instances), the counter state machine:
                   decisions, applied state and digest equal to the CPU's; a
                   checkpoint written on the card restored into a fresh
                   replica equal to its never-crashed twin; a lagging
                   replica recovers every gap
  membership       MembershipManager: one add and one remove decided on the
                   card, the directory and view numbers equal to the CPU's

  host-wire        the wire (round_tpu_torch/runtime/codec.py, transport.py,
                   no kernel): every selector model's round payloads,
                   sent on cuda:0, encode to the bytes of the same payloads
                   from the CPU with 0 pickle fallbacks; µs per encode,
                   decode, device-to-host fetch and recv_many drain
  host-threads     4 HostRunner threads on cuda:0 over localhost TCP (the
                   host runner, no kernel): host_perftest.measure, OTR and
                   LastVoting, 20 instances each, every instance agreed
                   and the decision logs equal to the same run on the CPU;
                   decisions/sec, ms per round, copies, host syncs and
                   kernel launches per round per replica, and the time a
                   replica's device-to-host copy waits on the shared stream
  host-processes   host_perftest.measure_processes: 4 host_replica processes
                   on cuda:0, 100 OTR instances: every log equal, every
                   instance agreed; decisions/sec, each process's start-up
                   seconds and peak GiB
  host-chaos       one thread-mode OTR run on cuda:0 under a seeded drop
                   plan: agreement and validity hold; the dropped links are
                   exactly host_link_u32's, and link_bernoulli's on the card

  lanes-step       the lane driver's mega-step (round_tpu_torch/engine/
                   executor.py LaneStep, no kernel of its own) at L=64,
                   n=4 for OTR, LastVoting, LastVotingEvent and
                   LastVotingBytes at 64 B, random rounds within each round
                   class, a random active mask: send, update and go probe
                   on the card bit for bit against the CPU and against the
                   per-instance trio lane by lane; launch calls of one
                   send and one update dispatch at L=16 and L=64 (equal)
  lanes-equiv      round_tpu's tests/test_lanes.py clusters, 3 replica
                   threads: the lane driver on cuda:0, the per-instance
                   driver on cuda:0 and the lane driver on the CPU give
                   one decision log (OTR mixed, LastVotingEvent,
                   LastVotingBytes, OTR under a drop plan)
  lanes-ab         host_perftest.measure_lanes_ab at its defaults (n=4, 64
                   OTR instances, lanes=64, 3 pairs, threads on cuda:0),
                   then one instrumented lane run: per update wave the
                   dispatches, instances per dispatch, copies, host syncs,
                   launches and host ms by step
  overload         host_perftest.measure_overload_ab at its defaults (4
                   process clusters on cuda:0): the hardened ratio, every
                   arm's sheds NACK-accounted
  fleet-open-loop  host_perftest.measure_open_loop: 4 shard processes on
                   cuda:0 under 100 proposals/sec, every request decided,
                   p50/p99, start-up s and peak GiB a shard

  rv-step          the monitored mega-step (LaneStep reading the decision
                   plane in its update's vmap, the rv/compile.py verdicts
                   over the lanes) at L=64, n=4 for OTR and LastVoting:
                   state, exits, verdicts and the decision plane on the
                   card bit for bit against the CPU,
                   inactive lanes unchanged; launch calls of one update
                   with monitors off and on; a one-replica loopback lane
                   run with monitors off and on: the same log, dispatches
                   and copies each way per update wave
  rv-cluster       rv-broken-validity and rv-broken-agreement under halt,
                   shed and log in the lane and sequential drivers on
                   cuda:0 (validity against the CPU's logs, verdicts and
                   errors); one dumped artifact through fuzz_cli replay
  replay-bank      every tests/regressions/ artifact through check_engine
                   on the card against its recorded expected.engine
  rv-ab            host_perftest.measure_rv_ab at its defaults:
                   host_otr_n4_rv_overhead with round_tpu's gate verdict
  rv-ab-gate       the same A/B at round_tpu's soak gate settings
                   (tools/soak.py check_host_rv: LastVoting, 24 instances,
                   8 lanes, 3 pairs): host_lv_n4_rv_overhead and the gate
  snap-ab          host_perftest.measure_snap_ab at its defaults:
                   host_lvb_n4_snap_overhead with the gate verdict; then
                   snap-broken-conservation caught by the collector's
                   audit on the card with the rv monitors silent
  hostile          fuzz/hostile.py run_gate over 10,000 frames
  crosscheck       byz/crosscheck.py for otr, lastvoting and pbft at n=4
                   and 10,000 in-envelope schedules on the card; at 1,024
                   the card's records equal the CPU's

  kv-array         the key-value store's array rider (kv/store.py
                   kv_array_machine, no kernel of its own): a seeded
                   decided log of 4,096 records of 256 bytes over keyspace
                   4,096 folded on the card, the (seq, digest) tables equal
                   to the CPU fold's and the host KVState's; its first 64
                   records also decided by consensus on the card; records/s
                   and the fold's host syncs at 64 and 4,096 records (equal)
  kv-cluster       round_tpu's tests/test_kv.py fixtures on cuda:0: 1 and 2
                   shards of 3 replica threads, lin, lease and stale reads,
                   a single-shard txn, a cross-shard commit and a
                   conflicting prepare that aborts; the checker clean, the
                   decisions, read answers and every replica's store equal
                   to a CPU run's; a one-replica shard serving the same
                   writes with kv off and on: the same host copies and
                   update waves
  kv-bench         apps/kv.py run_kv_bench at round_tpu's CLI defaults (2
                   shard processes on cuda:0, n 3, lanes 16, 100 ops/s, 400
                   ops, 90% reads at lin/lease/stale 0.2/0.4/0.4, 64 keys at
                   Zipf 0.8): linearizable, every shed NACK-accounted, every
                   op completed; ops/s, decisions/s, write and per-grade
                   p50/p99, lease_vs_lin_p50, start-up s and peak GiB a
                   shard, and each shard's rounds: the share closed on a
                   deadline (or wait cap) and the rounds a decided instance
                   took on a replica
  kv-broken-lease  the same bench with --kv-broken-lease: the checker
                   catches it and apps/kv.py check replays the artifact to
                   the same verdict

  rtsat            the verifier's SAT core (round_tpu_torch/verify/
                   solver.py) built by g++ from round_tpu_torch/native/
                   sat.cpp into round_tpu_torch/_build/rtsat on this
                   machine; a known SAT and a known UNSAT formula, and a
                   DIMACS session, give their verdicts
  extract-card     the nine extracted builders of verify/protocols.py (ten
                   calls: Ben-Or for two receivers) traced on the card's
                   tensors and on the CPU's: the printed formulas and site
                   axioms are equal
  proof-suites     the port's verifier over round_tpu's tier-1 suites:
                   TPC's and OTR's hand suites (Verifier.check), the proved
                   non-slow sub-VCs of LastVoting's staged chain, and the
                   extracted-stage VCs of OTR, LastVoting, ε, TPC-event and
                   LastVoting-event (traced on the card), each verdict the
                   one round_tpu's tests assert; seconds per suite

  threshold-card   analysis/threshold.py's automata of otr, otr-hist and
                   lastvoting traced on the card and on the CPU: to_dict()
                   equal; seconds of each
  param-suites     apps/verifier_cli --suites param-otr,param-lv --jobs
                   <cores - 1> --json --cache <dir>, cold and then warm: 19
                   and 32 VCs, every one PROVED, the warm run all cache
                   hits; seconds of each run
  license          rv/license.py's default prover (verifier_cli on the
                   card), solving cold and then cache-only: otr at n=4, lv
                   at 5 and lvb at 9 licensed, otr at 3 outside its
                   envelope, benor unlicensed; then apps/fleet.py
                   run_autoscale_bench on the card with the default
                   registry, at round_tpu's defaults but for two cuts the
                   time limit forces (the 3x point of four, 2.5 s): a
                   licensed grow, no point meeting the SLO by shedding
  lint             apps/lint --all --json traced on the card: no gating
                   finding and the findings of the CPU's sweep (a process
                   of its own, run beside the phases above); --runtime: no gating
                   finding; the model, threshold and runtime fixtures fire
                   every family of analysis.FAMILIES

With ``--only sharded`` the script builds the kernels and runs the K4 and
sharded phases alone; with ``--only peers`` just K4-vs-plain and ring-peers
(for a machine with several cards); with ``--only fuzz`` the five fuzz
phases; with ``--only runtime`` the three runtime phases; with ``--only
host`` the four host phases; with ``--only serve`` the five lane and
fleet phases; with ``--only verify`` the eight verification phases; with
``--only kv`` the four key-value phases; with ``--only proof`` the three
verifier phases; with ``--only analysis`` the four analysis phases; the
timed ones with the card's
name and power limit.  The fuzz and
runtime phases print one JSON line each, with a "phase" key; an ``--only``
run prints {"only": ...} before the card's line.

Then the card's name and power limit as nvidia-smi reports them, a
{"kernels": [...]} line (per kernel: launches on its path — K2's rows
also kset_launches, the launches of families-wide's KSet run —, max_abs_err
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

import contextlib
import ctypes
import io
import json
import math
import re
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# flagship shape (README / bench defaults)
N, S_FLAG, ROUNDS, V, P_DROP = 1024, 10_000, 50, 16, 0.25
S_PLAIN_HW = 512         # scenarios of the flagship K1-hw plain comparison
S_PLAIN_HASH = 2_048     # and of the flagship K1 (hash) plain comparison
S_FUSED = 1_000          # run_hist (K2, one launch per round)
S_CHECK = 64             # kernel-vs-plain comparisons
# K1 and K2 against their plain versions: the flagship width, an n that is
# not a multiple of 16 (a receiver row starts inside a Philox call) and one
# that is not a multiple of 64 (a padded sender block)
CHECK_SHAPES = ((N, S_CHECK), (1000, 7), (1008, 7))
PARITY_K, PARITY_ROUNDS = 8, 10
SEED = 0
P8_GRID = (0, 1, 13, 64, 128, 255, 256)
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")
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


class Clock:
    """Seconds each section of the full run took, said as it ends, and the
    run's total so far: the script must end well inside its time limit."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, section: str) -> None:
        now = time.perf_counter()
        say("clock", section=section, s=round(now - self.last, 1),
            total_s=round(now - self.start, 1))
        self.last = now


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


def k2_second_pass(torch, mode: str) -> float:
    """K2 past 16 values, where its value loop takes a second pass
    (csrc/hist_exchange.cu): V = 32 (KSet's doubled domain) and V = 24 (a
    half-full second pass) at every check shape, with and without rowmask
    and side, in `mode`, against the plain version; at n = N also the
    public wrapper on the card against the CPU.  Payloads reach past
    [0, V) on both sides.  Returns the max abs error (0, or it fails)."""
    from round_tpu_torch.engine import fast
    from round_tpu_torch.ops import fused

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    err = 0.0
    for n, S in CHECK_SHAPES:
        for nv in (24, 32):
            vals = torch.randint(-1, nv + 2, (S, n), generator=gen,
                                 device=dev, dtype=torch.int32)
            active = torch.rand((S, n), generator=gen, device=dev) < 0.9
            colmask = torch.rand((S, n), generator=gen, device=dev) < 0.8
            rowmask = torch.rand((S, n), generator=gen, device=dev) < 0.9
            side = torch.randint(0, 2, (S, n), generator=gen, device=dev,
                                 dtype=torch.int32)
            s0 = fast._salts(gen, S, 0, dev)
            s1 = fast._salts(gen, S, 1, dev)
            p8 = torch.tensor(P8_GRID, dtype=torch.int32, device=dev).repeat(
                S // len(P8_GRID) + 1)[:S]
            senders = colmask & active & (p8 < 256)[:, None]
            for rm in (None, rowmask):
                for sd in (None, side):
                    err = max(err, compare(
                        f"K2 ({mode}) V={nv} vs its plain version (n={n}, "
                        f"rowmask={rm is not None}, side={sd is not None})",
                        [fused._hist_exchange_cuda(vals, senders, rm, sd, s0,
                                                   s1, p8, nv, mode)],
                        [fused._hist_exchange_plain(vals, senders, rm, sd,
                                                    s0, s1, p8, nv, mode)]))
            if n == N:
                cut = slice(0, 14)  # every p8 of the grid twice
                wargs = (vals[cut], active[cut], colmask[cut], rowmask[cut],
                         side[cut], s0[cut], s1[cut], p8[cut], nv)
                err = max(err, compare(
                    f"hist_exchange ({mode}) V={nv} on the card vs the CPU",
                    [fused.hist_exchange(*wargs, mode=mode).cpu()],
                    [fused.hist_exchange(*_on_cpu(wargs), mode=mode)]))
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


def eps_breakdown(torch, dev, wall_s_per_run: float, rounds: int) -> None:
    """[eps-breakdown]: the ε rung's round split into its steps at the
    rung's shape (n=1024, S=32, f=100), each timed alone by CUDA events
    over 8 calls: one round's 32 byzantine-silence masks (the host loop
    over scenarios), the two count products, one order statistic, and the
    trimmed mean's tree sum; beside the rung's wall time a round."""
    from round_tpu_torch.apps import ladder
    from round_tpu_torch.engine import epsfast, scenarios
    from round_tpu_torch.ops.detsum import tree_sum

    n, S, f = 1024, 32, 100
    keys = [tuple(k) for k in ladder._eps_keys(0, S).tolist()]
    sampler = scenarios.byzantine_silence(n, f, device=dev)
    x = torch.stack([ladder._eps_init(k, n, dev) for k in keys])
    masks_ms, ho = event_ms(
        lambda: torch.stack([sampler(k, 0) for k in keys]), reps=8)
    hmask = torch.zeros_like(ho)
    hvals = torch.zeros_like(x)
    count_ms, (V, C) = event_ms(
        lambda: epsfast._count_ranks(ho, hmask, x, hvals), reps=8)
    members = torch.cat([ho, hmask], dim=2)
    rank_ms, _ = event_ms(lambda: epsfast._rank_val(V, members, C, 3 * f),
                          reps=8)
    sel = torch.rand((S, n, 2 * n), device=dev)
    tree_ms, _ = event_ms(lambda: tree_sum(sel, dim=-1), reps=8)
    say("eps-breakdown", round_ms=round(wall_s_per_run * 1e3 / rounds, 3),
        masks_ms=round(masks_ms, 3), count_products_ms=round(count_ms, 3),
        rank_val_ms=round(rank_ms, 3), tree_sum_ms=round(tree_ms, 3))


def event_models(torch, dev) -> None:
    """[event-models]: the event-round and LastVoting-variant models on the
    general engine on the card, each held bit for bit against the same run
    on the CPU (random lossy schedules, a fixed seed)."""
    from round_tpu_torch.engine import scenarios
    from round_tpu_torch.engine.executor import run_instance
    from round_tpu_torch.models.common import consensus_io
    from round_tpu_torch.models.lastvoting import LastVotingBytes
    from round_tpu_torch.models.lastvoting_event import LastVotingEvent
    from round_tpu_torch.models.lastvoting_variants import (
        MultiLastVoting, ShortLastVoting, mlv_io,
    )
    from round_tpu_torch.models.tpc import tpc_io
    from round_tpu_torch.models.tpc_event import TwoPhaseCommitEvent
    from round_tpu_torch.utils.tree import tree_leaves, tree_map

    n = 16
    gen = torch.Generator().manual_seed(SEED)

    def schedule(T, p):
        ho = torch.rand((T, n, n), generator=gen) < p
        return ho | torch.eye(n, dtype=torch.bool)

    init = torch.randint(0, 50, (n,), generator=gen, dtype=torch.int32)
    votes = torch.rand((n,), generator=gen) < 0.9
    payload = torch.randint(0, 256, (n, 8), generator=gen,
                            dtype=torch.uint8)
    cases = [
        ("LastVotingEvent", LastVotingEvent(), consensus_io(init), 6, 4),
        ("TwoPhaseCommitEvent", TwoPhaseCommitEvent(), tpc_io(0, votes), 1, 3),
        ("TwoPhaseCommitEvent-blocking",
         TwoPhaseCommitEvent(blocking=True, all_votes=True),
         tpc_io(0, votes), 1, 3),
        ("ShortLastVoting", ShortLastVoting(), consensus_io(init), 6, 3),
        ("MultiLastVoting", MultiLastVoting(),
         mlv_io(n, {3: 17, 9: 4}, {0: 9, 5: 3}), 12, 3),
        ("LastVotingBytes", LastVotingBytes(8), consensus_io(payload), 6, 4),
    ]
    decided = {}
    t0 = time.perf_counter()
    for name, algo, io_, phases, k in cases:
        ho = schedule(phases * k, 0.85)
        runs = []
        for d in (dev, torch.device("cpu")):
            res = run_instance(algo, tree_map(lambda t: t.to(d), io_), n,
                               (7, SEED), scenarios.from_schedule(ho.to(d)),
                               phases, device=d)
            runs.append([t.cpu() for t in tree_leaves(res.state)]
                        + [res.done.cpu(), res.decided_round.cpu()])
        equal = all(a.dtype == b.dtype and torch.equal(a, b)
                    for a, b in zip(*runs))
        require(equal and len(runs[0]) == len(runs[1]),
                f"{name} on the card differs from the CPU")
        decided[name] = int(runs[0][-2].sum())
    say("event-models", n=n, models=len(cases), tolerance=0, equal=True,
        done_lanes=json.dumps(decided).replace(" ", ""),
        wall_s=round(time.perf_counter() - t0, 1))
    require(all(v > 0 for v in decided.values()),
            f"an event-model run finished no lane: {decided}")


# families-wide: (n, S) of each engine; n is a square (Game of Life's torus)
FAMILY_SHAPES = {"kset": (N, S_FLAG), "esfd": (N, 256), "theta": (N, 256),
                 "pbft": (100, 10_000), "pbft-vc": (100, 1_000),
                 "mutex": (N, 1_000), "gol": (N, 1_000),
                 "ho-stats": (N, 1_000)}


def families_wide(torch, dev, shapes=FAMILY_SHAPES) -> dict:
    """[families-wide]: the engines of the last histogram slice, each
    through its public entry point on the card at its users' widths (groups
    of 1,024 processes; PBFT groups of n = 3f+1 replicas), each held two
    ways: bit for bit against the same call on CPU copies of its first 8
    scenario rows (the engines are scenario-independent), and field by
    field against a hash replay of 2 of its scenarios through the general
    engine (engine.executor.run_instance over scenarios.from_mix_row, the
    algorithm from apps.selector.select where the selector names it).

      kset      run_hist(KSetESHist(n_values=16, t=64, k=4)) at n=1024 x
                10,000 x 18 rounds through K2 at V=32: the four-family mix
                in hw (timed, K2-hw launches = rounds), then a crash-only
                mix (64 crashes a scenario) in hash (K2 launches = rounds;
                at most k decisions among live lanes, every lane decided)
      esfd      run_esfd_fast, n=1024 x 256 x 12, h=3, four-family mix
      theta     run_theta_fast, n=1024 x 256 x 20, f=n/4, theta 2.0 and 0.5
      pbft      run_pbft_fast, n=100 x 10,000 x 3
      pbft-vc   run_pbft_vc_fast, n=100 x 1,000 x 12, row 0 the
                primary-crash witness (lane 0 crashed at round 0 on clean
                links): a lane decides in a view > 0
      mutex     run_mutex_fast, n=1024 x 1,000 x 20
      gol       run_gol_fast, a 32 x 32 torus x 1,000 x 20 from a glider;
                on a clean torus the glider moves by (1, 1) in 4 rounds
      ho-stats  mix_ho_stats of the four-family mix, n=1024 x 1,000 x 20

    The last three run 20 rounds, not the flagship's 50: at 50 each of
    their runs took ~6 s on the H100, and each runs twice besides its CPU
    and replay checks, which the script's time limit cannot spare.

    Each engine's check run comes first; a second run, which must repeat
    it bit for bit, is timed with CUDA events (ms, rounds/sec = rounds /
    seconds of a run, peak GiB allocated during it) and its launches
    counted from 0 just before it.  Returns the K2 launch counts of the
    kset runs."""
    from round_tpu_torch.apps.selector import select
    from round_tpu_torch.engine import fast, scenarios
    from round_tpu_torch.engine.executor import run_instance
    from round_tpu_torch.models import (
        failure_detector, gameoflife, kset, mutex, pbft, theta,
    )
    from round_tpu_torch.models.common import consensus_io
    from round_tpu_torch.ops import fused
    from round_tpu_torch.utils.tree import tree_map

    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    K, REPLAY = 8, (0, 1)
    fields = {
        "kset": ("est", "can_decide", "last_nb", "decided", "decision"),
        "esfd": ("last_seen",), "theta": ("round", "next_round_at", "heard"),
        "pbft": ("x", "dig", "valid", "prepared", "decided", "decision"),
        "pbft-vc": ("x", "dig", "valid", "prepared", "decided", "decision",
                    "view", "next_view", "vc_active", "prep_req",
                    "prep_view", "vc_heard", "vc_req", "vc_pv", "sel_req",
                    "nv_ok"),
        "mutex": ("x", "has_token"), "gol": ("alive",),
    }
    summary = {}

    def rows_of(tree, rows, device):
        return tree_map(lambda t: t[rows].to(device), tree)

    def sub_mix(mix, rows, device=None):
        return fast.FaultMix(**{k: getattr(mix, k)[rows].to(
            device or mix.crashed.device) for k in MIX_FIELDS})

    def flat(family, out):
        return [getattr(out[0], f) for f in fields[family]] + list(out[1:])

    def timed(run):
        """(output, ms, peak GiB) of one run timed by CUDA events."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run()
        end.record()
        end.synchronize()
        return (out, start.elapsed_time(end),
                torch.cuda.max_memory_allocated() / 2**30)

    def held(family, run, state0, mix, rounds, algo=None, io=None,
             replay_rounds=None, rounds_per_phase=1):
        """The check run, the CPU copies of its first K rows and a hash
        replay of REPLAY rows through the general engine, then the timed
        run, its launches counted from 0 just before it (the check run
        has grown the allocator's pool to the run's size)."""
        out = run(state0, mix, rounds)
        want = run(rows_of(state0, slice(0, K), cpu),
                   sub_mix(mix, slice(0, K), cpu), rounds)
        compare(f"{family} on the card vs the CPU (first {K} rows)",
                [t[:K].cpu() for t in flat(family, out)], flat(family, want))
        if algo is not None:
            rr = replay_rounds or rounds
            rows = list(REPLAY)
            if rr != rounds:
                ref = run(rows_of(state0, rows, dev), sub_mix(mix, rows),
                          rr)
            else:
                ref = tuple(tree_map(lambda t: t[rows], o) for o in out)
            for i, s in enumerate(rows):
                res = run_instance(algo, io if io is not None else {},
                                   mix.n, (s, SEED),
                                   scenarios.from_mix_row(mix, s),
                                   rr // rounds_per_phase, device=dev)
                compare(f"{family} row {s} against the general engine",
                        [getattr(ref[0], f)[i] for f in fields[family]]
                        + [ref[2][i]],
                        [getattr(res.state, f) for f in fields[family]]
                        + [res.decided_round])
        fused.reset_launches()
        again, ms, peak = timed(lambda: run(state0, mix, rounds))
        launches = {k: v for k, v in fused.LAUNCHES.items() if v}
        compare(f"{family}: the timed run repeats the check run",
                flat(family, again), flat(family, out))
        del again
        return out, ms, peak, launches

    def report(name, n, S, rounds, ms, peak, launches, replay="2x_all",
               **extra):
        rps = rounds / (ms / 1e3)
        summary[name] = {"ms": round(ms, 3), "rounds_per_sec": round(rps, 3),
                         "peak_gib": round(peak, 3)}
        say("families-wide", engine=name, n=n, S=S, rounds=rounds,
            ms=round(ms, 3), rounds_per_sec=round(rps, 3),
            peak_gib=round(peak, 3), card_equals_cpu=True, replay=replay,
            launches=json.dumps(launches).replace(" ", ""), **extra)

    # -- kset: K2 at V = 32, hw on the four-family mix, hash crash-only --
    (n, S), t, k, nv = shapes["kset"], 64, 4, 16
    rounds = t // k + 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rnd = fast.KSetESHist(n_values=nv, t=t, k=k)
    init = torch.randint(0, nv, (n,), generator=gen, dtype=torch.int32,
                         device=dev)
    st0 = kset.KSetESState.fresh(init, S, n)
    kset_launches = {}

    def kset_run(mode):
        def run(state0, mix_, r):
            return fast.run_hist(rnd, state0, lambda s_: s_.decided, mix_, r,
                                 mode=mode)
        return run

    mix = fast.standard_mix(gen, S, n, p_drop=P_DROP, device=dev)
    # hw links have no replay: the hash run below carries kset's
    out, ms, peak, launches = held("kset", kset_run("hw"), st0, mix, rounds)
    kset_launches["hist_exchange_hw"] = launches.get("hist_exchange_hw", 0)
    require(launches == {"hist_exchange_hw": rounds},
            f"kset (hw) launched {launches} in {rounds} rounds")
    report("kset", n, S, rounds, ms, peak, launches,
           replay="none:hw_links_have_no_replay(see_kset-crash)", mode="hw",
           mix="standard", V=2 * nv,
           K2_hw_launches=kset_launches["hist_exchange_hw"],
           frac_lanes_decided=round(float(out[0].decided.float().mean()), 4))
    del out, mix

    z = torch.zeros(S, dtype=torch.int32, device=dev)
    crash_mix = fast.fault_free(gen, S, n, device=dev).replace(
        crashed=torch.argsort(torch.rand((S, n), generator=gen, device=dev),
                              dim=1) < t, crash_round=z)
    out, ms, peak, launches = held(
        "kset", kset_run("hash"), st0, crash_mix, rounds,
        kset.KSetEarlyStopping(t=t, k=k), consensus_io(init))
    kset_launches["hist_exchange"] = launches.get("hist_exchange", 0)
    require(launches == {"hist_exchange": rounds},
            f"kset (hash) launched {launches} in {rounds} rounds")
    st = out[0]
    live = ~crash_mix.crashed
    seen = torch.zeros((S, nv), dtype=torch.int32, device=dev)
    seen.scatter_add_(1, torch.where(live, st.decision, 0).long(),
                      live.to(torch.int32))
    distinct = int((seen > 0).sum(1).max())
    require(bool(st.decided.all()), "kset (crash-only): a lane never decided")
    require(distinct <= k, f"kset (crash-only): {distinct} decisions > k")
    report("kset-crash", n, S, rounds, ms, peak, launches,
           replay="rows_0,1:KSetEarlyStopping", mode="hash",
           mix=f"crash-only,{t}_a_scenario", V=2 * nv,
           K2_launches=kset_launches["hist_exchange"],
           max_distinct_decisions=distinct, k=k, every_lane_decided=True)
    del out, st, crash_mix

    # -- esfd and theta: [S, n, n] state -----------------------------------
    (n, S), h = shapes["esfd"], 3
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    mix = fast.standard_mix(gen, S, n, p_drop=P_DROP, device=dev)
    st0 = failure_detector.EsfdState(
        last_seen=torch.zeros((S, n, n), dtype=torch.int32, device=dev))
    out, ms, peak, launches = held(
        "esfd", lambda s0, m, r: fast.run_esfd_fast(s0, m, r, hysteresis=h),
        st0, mix, 12, failure_detector.Esfd(hysteresis=h))
    sus = out[0].last_seen > h
    crashed = mix.crashed
    det = (sus | ~crashed[:, None, :] | crashed[:, :, None]).flatten(1).all(1)
    require(bool(det[crashed.any(dim=1)].all()),
            "esfd: a live lane does not suspect a crashed process")
    report("esfd", n, S, 12, ms, peak, launches, replay="rows_0,1:Esfd",
           h=h, mix="standard",
           last_seen_gib=round(S * n * n * 4 / 2**30, 3))
    del out, st0, sus

    require(shapes["theta"] == shapes["esfd"], "theta reuses esfd's mix")
    for th in (2.0, 0.5):
        f = n // 4
        st0 = theta.ThetaState.fresh(th, S, n, device=dev)
        out, ms, peak, launches = held(
            "theta",
            lambda s0, m, r, th=th, f=f: fast.run_theta_fast(s0, m, r, f, th),
            st0, mix, 20, theta.ThetaModel(f=f, theta=th))
        require(int(out[0].round.max()) >= 1,
                f"theta {th}: no logical round advanced")
        report(f"theta-{th}", n, S, 20, ms, peak, launches,
               replay="rows_0,1:ThetaModel", f=f, mix="standard",
               max_logical_round=int(out[0].round.max()))
        del out, st0
    # the schedule on the card against the CPU (tests hold the CPU against
    # round_tpu): every logical round up to 10^5
    r = torch.arange(0, 100_001, dtype=torch.int32)
    for th in (0.5, 1.1, 1.5, 2.0, 2.7):
        compare(f"theta _next_round_at({th}) on the card vs the CPU",
                [theta._next_round_at(th, r.to(dev)).cpu()],
                [theta._next_round_at(th, r)])
    del mix

    # -- pbft, pbft-vc: groups of n = 3f + 1 = 100 replicas ----------------
    n, S = shapes["pbft"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    x0 = torch.randint(0, 1000, (n,), generator=gen, dtype=torch.int32,
                       device=dev)
    mix = fast.standard_mix(gen, S, n, p_drop=P_DROP, device=dev)
    out, ms, peak, launches = held(
        "pbft", lambda s0, m, r: fast.run_pbft_fast(s0, m, r),
        pbft.BcpState.fresh(x0, S, n), mix, 3, select("pbft"),
        consensus_io(x0), rounds_per_phase=3)
    d = torch.where(~mix.crashed & (out[0].decision >= 0), out[0].decision,
                    -1)
    agree = bool(((d < 0) | (d == d.max(dim=1, keepdim=True).values)).all())
    require(agree, "pbft: two live lanes decided different requests")
    report("pbft", n, S, 3, ms, peak, launches,
           replay="rows_0,1:select(pbft)", mix="standard",
           committed_scenarios=int((d >= 0).any(dim=1).sum()))
    del out, mix, d

    S = shapes["pbft-vc"][1]
    require(shapes["pbft-vc"][0] == n, "pbft-vc reuses pbft's requests")
    mix = fast.standard_mix(gen, S, n, p_drop=P_DROP, device=dev)
    w = torch.arange(S, device=dev) == 0
    crashed = mix.crashed & ~w[:, None]
    crashed[0, 0] = True
    mix = mix.replace(
        crashed=crashed,
        crash_round=torch.where(w, 0, mix.crash_round).to(torch.int32),
        p8=torch.where(w, 0, mix.p8).to(torch.int32),
        heal_round=torch.where(w, 0, mix.heal_round).to(torch.int32))
    out, ms, peak, launches = held(
        "pbft-vc", lambda s0, m, r: fast.run_pbft_vc_fast(s0, m, r),
        pbft.PbftVcState.fresh(x0, S, n), mix, 12, select("pbft-vc"),
        consensus_io(x0), rounds_per_phase=6)
    st = out[0]
    d = torch.where(~mix.crashed & (st.decision >= 0), st.decision, -1)
    agree = bool(((d < 0) | (d == d.max(dim=1, keepdim=True).values)).all())
    rotated = bool(((st.decision[0] >= 0) & (st.view[0] > 0)).any())
    require(agree, "pbft-vc: two live lanes decided different requests")
    require(rotated, "pbft-vc: the witness row decided in no view > 0")
    report("pbft-vc", n, S, 12, ms, peak, launches,
           replay="rows_0,1:select(pbft-vc)", mix="standard + witness row 0",
           decided_through_view_change=True,
           frac_lanes_decided=round(float(st.decided.float().mean()), 4))
    del out, st, mix, d

    # -- mutex and Game of Life at n = 1024 --------------------------------
    (n, S), rounds = shapes["mutex"], 20
    require(shapes["gol"] == shapes["ho-stats"] == (n, S),
            "mutex, gol and ho-stats share one mix")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    mix = fast.standard_mix(gen, S, n, p_drop=P_DROP, device=dev)
    xm = torch.randint(0, n + 1, (n,), generator=gen, dtype=torch.int32,
                       device=dev)
    # the general engine's EventRound folds the n senders one by one
    # (~0.2 s a round at n=1024): its replay runs the reference test's 12
    # rounds, against the fast engine re-run on the replayed rows
    out, ms, peak, launches = held(
        "mutex", lambda s0, m, r: fast.run_mutex_fast(s0, m, r),
        mutex.MutexState.fresh(xm, S, n), mix, rounds,
        mutex.SelfStabilizingMutualExclusion(), mutex.mutex_io(xm),
        replay_rounds=12)
    report("mutex", n, S, rounds, ms, peak, launches,
           replay="rows_0,1_x12_rounds:SelfStabilizingMutualExclusion",
           mix="standard",
           reduced="replay_12_rounds:EventRound_folds_n_senders_serially",
           tokens_mean=round(float(out[0].has_token.sum(1).float().mean()),
                             3))
    del out

    side = math.isqrt(n)
    require(side * side == n, f"gol wants a square n, not {n}")
    nb = gameoflife.torus_neighbours(side, side)
    grid = torch.zeros((side, side), dtype=torch.bool)
    for r_, c_ in ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2)):  # glider
        grid[r_, c_] = True
    io = gameoflife.cgol_io(grid, device=dev)
    st0 = gameoflife.CgolState(alive=io["alive"].expand(S, n).contiguous())
    out, ms, peak, launches = held(
        "gol", lambda s0, m, r: fast.run_gol_fast(s0, m, nb, r),
        st0, mix, rounds, gameoflife.ConwayGameOfLife(side, side), io)
    clean = fast.fault_free(gen, 1, n, device=dev)
    moved = fast.run_gol_fast(gameoflife.CgolState(alive=io["alive"][None]),
                              clean, nb, 4)[0].alive[0].reshape(side, side)
    require(torch.equal(moved.cpu(), torch.roll(grid, (1, 1), (0, 1))),
            "gol: the glider did not move by (1, 1) in 4 rounds")
    report("gol", n, S, rounds, ms, peak, launches,
           replay="rows_0,1:ConwayGameOfLife", torus=f"{side}x{side}",
           mix="standard",
           glider_moves=True,
           alive_mean=round(float(out[0].alive.sum(1).float().mean()), 3))
    del out, st0

    # -- the HO statistics of the four-family mix ----------------------------
    got = fast.mix_ho_stats(sub_mix(mix, slice(0, K)), rounds)
    want = fast.mix_ho_stats(sub_mix(mix, slice(0, K), cpu), rounds)
    for key in ("density", "heard_mean", "heard_min"):
        require(got[key].tobytes() == want[key].tobytes(),
                f"ho-stats {key} on the card differs from the CPU")
    fast.mix_ho_stats(mix, 2)  # the pool grown to a round's mask
    stats, ms, peak = timed(lambda: fast.mix_ho_stats(mix, rounds))
    require(bool((stats["density"] > 0).all() and (stats["density"] <= 1).all()
                 and (stats["heard_min"] >= 1).all()),
            "ho-stats: a density outside (0, 1] or an empty mailbox")
    report("ho-stats", n, S, rounds, ms, peak, {},
           replay="none:card_vs_cpu_on_the_first_8_rows", mix="standard",
           density_mean=round(float(stats["density"].mean()), 6),
           heard_min_min=int(stats["heard_min"].min()))
    say("families-wide", engines=len(summary), all_equal=True,
        wall_s=round(time.perf_counter() - t_phase, 1),
        per_engine=json.dumps(summary, separators=(",", ":")))
    return kset_launches


# the fuzzer's phases: the documented search shape (docs/FUZZING.md, the
# fuzz CLI's defaults), the cross-check's in-envelope sweep shape, the
# known-bad genome of the tier-1 smoke, and the population ladder
FUZZ_N, FUZZ_H, FUZZ_POP, FUZZ_GENS = 4, 12, 1024, 30
FUZZ_VALUE_POP, FUZZ_VALUE_GENS = 512, 10
FUZZ_POPS = (1024, 4096, 16384)
FUZZ_FIELDS = ("decided", "decision", "decided_round", "decide_round",
               "agreement_viol", "validity_viol", "coverage", "undecided",
               "score")


def say_json(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def same_outcome(what, got, want, keys) -> None:
    """Every field bit for bit (floats in raw bits)."""
    import numpy as np

    for k in keys:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        require(a.dtype == b.dtype and a.shape == b.shape,
                f"{what}: {k} is {a.dtype}{a.shape}, want {b.dtype}{b.shape}")
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        require(bool((a == b).all()), f"{what}: {k} differs from the CPU's")


@contextlib.contextmanager
def round_steps():
    """Count executor.run_round calls (one a round for the whole
    population when the evaluation is batched)."""
    from round_tpu_torch.engine import executor

    count = [0]
    inner = executor.run_round

    def counting(*a, **kw):
        count[0] += 1
        return inner(*a, **kw)

    executor.run_round = counting
    try:
        yield count
    finally:
        executor.run_round = inner


def device_syncs(torch, fn):
    """(result, host-device synchronisations fn made), counted by torch's
    sync debug mode (each cudaStreamSynchronize or blocking copy warns)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in seen)


# the CUDA runtime's launch calls, as torch.profiler records them on the host
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def traced_launches(torch, fn):
    """(launch calls, kernels, copies) of fn: the host's kernel-launch calls
    and the device's kernel and memcpy/memset records, from one
    torch.profiler trace.  The launch calls are the exact count; the
    device's records can miss a few kernels of a long trace (a LastVoting
    runtime window read 23,493-23,495 kernels against 23,499 calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = kernels = copies = 0
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            calls += evt.name in LAUNCH_CALLS
        elif "memcpy" in evt.name.lower() or "memset" in evt.name.lower():
            copies += 1
        else:
            kernels += 1
    return calls, kernels, copies


def fuzz_phases(torch, dev) -> dict:
    """The fault-schedule fuzzer (round_tpu_torch/fuzz) on the card: one
    batched evaluation per generation, held against the same work on the
    CPU.  Returns the numbers the summary line carries."""
    import numpy as np

    from round_tpu_torch.fuzz import genome, minimize, objectives
    from round_tpu_torch.fuzz.search import make_target, search
    from round_tpu_torch.obs.metrics import METRICS

    cpu = torch.device("cpu")
    gib = 2.0 ** 30
    out = {}

    # -- fuzz-eval: one evaluation on the card against the CPU ---------------
    t_dev = make_target("otr", FUZZ_N, FUZZ_H, seed=0, device=dev)
    t_cpu = make_target("otr", FUZZ_N, FUZZ_H, seed=0, device=cpu)
    pop = genome.seed_population(0, FUZZ_POP, FUZZ_N, FUZZ_H)
    with round_steps() as steps:
        got = t_dev.evaluate(pop)
    ms, _ = event_ms(lambda: t_dev.evaluate(pop))   # warm, then timed
    want = t_cpu.evaluate(pop)
    same_outcome("fuzz-eval", got, want, FUZZ_FIELDS)
    require(steps[0] == t_dev.horizon,
            f"fuzz-eval: {steps[0]} run_round steps, horizon {t_dev.horizon}")
    say_json("fuzz-eval", protocol="otr", n=FUZZ_N, horizon=t_dev.horizon,
             P=FUZZ_POP, fields_bit_equal=list(FUZZ_FIELDS),
             score_tolerance=0, ms=round(ms, 3),
             run_round_steps=steps[0],
             decided_frac=float(got["decided"].mean()))
    out["eval_ms"] = ms

    # -- fuzz-search: the documented CLI shape, run to the end ---------------
    spent = [0.0]
    inner_eval = t_dev.evaluate

    def timed_eval(p):
        t0 = time.perf_counter()
        try:
            return inner_eval(p)
        finally:
            spent[0] += time.perf_counter() - t0

    t_dev.evaluate = timed_eval
    d0 = METRICS.counter("fuzz.dispatches").value
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = search(t_dev, pop_size=FUZZ_POP, generations=FUZZ_GENS, seed=0)
    peak = (torch.cuda.max_memory_allocated() - base) / gib
    del t_dev.evaluate
    dispatches = METRICS.counter("fuzz.dispatches").value - d0
    require(dispatches == FUZZ_GENS and res.generations == FUZZ_GENS,
            f"fuzz-search: {dispatches} evaluations in {res.generations} "
            f"generations, want {FUZZ_GENS}")
    require(bool(np.isfinite(res.best_score)), "fuzz-search: best score")
    say_json("fuzz-search", protocol="otr", n=FUZZ_N, horizon=FUZZ_H,
             pop=FUZZ_POP, generations=res.generations, seed=0,
             dispatches=dispatches, evaluated=res.evaluated,
             schedules_per_sec=res.schedules_per_sec, wall_s=res.wall_s,
             evaluate_share=spent[0] / res.wall_s,
             operators_share=1.0 - spent[0] / res.wall_s, peak_gib=peak,
             best_score=res.best_score,
             coverage_cells=int(res.coverage_map.sum()),
             n_cells=t_dev.n_cells)
    out["search_schedules_per_sec"] = res.schedules_per_sec

    # -- fuzz-value: the in-envelope value sweeps ------------------------------
    cap = genome.value_cap_default(FUZZ_N)
    for proto in ("pbft", "pbft-vc"):
        tv = make_target(proto, FUZZ_N, FUZZ_H, seed=0, device=dev)
        tc = make_target(proto, FUZZ_N, FUZZ_H, seed=0, device=cpu)
        gens = []
        inner_v = tv.evaluate

        def record(p, inner_v=inner_v, gens=gens):
            o = inner_v(p)
            gens.append((p, o))
            return o

        tv.evaluate = record
        res = search(tv, pop_size=FUZZ_VALUE_POP,
                     generations=FUZZ_VALUE_GENS, seed=0, value_cap=cap)
        viol = [int(((o["agreement_viol"] + o["validity_viol"]) > 0).sum())
                for _, o in gens]
        liars = [int((p.byz_value.any(axis=1) & (p.equiv_p8 > 0)).sum())
                 for p, _ in gens]
        require(len(gens) == FUZZ_VALUE_GENS,
                f"fuzz-value {proto}: {len(gens)} generations")
        require(not any(viol),
                f"fuzz-value {proto}: honest safety violations {viol}")
        require(liars[-1] > 0, f"fuzz-value {proto}: no liar was evolved")
        same_outcome(f"fuzz-value {proto}", gens[0][1],
                     tc.evaluate(gens[0][0]), FUZZ_FIELDS)
        say_json("fuzz-value", protocol=proto, n=FUZZ_N,
                 horizon=tv.horizon, pop=FUZZ_VALUE_POP,
                 generations=res.generations, value_cap=cap,
                 evaluated=res.evaluated, violations_per_gen=viol,
                 active_liars_per_gen=liars, first_gen_equal_cpu=True,
                 schedules_per_sec=res.schedules_per_sec,
                 best_score=res.best_score)

    # -- fuzz-minimize: the known-bad genome of the tier-1 smoke ---------------
    bad = {"crashed": np.zeros(4, bool), "crash_round": np.int32(0),
           "side": np.array([0, 0, 1, 1], np.int32),
           "heal_round": np.int32(8), "rotate_down": np.int32(0),
           "p8": np.int32(128), "salt0": np.int32(77),
           "salt1": np.int32(88), "byz": np.zeros(4, bool)}
    pred = objectives.undecided_at_horizon(4)
    t0 = time.perf_counter()
    mr = minimize.minimize(make_target("otr", 4, 8, seed=0, device=dev),
                           bad, pred)
    wall = time.perf_counter() - t0
    mc = minimize.minimize(make_target("otr", 4, 8, seed=0, device=cpu),
                           bad, pred)
    require((mr.dropped_initial, mr.dropped_final, mr.iterations)
            == (mc.dropped_initial, mc.dropped_final, mc.iterations),
            "fuzz-minimize: the counts differ from the CPU's")
    require(bool((mr.schedule == mc.schedule).all()),
            "fuzz-minimize: the minimal schedule differs from the CPU's")
    for f in mc.genome_row:
        require(bool((np.asarray(mr.genome_row[f])
                      == np.asarray(mc.genome_row[f])).all()),
                f"fuzz-minimize: genome_row[{f}] differs from the CPU's")
    require(mr.dropped_final < mr.dropped_initial,
            "fuzz-minimize: nothing was shrunk")
    say_json("fuzz-minimize", protocol="otr", n=4, horizon=8,
             predicate=pred.__name__, dropped_initial=mr.dropped_initial,
             dropped_final=mr.dropped_final, iterations=mr.iterations,
             equal_cpu=True, wall_s=wall)

    # -- fuzz-pop: the population ladder ---------------------------------------
    t_dev = make_target("otr", FUZZ_N, FUZZ_H, seed=0, device=dev)
    rows = []
    for P in FUZZ_POPS:
        pop = genome.seed_population(0, P, FUZZ_N, FUZZ_H)
        t_dev.evaluate(pop)                                # warm
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        t_dev.evaluate(pop)
        wall_ms = (time.perf_counter() - t0) * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / gib
        _, syncs = device_syncs(torch, lambda: t_dev.evaluate(pop))
        # the host's launch calls are the exact count; the device's kernel
        # records of a trace this long can miss a few (4,042 of 4,046)
        calls, kernels, copies = traced_launches(torch,
                                                 lambda: t_dev.evaluate(pop))
        row = {"P": P, "ms": wall_ms, "schedules_per_sec": P / wall_ms * 1e3,
               "peak_gib": peak, "launch_calls": calls, "kernels": kernels,
               "copies": copies, "syncs": syncs}
        rows.append(row)
        say_json("fuzz-pop", protocol="otr", n=FUZZ_N, horizon=FUZZ_H, **row)
    require(len({r["launch_calls"] for r in rows}) == 1,
            f"fuzz-pop: kernel launches grow with P: "
            f"{[r['launch_calls'] for r in rows]}")
    # staging in and the outcome out: a few syncs an evaluation, never one
    # a round
    require(max(r["syncs"] for r in rows) < FUZZ_H,
            f"fuzz-pop: host syncs {[r['syncs'] for r in rows]} reach the "
            f"{FUZZ_H} rounds of an evaluation")
    out["pop"] = rows
    return out


# the runtime phase: perftest's deployment (testOTR.sh and PerfTest2, n = 4,
# Options' default), a backlog of 4,096 instances in flight 16 at a time
# (the reference's processPool) and 1,024 (the largest lane bucket), under
# omission at perftest's p_drop 0.05 with Options' 64 phases.  At -rt 16
# the backlog is cut to its first 512 instances: every window is the same
# work, so the rate does not depend on the backlog, and LastVoting's 32
# windows take 24-27 s of the script's time on the H100 (45-77 s at 1,024
# instances, which the script's time limit cannot spare).  The CPU replays
# RT_CPU_CHECK instances of each run on the same keys.
RT_N, RT_RATES, RT_P_DROP, RT_PHASES = 4, (16, 1024), 0.05, 64
RT_BACKLOG = {16: 512, 1024: 4096}
RT_CPU_CHECK = {16: 256, 1024: 4096}
# SMR: LastVoting, batches of 64 commands, 4,096 commands (64 instances)
SMR_BATCH, SMR_COMMANDS = 64, 4096


def _log_rows(log):
    return [(i, *log.get(i)) for i in log.instances()]


def runtime_phases(torch, dev) -> None:
    """The in-process runtime (round_tpu_torch/runtime, no kernel of its
    own) on the card: perftest's windows at two rates, SMR with a
    checkpoint restore and a gap recovery, and a membership change, each
    held against the same work on the CPU."""
    import tempfile

    from round_tpu_torch.apps import perftest
    from round_tpu_torch.apps.dynamic_membership import MembershipManager
    from round_tpu_torch.apps.selector import select
    from round_tpu_torch.engine import scenarios
    from round_tpu_torch.models.common import consensus_io
    from round_tpu_torch.runtime import ReplicatedStateMachine
    from round_tpu_torch.runtime.config import Options
    from round_tpu_torch.runtime.decisions import DecisionLog
    from round_tpu_torch.runtime.instances import InstancePool, instance_key
    from round_tpu_torch.runtime.membership import Directory, local_group

    cpu = torch.device("cpu")
    gib = 2.0 ** 30

    # -- perftest-otr, perftest-lv --------------------------------------------
    for algo in ("otr", "lv"):
        kernels = {}
        for rt in RT_RATES:
            opts = Options(n=RT_N, rate=rt, max_phases=RT_PHASES,
                           algorithm=algo)
            log = DecisionLog()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            backlog = RT_BACKLOG[rt]
            out = perftest.run(opts, n_instances=backlog,
                               p_drop=RT_P_DROP, device=dev, log=log)
            peak = (torch.cuda.max_memory_allocated() - base) / gib
            # the CPU on the same keys: the first RT_CPU_CHECK instances
            # are whole windows, so their keys are the card run's
            check = RT_CPU_CHECK[rt]
            cpu_log = DecisionLog()
            perftest.run(opts, n_instances=check, p_drop=RT_P_DROP,
                         device=cpu, log=cpu_log)
            card_rows = [row for row in _log_rows(log) if row[0] < check]
            require(card_rows == _log_rows(cpu_log),
                    f"perftest-{algo} rt={rt}: the card's decisions differ "
                    f"from the CPU's")
            if check == backlog:
                require(log.digest() == cpu_log.digest(),
                        f"perftest-{algo} rt={rt}: digest differs")
            # windows as perftest runs them: the launches, kernels, copies
            # and host syncs of one warm window each
            pool = InstancePool(select(algo), RT_N,
                                scenarios.omission(RT_N, RT_P_DROP,
                                                   device=dev),
                                max_phases=RT_PHASES, window=rt, device=dev)
            io = consensus_io(torch.arange(RT_N, dtype=torch.int32) % 5)

            def window(step):
                for i in range(rt):
                    pool.submit(step * rt + i, io)
                return pool.run_pending(instance_key((0, 0), step))

            window(0)
            _, syncs = device_syncs(torch, lambda: window(1))
            calls, k, copies = traced_launches(torch, lambda: window(2))
            kernels[rt] = calls
            say_json(f"perftest-{algo}", n=RT_N, rt=rt,
                     instances=out["total"], decided=out["decided"],
                     total=out["total"], max_phases=RT_PHASES,
                     p_drop=RT_P_DROP, wall_s=out["wall_s"],
                     metric=f"perftest_{algo}_n{RT_N}_rt{rt}"
                            "_decisions_per_sec",
                     decisions_per_sec=out["decisions_per_s"],
                     windows=-(-backlog // rt),
                     ms_per_window=out["wall_s"] * 1e3 / -(-backlog // rt),
                     window_launches=calls, window_kernels=k,
                     window_copies=copies, window_syncs=syncs,
                     peak_gib=peak,
                     cpu_checked_instances=check, cpu_equal=True,
                     digest=log.digest())
        require(len(set(kernels.values())) == 1,
                f"perftest-{algo}: launches per window grow with the "
                f"window: {kernels}")

    # -- smr ------------------------------------------------------------------
    def make_rsm(d):
        return ReplicatedStateMachine(
            select("lv"), RT_N, lambda s, b: s + b.sum(dtype=torch.int32),
            torch.tensor(0, dtype=torch.int32),
            scenarios.omission(RT_N, RT_P_DROP, device=d),
            batch_size=SMR_BATCH, max_phases=RT_PHASES, device=d)

    cmds = [int(c) for c in
            torch.randint(0, 1000, (SMR_COMMANDS,),
                          generator=torch.Generator().manual_seed(SEED))]
    rsms = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        rsm = make_rsm(d)
        rsm.propose(cmds)
        t0 = time.perf_counter()
        instances = rsm.run((0, 7))
        state = int(rsm.apply_decided())
        rsms[name] = (rsm, instances, state, time.perf_counter() - t0)

    def digest(rsm):
        log = DecisionLog()
        for i, b in rsm.decided_batches.items():
            log.record(i, 0, b)
        return log.digest()

    card, n_inst, card_state, card_s = rsms["card"]
    cpu_rsm, _, cpu_state, _ = rsms["cpu"]
    require(card.decided_batches == cpu_rsm.decided_batches
            and card_state == cpu_state and digest(card) == digest(cpu_rsm),
            "smr: the card's decisions or applied state differ from the CPU's")
    require(card.log_gaps() == [] and card_state == sum(cmds),
            "smr: the card's replica has gaps or a wrong applied state")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        card.checkpoint(tmp)
        fresh = make_rsm(dev)
        upto = fresh.restore_checkpoint(tmp)
    require(upto == card.applied_upto
            and int(fresh.apply_decided()) == card_state
            and fresh.next_instance == card.next_instance
            and fresh.log_gaps() == [],
            "smr: the restored replica differs from its never-crashed twin")
    lag = make_rsm(dev)
    recovered = lag.recover_from(card)
    require(recovered == n_inst and lag.log_gaps() == []
            and int(lag.apply_decided()) == card_state,
            "smr: the lagging replica did not recover every gap")
    say_json("smr", protocol="lv", n=RT_N, batch=SMR_BATCH,
             commands=SMR_COMMANDS, instances=n_inst,
             applied_upto=card.applied_upto, applied_state=card_state,
             wall_s=card_s, cpu_equal=True, restored_equal=True,
             recovered=recovered, digest=digest(card))

    # -- membership -----------------------------------------------------------
    got = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        directory = Directory(local_group(RT_N))
        mm = MembershipManager(directory, device=d)
        ops = [mm.propose(1, 4450), mm.propose(2, 1)]
        got[name] = (ops, mm.view_nbr,
                       [(r.id, r.address, r.port)
                        for r in directory.group.replicas])
    require(got["card"] == got["cpu"],
            f"membership: the card's directory differs from the CPU's: {got}")
    require(got["card"][0] == [(1, 4450), (2, 1)],
            f"membership: undecided or wrong ops {got['card'][0]}")
    say_json("membership", n=RT_N, ops=got["card"][0],
             view_nbr=got["card"][1], group=got["card"][2], cpu_equal=True)


# the host runner's deployment (round_tpu_torch/apps/host_perftest.py's
# defaults, which are round_tpu's: PerfTest2's 4 replicas, 300-ms rounds)
HOST_N, HOST_TIMEOUT_MS = 4, 300
HOST_PROC_INSTANCES = 100
# instances of the thread runs, on the card and again on the CPU: LastVoting
# decides ~0.8 instances a second on 300-ms rounds, so it runs 10
HOST_THREAD_INSTANCES = {"otr": 20, "lastvoting": 10}
# the chaos run: 10 % iid drops from a fixed seed, 10 instances (a dropped
# frame costs its receiver a 300-ms round)
HOST_CHAOS, HOST_CHAOS_INSTANCES = "drop=0.1,seed=7", 10
# frames per drain in the recv_many timing
HOST_DRAIN_FRAMES = 64


def _host_lane_io(name: str, lane: int):
    """One lane's io for a selector model: round_tpu's PerfTest2 value
    for the scalar models, the analysis registry's io for MultiLastVoting
    and TwoPhaseCommit (round_tpu/analysis/registry.py)."""
    import numpy as np

    from round_tpu_torch.models.lastvoting_variants import mlv_io
    from round_tpu_torch.models.tpc import tpc_io
    from round_tpu_torch.runtime.host import instance_io

    if name == "mlv":
        io = mlv_io(HOST_N, {0: 5, 3: 9}, {1: 0})
    elif name == "tpc":
        io = tpc_io(0, np.ones(HOST_N, dtype=bool))
    else:
        from round_tpu_torch.apps.selector import select

        return instance_io(select(name), 3)
    return {k: v[lane].numpy() for k, v in io.items()}


def _host_threads(algo, instances, device, wrap=None, value_schedule="mixed"):
    """HOST_N HostRunner threads over localhost TCP on ``device``, every
    socket bound before any replica starts; ``wrap(i, transport)`` may
    put a fault layer around replica i's transport.  Returns the
    decision logs."""
    import threading

    from round_tpu_torch.apps.selector import select
    from round_tpu_torch.runtime.chaos import alloc_ports
    from round_tpu_torch.runtime.host import run_instance_loop
    from round_tpu_torch.runtime.transport import HostTransport

    ports = alloc_ports(HOST_N)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(HOST_N)}
    trs = [HostTransport(i, ports[i]) for i in range(HOST_N)]
    shared = select(algo)
    logs, errors = {}, {}

    def run(i):
        tr = trs[i] if wrap is None else wrap(i, trs[i])
        try:
            logs[i] = run_instance_loop(
                shared, i, peers, tr, instances, timeout_ms=HOST_TIMEOUT_MS,
                value_schedule=value_schedule, device=device)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors[i] = repr(e)
        finally:
            trs[i].close()

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(HOST_N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    require(not errors and len(logs) == HOST_N
            and not any(t.is_alive() for t in threads),
            f"host threads failed: {errors}")
    return logs


def host_phases(torch, dev) -> None:
    """The wire and the host runner (round_tpu_torch/runtime/codec.py,
    transport.py, host.py, chaos.py; apps/host_perftest.py, host_replica.py;
    no kernel of their own) on the card, each held against the CPU."""
    import threading

    import numpy as np

    from round_tpu_torch.apps import host_perftest
    from round_tpu_torch.apps.selector import NAMES, select
    from round_tpu_torch.engine import scenarios
    from round_tpu_torch.engine.executor import make_host_round_fns
    from round_tpu_torch.obs.metrics import METRICS
    from round_tpu_torch.runtime import chaos, codec, host
    from round_tpu_torch.runtime.oob import Tag
    from round_tpu_torch.runtime.transport import HostTransport

    cpu = torch.device("cpu")

    # -- host-wire ------------------------------------------------------------
    fallbacks = METRICS.counter("wire.codec_fallbacks")
    before = fallbacks.value
    sent, wires = [], []
    for name in NAMES:
        algo = select(name)
        io = _host_lane_io(name, 1)
        got = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            st = host.lane_init_state(algo, 1, HOST_N, io, d)
            got[where] = []
            for k, rnd in enumerate(algo.rounds):
                send = make_host_round_fns(rnd, HOST_N, d)[0]
                _st, payload, _dest = send(k, 1, 0, st)
                if where == "card":
                    sent.append(payload)
                got[where].append(codec.encode(host.to_numpy(payload)))
        require(got["card"] == got["cpu"],
                f"host-wire: {name}'s payload bytes from the card differ "
                f"from the CPU's")
        wires += got["card"]
    require(fallbacks.value == before,
            f"host-wire: {fallbacks.value - before} payload(s) took the "
            f"pickle fallback")
    reps = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        arrays = [host.to_numpy(p) for p in sent]
    fetch_us = (time.perf_counter() - t0) * 1e6 / (reps * len(sent))
    t0 = time.perf_counter()
    for _ in range(reps):
        for a in arrays:
            codec.encode(a)
    encode_us = (time.perf_counter() - t0) * 1e6 / (reps * len(arrays))
    t0 = time.perf_counter()
    for _ in range(reps):
        for w in wires:
            codec.decode(w)
    decode_us = (time.perf_counter() - t0) * 1e6 / (reps * len(wires))
    drains = []
    with HostTransport(0) as a, HostTransport(1) as b:
        a.add_peer(1, "127.0.0.1", b.port)
        frame = wires[0]
        for rep in range(21):
            for r in range(HOST_DRAIN_FRAMES):
                a.send_buffered(1, Tag(instance=1, round=r), frame)
            a.flush()
            time.sleep(0.02)  # let every frame land in the native inbox
            t0 = time.perf_counter()
            got = b.recv_many(1000)
            dt = time.perf_counter() - t0
            while len(got) < HOST_DRAIN_FRAMES:
                more = b.recv_many(1000)
                require(more, "host-wire: the drain lost frames")
                got += more
            if rep:  # the first drain connects and warms up
                drains.append(dt)
    say_json("host-wire", models=len(NAMES), payloads=len(wires),
             card_equals_cpu=True, pickle_fallbacks=0,
             fetch_us=fetch_us, encode_us=encode_us, decode_us=decode_us,
             drain_frames=HOST_DRAIN_FRAMES,
             drain_us=1e6 * float(np.median(drains)),
             drain_us_per_frame=1e6 * float(np.median(drains))
             / HOST_DRAIN_FRAMES)

    # -- host-threads ---------------------------------------------------------
    for algo in ("otr", "lastvoting"):
        host_perftest.measure(n=HOST_N, instances=2, algo=algo,
                              device=dev)  # loads each kernel once
        runs = {}
        for where, d in (("card", dev), ("cpu", cpu)):
            runs[where] = host_perftest.measure(
                n=HOST_N, instances=HOST_THREAD_INSTANCES[algo], algo=algo,
                timeout_ms=HOST_TIMEOUT_MS, device=d)
        card, card_logs = runs["card"]
        cpu_res, cpu_logs = runs["cpu"]
        for what, res in (("card", card), ("CPU", cpu_res)):
            require(res["extra"]["agreed_instances"]
                    == HOST_THREAD_INSTANCES[algo],
                    f"host-threads {algo}: {what} agreed "
                    f"{res['extra']['agreed_instances']} of "
                    f"{HOST_THREAD_INSTANCES[algo]}")
        require(card_logs == cpu_logs,
                f"host-threads {algo}: the card's decisions "
                f"{card_logs[0]} differ from the CPU's {cpu_logs[0]}")
        rounds = [st["rounds_run"] for st in card["extra"]["node_stats"].values()]
        # an instrumented run: METRICS deltas for rounds and copies, the
        # sync debug mode for host syncs, the host time of each step of a
        # replica round (the send's and the update's launches, the fetch,
        # the upload), then one profiled run for the launches
        names = ("host.rounds", "host.d2h_copies", "host.h2d_copies")
        c0 = [METRICS.counter(k).value for k in names]
        spent, lock = {"send": [], "update": [], "fetch": [],
                       "upload": []}, threading.Lock()

        def timed(fn, what):
            def run(*a):
                t = time.perf_counter()
                out = fn(*a)
                with lock:
                    spent[what].append(time.perf_counter() - t)
                return out
            return run

        fetch, upload = host.to_numpy, host.to_device
        round_fns = host.HostRunner._round_fns

        def timed_fns(self, rnd):
            f_send, f_update, f_go = round_fns(self, rnd)
            return timed(f_send, "send"), timed(f_update, "update"), f_go

        host.to_numpy, host.to_device = (timed(fetch, "fetch"),
                                         timed(upload, "upload"))
        host.HostRunner._round_fns = timed_fns
        try:
            t0 = time.perf_counter()
            _, syncs = device_syncs(torch, lambda: host_perftest.measure(
                n=HOST_N, instances=3, algo=algo, device=dev))
            wall = time.perf_counter() - t0
        finally:
            host.to_numpy, host.to_device = fetch, upload
            host.HostRunner._round_fns = round_fns
        r_n, d2h, h2d = (METRICS.counter(k).value - c for k, c in
                         zip(names, c0))
        # ms of host time per replica round in each step, and the rest of
        # the round (the wire, the pump's wait for peers, the GIL)
        steps = {k: sum(v) * 1e3 / r_n for k, v in spent.items()}
        c0 = METRICS.counter("host.rounds").value
        calls, kernels, copies = traced_launches(
            torch, lambda: host_perftest.measure(n=HOST_N, instances=3,
                                                 algo=algo, device=dev))
        r_p = METRICS.counter("host.rounds").value - c0
        # the same fetch with the stream idle: one replica's payload alone
        st = host.lane_init_state(select(algo), 1, HOST_N,
                              host.instance_io(select(algo), 3), dev)
        pay = make_host_round_fns(select(algo).rounds[0], HOST_N,
                                  dev)[0](0, 1, 0, st)[1:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fetch(pay)
        alone_us = (time.perf_counter() - t0) * 1e6 / reps
        say_json("host-threads", algo=algo, n=HOST_N,
                 instances=HOST_THREAD_INSTANCES[algo],
                 timeout_ms=HOST_TIMEOUT_MS,
                 metric=card["metric"], decisions_per_sec=card["value"],
                 wall_basis=card["extra"]["wall_basis"],
                 wall_s=card["extra"]["wall_s"],
                 cpu_decisions_per_sec=cpu_res["value"],
                 agreed=card["extra"]["agreed_instances"],
                 cpu_equal=True, decisions=card_logs[0],
                 rounds_per_replica=rounds,
                 ms_per_round=card["extra"]["wall_s"] * 1e3
                 / float(np.mean(rounds)),
                 timeouts={i: st["timeouts"] for i, st in
                           card["extra"]["node_stats"].items()},
                 d2h_per_round=d2h / r_n, h2d_per_round=h2d / r_n,
                 syncs_per_round=syncs / r_n,
                 launch_calls_per_round=calls / r_p,
                 kernels_per_round=kernels / r_p,
                 device_copies_per_round=copies / r_p,
                 fetch_us_shared_stream=1e6 * float(np.mean(spent["fetch"])),
                 fetch_us_alone=alone_us,
                 host_ms_per_replica_round=steps,
                 other_ms_per_replica_round=wall * 1e3 * HOST_N / r_n
                 - sum(steps.values()))

    # -- host-processes -------------------------------------------------------
    # the card, then the same processes on the CPU as the reference (their
    # start-up skew differs, so their logs are held to agreement only)
    procs = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        res, logs = host_perftest.measure_processes(
            n=HOST_N, instances=HOST_PROC_INSTANCES, algo="otr",
            timeout_ms=HOST_TIMEOUT_MS, device=d)
        require(res["extra"]["agreed_instances"] == HOST_PROC_INSTANCES
                and all(logs[i] == logs[0] for i in logs),
                f"host-processes ({where}): agreed "
                f"{res['extra']['agreed_instances']} of "
                f"{HOST_PROC_INSTANCES}, or the replicas' logs differ")
        procs[where] = res
    res, cpu_res = procs["card"], procs["cpu"]

    def ms_per_round(r):
        return r["extra"]["wall_s"] * 1e3 / float(
            np.mean(list(r["extra"]["rounds_run"].values())))

    say_json("host-processes", algo="otr", n=HOST_N,
             instances=HOST_PROC_INSTANCES, timeout_ms=HOST_TIMEOUT_MS,
             metric=res["metric"], decisions_per_sec=res["value"],
             wall_basis=res["extra"]["wall_basis"],
             wall_s=res["extra"]["wall_s"],
             harness_wall_s=res["extra"]["harness_wall_s"],
             decisions_per_sec_harness_wall=res["extra"][
                 "decisions_per_sec_harness_wall"],
             ms_per_round=ms_per_round(res),
             cpu_decisions_per_sec=cpu_res["value"],
             cpu_ms_per_round=ms_per_round(cpu_res),
             startup_s=res["extra"]["startup_s"],
             cpu_startup_s=cpu_res["extra"]["startup_s"],
             peak_gib=res["extra"]["peak_gib"],
             timeouts=res["extra"]["node_timeouts"],
             agreed=res["extra"]["agreed_instances"], logs_equal=True)

    # -- host-chaos -----------------------------------------------------------
    plan = chaos.FaultPlan.parse(HOST_CHAOS)
    attempts, lock = [], threading.Lock()

    def faulty(i, tr):
        ft = chaos.FaultyTransport(tr, plan, n=HOST_N)
        inner_faults = ft._send_faults

        def recorded(to, tag, payload):
            out = inner_faults(to, tag, payload)
            with lock:
                attempts.append((i, to, tag.round, tag.instance, not out[0]))
            return out

        ft._send_faults = recorded
        return ft

    logs = _host_threads("otr", HOST_CHAOS_INSTANCES, dev, wrap=faulty)
    decided = 0
    for inst in range(1, HOST_CHAOS_INSTANCES + 1):
        vals = {logs[i][inst - 1] for i in logs} - {None}
        proposals = {host._schedule_value("mixed", 0, i, inst)
                     for i in range(HOST_N)}
        require(len(vals) <= 1 and vals <= proposals,
                f"host-chaos: instance {inst} broke agreement or validity: "
                f"{[logs[i][inst - 1] for i in sorted(logs)]}")
        decided += all(logs[i][inst - 1] is not None for i in logs)
    s0, s1 = scenarios.host_key_salts(plan.seed)
    p8 = chaos._p8(plan.drop)
    want = {a[:4] for a in attempts
            if (scenarios.host_link_u32(s0, s1, a[2], a[0], a[1], HOST_N)
                & 0xFF) < p8}
    got = {a[:4] for a in attempts if a[4]}
    require(got == want and got,
            f"host-chaos: {len(got)} links dropped, host_link_u32 names "
            f"{len(want)}")
    max_r = max(a[2] for a in attempts)
    card_masks = torch.stack([scenarios.link_bernoulli(
        (s0, s1), r, HOST_N, plan.drop, device=dev)
        for r in range(max_r + 1)]).cpu()
    require(all(bool(card_masks[a[2], a[1], a[0]]) == a[4]
                for a in attempts),
            "host-chaos: link_bernoulli on the card disagrees with the "
            "dropped links")
    say_json("host-chaos", algo="otr", n=HOST_N, plan=plan.spec(),
             instances=HOST_CHAOS_INSTANCES, decided=decided,
             agreement=True, validity=True, sends=len(attempts),
             dropped=len(got), dropped_equal_host_link_u32=True,
             link_bernoulli_equal=True, decisions=logs[0])


# the lane driver and the fleet (round_tpu_torch/runtime/lanes.py,
# fleet.py): the mega-step's shape, round_tpu's tests/test_lanes.py
# cluster shapes, and host_perftest's defaults for the A/Bs
SERVE_L, SERVE_N = 64, 4
SERVE_STEP_MODELS = (("otr", 0), ("lastvoting", 0), ("lve", 0), ("lvb", 64))
# (model, payload bytes, instances, lanes, round ms, schedule, chaos)
SERVE_EQUIV = (("otr", 0, 6, 4, 2000, "mixed", None),
               ("lve", 0, 3, 3, 2000, "uniform", None),
               ("lvb", 64, 3, 3, 200, "mixed", None),
               ("otr", 0, 4, 4, 900, "uniform", "drop=0.12,seed=5"))
SERVE_OPEN_LOOP_RATE = 100.0  # run_fleet_bench's default offered rate


def _lane_inputs(torch, algo, L, rng, device):
    """An [L, ...] lane state of L instances (values from ``rng``), their
    salts, per-lane rounds of one class c (a function), an active mask
    and a mailbox builder, on ``device``."""
    import numpy as np

    from round_tpu_torch.engine.scenarios import host_key_salts
    from round_tpu_torch.runtime import host
    from round_tpu_torch.utils.tree import tree_stack

    values = rng.integers(0, 5, L)
    state = tree_stack([host.lane_init_state(
        algo, 1, SERVE_N, host.instance_io(algo, int(v)), device)
        for v in values])
    seeds = [7 + i for i in range(1, L + 1)]
    salts = torch.tensor([host_key_salts(s)[1] for s in seeds],
                         dtype=torch.int64, device=device)
    active = torch.from_numpy(rng.random(L) < 0.7).to(device)
    mask = torch.from_numpy(rng.random((L, SERVE_N)) < 0.8).to(device)
    return state, seeds, salts, active, mask


def _lane_cluster(driver, algo, device, n=3, instances=6, lanes=4, seed=7,
                  timeout_ms=2000, schedule="mixed", chaos=None,
                  linger_ms=0):
    """round_tpu's tests/test_lanes.py::_cluster on the port: n replica
    threads, every socket bound before any replica starts, "lanes" (the
    lane driver) or "seq" (the per-instance loop) on ``device``; with
    ``linger_ms`` each replica answers laggards after its loop.  Returns
    the decision logs."""
    import threading

    from round_tpu_torch.runtime import host
    from round_tpu_torch.runtime.chaos import (
        FaultPlan, FaultyTransport, alloc_ports,
    )
    from round_tpu_torch.runtime.lanes import run_instance_loop_lanes
    from round_tpu_torch.runtime.transport import HostTransport

    ports = alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    trs = [HostTransport(i, ports[i]) for i in range(n)]
    logs, errors = {}, {}

    def node(i):
        tr = trs[i]
        if chaos:
            tr = FaultyTransport(tr, FaultPlan.parse(chaos), n)
        try:
            if driver == "lanes":
                logs[i] = run_instance_loop_lanes(
                    algo, i, peers, tr, instances, lanes=lanes,
                    timeout_ms=timeout_ms, seed=seed,
                    value_schedule=schedule, device=device)
            else:
                logs[i] = host.run_instance_loop(
                    algo, i, peers, tr, instances, timeout_ms=timeout_ms,
                    seed=seed, value_schedule=schedule, device=device)
            if linger_ms:
                host.serve_decisions(tr, logs[i], idle_ms=linger_ms,
                                     contact_idle_ms=linger_ms // 2)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors[i] = repr(e)
        finally:
            trs[i].close()

    threads = [threading.Thread(target=node, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    require(not errors and len(logs) == n
            and not any(t.is_alive() for t in threads),
            f"lane cluster ({driver}) failed: {errors}")
    return logs


def serve_phases(torch, dev, card) -> None:
    """The lane driver and the fleet (round_tpu_torch/runtime/lanes.py,
    fleet.py, apps/loadgen.py, apps/fleet.py; no kernel of their own) on
    the card, each held against the CPU or the per-instance driver."""
    import threading

    import numpy as np

    from round_tpu_torch.apps import host_perftest
    from round_tpu_torch.apps.selector import select
    from round_tpu_torch.engine.executor import LaneStep, make_host_round_fns
    from round_tpu_torch.obs.metrics import METRICS
    from round_tpu_torch.runtime import host, lanes
    from round_tpu_torch.utils.tree import tree_flatten, tree_map

    cpu = torch.device("cpu")

    def algo_of(name, pb):
        return select(name, {"payload_bytes": pb} if pb else {})

    # -- lanes-step -----------------------------------------------------------
    def row(tree, lane):
        return tree_map(lambda x: x[lane], tree)

    def leaves_equal(a, b, flatten=tree_flatten):
        la, lb = flatten(a)[0], flatten(b)[0]
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
            for x, y in zip(la, lb))

    def mailbox(payload):
        return tree_map(lambda x: torch.stack(
            [torch.roll(x, j, 0) for j in range(SERVE_N)], 1), payload)

    checked = {}
    for name, pb in SERVE_STEP_MODELS:
        algo = algo_of(name, pb)
        rng = np.random.default_rng(5)
        places = (("card", dev), ("cpu", cpu))
        ins = {w: _lane_inputs(torch, algo, SERVE_L,
                               np.random.default_rng(5), d)
               for w, d in places}
        lanes_checked = 0
        for c, rnd in enumerate(algo.rounds):
            rr_np = (rng.integers(0, 6, SERVE_L) * len(algo.rounds)
                     + c).astype(np.int32)
            step = LaneStep(rnd, SERVE_N, SERVE_L)
            out = {}
            for w, d in places:
                state, seeds, salts, active, mask = ins[w]
                rr = torch.from_numpy(rr_np).to(d)
                st1, payload, dest = step.send(rr, 1, salts, state, active)
                vals = mailbox(payload)
                st2, ex = step.update(rr, 1, salts, st1, vals, mask, active)
                go = (step.go(rr, 1, salts, st1, vals, mask)
                      if step.go is not None else None)
                out[w] = (st1, payload, dest, vals, st2, ex, go)
            a, b = out["card"], out["cpu"]
            require(leaves_equal(a[0], b[0]) and leaves_equal(a[4], b[4])
                    and leaves_equal(a[1], b[1], host._flatten)
                    and torch.equal(a[2].cpu(), b[2])
                    and torch.equal(a[5].cpu(), b[5])
                    and (a[6] is None or torch.equal(a[6].cpu(), b[6])),
                    f"lanes-step {name} class {c}: the card differs from "
                    f"the CPU")
            # the per-instance trio, lane by lane on the card
            f_send, f_update, f_go = make_host_round_fns(rnd, SERVE_N, dev)
            state, seeds, salts, active, mask = ins["card"]
            st1, payload, dest, vals, st2, ex, go = a
            for lane in range(SERVE_L):
                if not bool(active[lane]):
                    require(leaves_equal(row(st2, lane), row(state, lane)),
                            f"lanes-step {name}: inactive lane {lane} "
                            f"changed")
                    continue
                r, s = int(rr_np[lane]), seeds[lane]
                t1, p1, d1 = f_send(r, 1, s, row(state, lane))
                t2, e2 = f_update(r, 1, s, row(st1, lane), row(vals, lane),
                                  mask[lane])
                require(leaves_equal(row(st1, lane), t1)
                        and leaves_equal(row(payload, lane), p1,
                                         host._flatten)
                        and torch.equal(dest[lane], d1)
                        and leaves_equal(row(st2, lane), t2)
                        and bool(ex[lane]) == bool(e2)
                        and (go is None or bool(go[lane]) == bool(f_go(
                            r, 1, s, row(st1, lane), row(vals, lane),
                            mask[lane]))),
                        f"lanes-step {name} class {c} lane {lane}: the "
                        f"mega-step differs from the per-instance trio")
                lanes_checked += 1
            ins["card"] = (st2,) + ins["card"][1:]
            ins["cpu"] = (b[4],) + ins["cpu"][1:]
        checked[name] = lanes_checked
    # launches of one send and one update dispatch at L=16 and L=64
    launches = {}
    algo = select("otr")
    for L in (16, SERVE_L):
        state, _seeds, salts, active, mask = _lane_inputs(
            torch, algo, L, np.random.default_rng(1), dev)
        step = LaneStep(algo.rounds[0], SERVE_N, L)
        rr = torch.zeros(L, dtype=torch.int32, device=dev)
        st1, payload, _dest = step.send(rr, 1, salts, state, active)
        vals = mailbox(payload)
        step.update(rr, 1, salts, st1, vals, mask, active)
        torch.cuda.synchronize()
        launches[L] = {
            "send": traced_launches(torch, lambda: step.send(
                rr, 1, salts, state, active))[0],
            "update": traced_launches(torch, lambda: step.update(
                rr, 1, salts, st1, vals, mask, active))[0]}
    require(launches[16] == launches[SERVE_L],
            f"lanes-step: launches grow with L: {launches}")
    say_json("lanes-step", n=SERVE_N, lanes=SERVE_L,
             models=[m for m, _ in SERVE_STEP_MODELS],
             active_lanes_checked=checked, cpu_equal=True,
             per_instance_equal=True, inactive_unchanged=True,
             launches_otr={str(k): v for k, v in launches.items()})

    # -- lanes-equiv ----------------------------------------------------------
    equiv = {}
    for name, pb, inst, L, ms, schedule, chaos in SERVE_EQUIV:
        kw = dict(instances=inst, timeout_ms=ms, schedule=schedule,
                  chaos=chaos, linger_ms=1500 if chaos else 0)
        algo = algo_of(name, pb)
        card_lanes = _lane_cluster("lanes", algo, dev, lanes=L, **kw)
        card_seq = _lane_cluster("seq", algo, dev, **kw)
        cpu_lanes = _lane_cluster("lanes", algo, cpu, lanes=L, **kw)
        what = f"{name}{'-chaos' if chaos else ''}"
        require(card_lanes == card_seq == cpu_lanes
                and all(d is not None for log in card_lanes.values()
                        for d in log),
                f"lanes-equiv {what}: lanes on the card {card_lanes}, "
                f"per-instance {card_seq}, lanes on the CPU {cpu_lanes}")
        equiv[what] = card_lanes[0]
    say_json("lanes-equiv", replicas=3, workloads=equiv,
             card_lanes_equal_card_per_instance=True,
             card_lanes_equal_cpu_lanes=True)

    # -- lanes-ab -------------------------------------------------------------
    ab = host_perftest.measure_lanes_ab(device=dev)
    # one instrumented lane run: METRICS deltas per update dispatch (a
    # wave of one round class), host syncs from the sync debug mode, the
    # host time of each step, then one profiled run for the launches
    names = ("lanes.dispatches", "lanes.update_dispatches",
             "lanes.send_dispatches", "lanes.go_dispatches",
             "host.rounds", "host.d2h_copies", "host.h2d_copies")
    spent, lock = {k: [] for k in ("send", "update", "fetch", "upload",
                                   "ingest")}, threading.Lock()
    exit_waves = [0]

    def timed(fn, what):
        def run(*a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            with lock:
                spent[what].append(time.perf_counter() - t)
            return out
        return run

    class TimedStep:
        def __init__(self, step):
            self.send = timed(step.send, "send")
            self.update = timed(step.update, "update")
            self.go = None if step.go is None else timed(step.go, "update")

    inner = (lanes.to_numpy, lanes.to_device, lanes.lane_step,
             lanes.lane_decide, lanes.LaneDriver._drain)

    def counted_decide(algo, L):
        fn = inner[3](algo, L)

        def run(state):
            exit_waves[0] += 1
            return fn(state)
        return run

    lanes.to_numpy = timed(inner[0], "fetch")
    lanes.to_device = timed(inner[1], "upload")
    lanes.lane_step = lambda *a, **kw: TimedStep(inner[2](*a, **kw))
    lanes.lane_decide = counted_decide
    lanes.LaneDriver._drain = timed(inner[4], "ingest")
    c0 = [METRICS.counter(k).value for k in names]
    h_ipd = lanes._H_IPD
    h0 = (h_ipd.count, h_ipd.sum)
    try:
        t0 = time.perf_counter()
        (res, logs), syncs = device_syncs(torch, lambda: host_perftest.measure(
            n=HOST_N, instances=SERVE_L, algo="otr", lanes=SERVE_L,
            device=dev))
        wall = time.perf_counter() - t0
    finally:
        (lanes.to_numpy, lanes.to_device, lanes.lane_step,
         lanes.lane_decide, lanes.LaneDriver._drain) = inner
    d = {k: METRICS.counter(k).value - v for k, v in zip(names, c0)}
    waves = d["lanes.update_dispatches"]
    require(res["extra"]["agreed_instances"] == SERVE_L,
            f"lanes-ab: the instrumented run agreed "
            f"{res['extra']['agreed_instances']} of {SERVE_L}")
    steps = {k: sum(v) * 1e3 / waves for k, v in spent.items()}
    c0 = METRICS.counter("lanes.update_dispatches").value
    calls, kernels, copies = traced_launches(
        torch, lambda: host_perftest.measure(
            n=HOST_N, instances=SERVE_L, algo="otr", lanes=SERVE_L,
            device=dev))
    waves_p = METRICS.counter("lanes.update_dispatches").value - c0
    say_json("lanes-ab", metric=ab["metric"], speedup=ab["value"],
             dps_per_instance=ab["extra"]["dps_per_instance"],
             dps_lanes=ab["extra"]["dps_lanes"],
             samples_per_instance=ab["extra"]["samples_per_instance"],
             samples_lanes=ab["extra"]["samples_lanes"],
             n=HOST_N, instances=SERVE_L, lanes=SERVE_L,
             timeout_ms=HOST_TIMEOUT_MS, pairs=ab["extra"]["pairs"],
             agreed=res["extra"]["agreed_instances"],
             waves=waves, waves_with_exits=exit_waves[0],
             dispatches_per_wave=d["lanes.dispatches"] / waves,
             send_dispatches=d["lanes.send_dispatches"],
             go_dispatches=d["lanes.go_dispatches"],
             instances_per_dispatch=(h_ipd.sum - h0[1])
             / max(1, h_ipd.count - h0[0]),
             d2h_per_wave=d["host.d2h_copies"] / waves,
             h2d_per_wave=d["host.h2d_copies"] / waves,
             syncs_per_wave=syncs / waves,
             launch_calls_per_wave=calls / waves_p,
             kernels_per_wave=kernels / waves_p,
             device_copies_per_wave=copies / waves_p,
             host_ms_per_wave=steps,
             other_ms_per_wave=wall * 1e3 * HOST_N / waves
             - sum(steps.values()),
             card=card)

    # -- overload -------------------------------------------------------------
    ov = host_perftest.measure_overload_ab(device=dev)
    runs = ov["extra"]["runs"]
    for arm, r in runs.items():
        o = r.get("overload", {})
        require(o.get("shed_frames", 0) == o.get("nacks_sent", 0)
                + o.get("nacks_suppressed", 0),
                f"overload {arm}: shed frames are not NACK-accounted: {o}")
    require(ov["extra"]["shed_accounting_ok"], "overload: shed accounting")
    say_json("overload", metric=ov["metric"], ratio=ov["value"],
             baseline_ratio=ov["extra"]["baseline_ratio"],
             shedding_ratio=ov["extra"]["shedding_ratio"],
             dps={k: r["dps"] for k, r in runs.items()},
             wall_s={k: r["wall_s"] for k, r in runs.items()},
             sheds=ov["extra"]["sheds"], shed_accounting_ok=True,
             rss_ratio_hardened=ov["extra"]["rss_ratio_hardened"],
             lanes_slow=ov["extra"]["lanes_slow"],
             overload=ov["extra"]["overload"],
             instances=ov["extra"]["instances"],
             timeout_ms=ov["extra"]["timeout_ms"], card=card)

    # -- fleet-open-loop ------------------------------------------------------
    fl = host_perftest.measure_open_loop(SERVE_OPEN_LOOP_RATE, device=dev)
    rep, ol = fl["extra"], fl["extra"]["open_loop"]
    require(ol["decided"] == ol["instances"] and ol["unresolved"] == 0
            and ol["undecided"] == 0 and ol["give_ups"] == 0,
            f"fleet-open-loop: decided {ol['decided']} of "
            f"{ol['instances']}, unresolved {ol['unresolved']}")
    require(rep["shed_accounting_ok"],
            f"fleet-open-loop: shed {rep['shed_frames']} != NACKs "
            f"{rep['nacks_accounted']}")
    say_json("fleet-open-loop", metric=fl["metric"], achieved_dps=fl["value"],
             offered_rate=ol["offered_rate"], decided=ol["decided"],
             instances=ol["instances"], p50_ms=ol["p50_ms"],
             p95_ms=ol["p95_ms"], p99_ms=ol["p99_ms"],
             wall_s=ol["wall_s"], drivers=rep["drivers"], n=rep["n"],
             lanes=rep["lanes"], timeout_ms=rep["timeout_ms"],
             startup_s=rep["startup_s"], peak_gib=rep["peak_gib"],
             reproposals=ol["reproposals"],
             dup_decisions=ol["dup_decisions"],
             shed_accounting_ok=True, card=card)


# the verification plane (round_tpu_torch/rv, fuzz/{replay,hostile},
# byz/crosscheck.py): the monitored mega-step's shape, the broken fixtures
# under each policy, the crosscheck's acceptance scale
VERIFY_MODELS = ("otr", "lastvoting")
VERIFY_FIXTURES = ("rv-broken-validity", "rv-broken-agreement")
VERIFY_POLICIES = ("halt", "shed", "log")
VERIFY_CROSSCHECK = ("otr", "lastvoting", "pbft")
VERIFY_SCHEDULES = 10_000   # round_tpu's tests/test_byz.py acceptance scale
VERIFY_SMALL = 1_024        # the card-against-CPU crosscheck comparison


def _rv_cluster(driver, name, device, rv, n=3, instances=2, lanes=4,
                snap=None):
    """round_tpu's tests/test_rv.py::_cluster on the port: n replica
    threads of the fixture ``name`` under ``rv`` (and ``snap``) on
    ``device``.  Returns (logs, per-replica violated formulas,
    per-replica error type, the formulas the snapshot audit tripped)."""
    import threading

    from round_tpu_torch.apps.selector import select
    from round_tpu_torch.runtime import host
    from round_tpu_torch.runtime.chaos import alloc_ports
    from round_tpu_torch.runtime.lanes import run_instance_loop_lanes
    from round_tpu_torch.runtime.transport import HostTransport

    algo = select(name)
    ports = alloc_ports(n)
    peers = {i: ("127.0.0.1", ports[i]) for i in range(n)}
    trs = [HostTransport(i, ports[i]) for i in range(n)]
    logs, stats, errors = {}, {}, {}

    def node(i):
        st: dict = {}
        kw = dict(timeout_ms=2000, seed=7, value_schedule="mixed",
                  max_rounds=12, stats_out=st, rv=rv, snap=snap,
                  device=device)
        try:
            if driver == "lanes":
                logs[i] = run_instance_loop_lanes(
                    algo, i, peers, trs[i], instances, lanes=lanes, **kw)
            else:
                logs[i] = host.run_instance_loop(algo, i, peers, trs[i],
                                                 instances, **kw)
        except Exception as e:  # noqa: BLE001 — compared below
            errors[i] = type(e).__name__
        finally:
            stats[i] = st
            trs[i].close()

    threads = [threading.Thread(target=node, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=150)
    require(not any(t.is_alive() for t in threads),
            f"rv-cluster {name} ({driver}): a replica wedged")
    formulas = {i: sorted({v["formula"]
                           for v in stats[i].get("rv_violations", [])})
                for i in range(n)}
    snapped = sorted({v["formula"] for i in range(n)
                      for v in stats[i].get("snap_violations", [])})
    return ({i: logs.get(i) for i in range(n)}, formulas,
            {i: errors.get(i) for i in range(n)}, snapped)


# round_tpu's soak gate on the monitor A/B (tools/soak.py check_host_rv)
RV_GATE_AB = dict(n=4, instances=24, lanes=8, timeout_ms=300, pairs=3,
                  warmup=1, algo="lv")


def verify_phases(torch, dev, card) -> None:
    """The verification plane (no kernel of its own): the monitored
    mega-step, the broken fixtures under each policy in both drivers, the
    regression bank's replays, the monitor and snapshot A/Bs, the
    hostile-wire gate and the proof/fuzzer crosscheck, each on the card
    against the CPU."""
    import tempfile

    import numpy as np

    from round_tpu_torch.apps import fuzz_cli, host_perftest
    from round_tpu_torch.apps.selector import select
    from round_tpu_torch.byz.crosscheck import crosscheck
    from round_tpu_torch.engine.executor import LaneStep
    from round_tpu_torch.fuzz import replay
    from round_tpu_torch.fuzz.hostile import run_gate
    from round_tpu_torch.obs.metrics import METRICS
    from round_tpu_torch.runtime.chaos import alloc_ports
    from round_tpu_torch.runtime.lanes import run_instance_loop_lanes
    from round_tpu_torch.runtime.transport import HostTransport
    from round_tpu_torch.rv.compile import monitor_program
    from round_tpu_torch.rv.dump import RvConfig
    from round_tpu_torch.snap import SnapConfig
    from round_tpu_torch.utils.tree import tree_flatten, tree_map

    cpu = torch.device("cpu")

    def same(a, b):
        la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
            for x, y in zip(la, lb))

    def mailbox(payload):
        return tree_map(lambda x: torch.stack(
            [torch.roll(x, j, 0) for j in range(SERVE_N)], 1), payload)

    # -- rv-step --------------------------------------------------------------
    launches = {}
    for name in VERIFY_MODELS:
        algo = select(name)
        prog = monitor_program(algo, SERVE_N)
        rng = np.random.default_rng(9)
        ins = {w: _lane_inputs(torch, algo, SERVE_L,
                               np.random.default_rng(9), d)
               for w, d in (("card", dev), ("cpu", cpu))}
        mon_np = (rng.random(SERVE_L) < 0.5,
                  rng.integers(-1, 5, SERVE_L).astype(prog.decision_dtype),
                  rng.random(SERVE_L) < 0.5,
                  rng.integers(-1, 5, SERVE_L).astype(prog.decision_dtype),
                  rng.integers(0, 5, (SERVE_L, SERVE_N)).astype(
                      prog.init_dtype))
        mon = {w: [torch.from_numpy(np.array(m)).to(d) for m in mon_np]
               for w, d in (("card", dev), ("cpu", cpu))}
        for c, rnd in enumerate(algo.rounds):
            rr_np = (rng.integers(0, 6, SERVE_L) * len(algo.rounds)
                     + c).astype(np.int32)
            step = LaneStep(rnd, SERVE_N, SERVE_L, monitor=prog)
            out = {}
            for w, d in (("card", dev), ("cpu", cpu)):
                state, _seeds, salts, active, mask = ins[w]
                rr = torch.from_numpy(rr_np).to(d)
                st1, payload, _dest = step.send(rr, 1, salts, state, active)
                vals = mailbox(payload)
                out[w] = step.update(rr, 1, salts, st1, vals, mask, active,
                                     *mon[w])
                if w == "card" and c == 0:
                    plain = LaneStep(rnd, SERVE_N, SERVE_L)
                    plain.update(rr, 1, salts, st1, vals, mask, active)
                    torch.cuda.synchronize()
                    launches[name] = {
                        "off": traced_launches(torch, lambda: plain.update(
                            rr, 1, salts, st1, vals, mask, active))[0],
                        "on": traced_launches(torch, lambda: step.update(
                            rr, 1, salts, st1, vals, mask, active,
                            *mon[w]))[0]}
            a, b = out["card"], out["cpu"]
            require(same(a[0], b[0]) and all(
                torch.equal(x.cpu(), y) for x, y in zip(a[1:], b[1:])),
                f"rv-step {name} class {c}: the card differs from the CPU")
            act = ins["card"][3]
            for lane in np.nonzero(~act.cpu().numpy())[0]:
                require(same(tree_map(lambda x: x[lane], a[0]),
                             tree_map(lambda x: x[lane], ins["card"][0]))
                        and bool(a[2][lane].all()),
                        f"rv-step {name}: inactive lane {lane} changed")
            ins["card"] = (a[0],) + ins["card"][1:]
            ins["cpu"] = (b[0],) + ins["cpu"][1:]
            for w in ("card", "cpu"):
                # the lane driver's merge: the wave's lanes carry their
                # post-update plane forward
                active = ins[w][3]
                mon[w][:2] = [torch.where(active, out[w][3], mon[w][0]),
                              torch.where(active, out[w][4], mon[w][1])]
    # copies and dispatches per update wave, monitors on against off: a
    # one-replica loopback run (lockstep lanes) is deterministic
    names = ("lanes.dispatches", "lanes.update_dispatches",
             "host.d2h_copies", "host.h2d_copies")

    def loopback(rv):
        port = alloc_ports(1)[0]
        tr = HostTransport(0, port)
        try:
            c0 = [METRICS.counter(k).value for k in names]
            log = run_instance_loop_lanes(
                select("otr"), 0, {0: ("127.0.0.1", port)}, tr, SERVE_L,
                lanes=16, timeout_ms=2000, seed=3, max_rounds=12, rv=rv,
                device=dev)
            return log, {k: METRICS.counter(k).value - v
                         for k, v in zip(names, c0)}
        finally:
            tr.close()

    log_off, d_off = loopback(None)
    log_on, d_on = loopback(RvConfig(policy="log"))
    require(log_on == log_off and d_on == d_off,
            f"rv-step: monitors changed the loopback run: {d_on} vs {d_off}")
    waves = max(1, d_on["lanes.update_dispatches"])
    say_json("rv-step", n=SERVE_N, lanes=SERVE_L, models=VERIFY_MODELS,
             cpu_equal=True, inactive_unchanged=True,
             update_launch_calls=launches,
             loopback_waves=d_on["lanes.update_dispatches"],
             d2h_per_wave={"off": d_off["host.d2h_copies"] / waves,
                           "on": d_on["host.d2h_copies"] / waves},
             h2d_per_wave={"off": d_off["host.h2d_copies"] / waves,
                           "on": d_on["host.h2d_copies"] / waves},
             logs_equal=True)

    # -- rv-cluster -----------------------------------------------------------
    seen = {}
    dump_dir = tempfile.mkdtemp(prefix="rv-")
    for fixture in VERIFY_FIXTURES:
        for policy in VERIFY_POLICIES:
            for driver in ("lanes", "seq"):
                kw = dict(policy=policy)
                if fixture == "rv-broken-agreement":
                    kw.update(gossip=True)
                if policy == "log":
                    kw.update(protocol=fixture, dump_dir=dump_dir)
                got = _rv_cluster(driver, fixture, dev, RvConfig(**kw))
                what = f"{fixture} {policy} {driver}"
                if fixture == "rv-broken-validity":
                    # a local violation: every replica trips it, on the
                    # card as on the CPU, with the same logs and errors
                    want = _rv_cluster(driver, fixture, cpu, RvConfig(
                        **{k: v for k, v in kw.items() if k != "dump_dir"}))
                    require(got == want, f"rv-cluster {what}: card {got} "
                                         f"!= CPU {want}")
                    require(all("property 'Validity'" in f
                                for f in got[1].values()),
                            f"rv-cluster {what}: a replica missed it")
                    if policy == "shed":
                        require(all(all(d is None for d in log)
                                    for log in got[0].values()),
                                f"rv-cluster {what}: a violating decision "
                                f"was logged: {got[0]}")
                else:
                    # gossip timing decides which replicas observe the
                    # split: the monitor must trip somewhere
                    require(any("property 'Agreement'" in f
                                for f in got[1].values()),
                            f"rv-cluster {what}: agreement not tripped: "
                            f"{got[1]}")
                if policy == "halt":
                    require(all(e == "RvViolation" for e in got[2].values()
                                if e is not None) and any(got[2].values()),
                            f"rv-cluster {what}: no halt: {got[2]}")
                seen[what] = {"logs": got[0], "formulas": got[1],
                              "errors": got[2]}
    arts = sorted(p for p in os.listdir(dump_dir) if p.endswith(".json"))
    require(arts, "rv-cluster: no artifact dumped")
    rc = fuzz_cli.main(["replay", "--artifact",
                        os.path.join(dump_dir, arts[0]), "--device", str(dev)])
    require(rc == 0, f"rv-cluster: fuzz_cli replay of {arts[0]} exited {rc}")
    say_json("rv-cluster", fixtures=VERIFY_FIXTURES,
             policies=VERIFY_POLICIES, drivers=["lanes", "seq"],
             runs=seen, artifacts=arts, replayed=arts[0],
             validity_card_equal_cpu=True, card=card)

    # -- replay-bank ----------------------------------------------------------
    bank = {}
    for path in sorted((ROOT / "tests" / "regressions").glob("*.json")):
        art = replay.load_artifact(str(path))
        ok, got = replay.check_engine(art, device=dev)
        require(ok, f"replay-bank {path.name}: {got} != "
                    f"{art['expected'].get('engine')}")
        bank[path.name] = got
    require(bank, "replay-bank: no banked artifact")
    say_json("replay-bank", artifacts=sorted(bank), engine_ok=True,
             outcomes=bank)

    # -- rv-ab ----------------------------------------------------------------
    # the run fails on what must hold on a clean run (checks counted, no
    # violation, identical logs); the overhead ratio is a measurement,
    # printed with round_tpu's gate verdict on it
    t0 = time.perf_counter()
    ab = host_perftest.measure_rv_ab(device=dev)
    ex = ab["extra"]
    require(ex["rv_checks"] > 0 and ex["rv_violations"] == 0
            and ex["logs_identical"], f"rv-ab: clean run failed: {ex}")
    say_json("rv-ab", metric=ab["metric"], value=ab["value"],
             gate=ab["gate"], card=card, wall_s=time.perf_counter() - t0,
             **{k: ex[k] for k in (
                 "dps_off", "dps_on", "median_off", "median_on",
                 "samples_off", "samples_on", "pairs", "instances", "lanes",
                 "n", "rv_checks", "rv_violations", "logs_identical")})

    # -- rv-ab-gate -----------------------------------------------------------
    # the same A/B at round_tpu's soak gate settings (tools/soak.py
    # check_host_rv: deadline-paced LastVoting), where round_tpu reads its
    # gate; the otr blast above is the dispatch-bound case it calls an
    # overstatement
    t0 = time.perf_counter()
    ab = host_perftest.measure_rv_ab(**RV_GATE_AB, device=dev)
    ex = ab["extra"]
    require(ex["rv_checks"] > 0 and ex["rv_violations"] == 0
            and ex["logs_identical"], f"rv-ab-gate: clean run failed: {ex}")
    say_json("rv-ab-gate", metric=ab["metric"], value=ab["value"],
             gate=ab["gate"], card=card,
             wall_s=time.perf_counter() - t0, algo=RV_GATE_AB["algo"],
             **{k: ex[k] for k in (
                 "dps_off", "dps_on", "median_off", "median_on",
                 "samples_off", "samples_on", "pairs", "instances", "lanes",
                 "n", "rv_checks", "rv_violations", "logs_identical")})

    # -- snap-ab --------------------------------------------------------------
    t0 = time.perf_counter()
    ab = host_perftest.measure_snap_ab(device=dev)
    ex = ab["extra"]
    require(ex["snap_cuts_audited"] > 0 and ex["snap_violations"] == 0
            and ex["snap_divergences"] == 0 and ex["logs_identical"],
            f"snap-ab: clean run failed: {ex}")
    wall = time.perf_counter() - t0
    # the broken-conservation fixture: the rv monitors stay silent, the
    # collector's audit on the card trips the invariant chain
    got = _rv_cluster("lanes", "snap-broken-conservation", dev,
                      RvConfig(policy="log"), snap=SnapConfig(
                          policy="log", every_k=1))
    require(all(f == [] for f in got[1].values())
            and "invariants (chain)" in got[3],
            f"snap-ab: snap-broken-conservation not caught: {got}")
    say_json("snap-ab", metric=ab["metric"], value=ab["value"],
             gate=ab["gate"], card=card, wall_s=wall,
             broken_caught=got[3],
             **{k: ex[k] for k in (
                 "dps_off", "dps_on", "median_off", "median_on",
                 "samples_off", "samples_on", "pairs", "instances", "lanes",
                 "n", "every_k", "payload_bytes", "snap_samples",
                 "snap_cuts_audited", "snap_violations", "snap_divergences",
                 "logs_identical")})

    # -- hostile --------------------------------------------------------------
    gate = run_gate(10_000, seed=0)
    require(gate["ok"], f"hostile: gate failed: {gate}")
    say_json("hostile", frames=10_000, ok=True,
             **{s: {k: v for k, v in gate[s].items() if k != "by_op"}
                for s in ("codec", "split", "pump")},
             hostile_rejected=gate["hostile_rejected"])

    # -- crosscheck -----------------------------------------------------------
    rec = {}
    timing = ("schedules_per_sec", "wall_s")
    for proto in VERIFY_CROSSCHECK:
        t0 = time.perf_counter()
        res = crosscheck(proto, 4, min_schedules=VERIFY_SCHEDULES, seed=3,
                         bank_dir=dump_dir, device=dev)
        wall = time.perf_counter() - t0
        require(res.in_ok and res.inside.evaluated >= VERIFY_SCHEDULES
                and not res.inside.violation and res.past_ok,
                f"crosscheck {proto}: {res.record()}")
        small = [crosscheck(proto, 4, min_schedules=VERIFY_SMALL,
                            pop_size=256, seed=5, device=d).record()
                 for d in (dev, cpu)]
        for r in small:
            for arm in ("inside", "past"):
                for k in timing:
                    r[arm].pop(k)
        require(small[0] == small[1],
                f"crosscheck {proto}: card {small[0]} != CPU {small[1]}")
        rec[proto] = {**res.record(), "wall_s": wall,
                      "small_card_equal_cpu": True}
    say_json("crosscheck", n=4, min_schedules=VERIFY_SCHEDULES,
             small_schedules=VERIFY_SMALL, results=rec)


# the verifier (round_tpu_torch/verify, host Python and the rtsat binary, no
# kernel): the nine extracted builders, traced on the card and on the CPU
PROOF_BUILDERS = (
    ("otr_extracted_tr", ()), ("lv_extracted_tr", ()),
    ("epsilon_extracted_tr", ()), ("tpce_extracted_tr", ()),
    ("lve_extracted_tr", ()), ("floodmin_extracted_tr", ()),
    ("kset_extracted_tr", ()), ("benor_extracted_tr", ("boj",)),
    ("benor_extracted_tr", ("bok",)), ("pbft_vc_selection_extracted", ()),
)
# the extracted-stage suites: builder of (name, hyp, concl, cfg) stages, the
# entailment budget round_tpu's test gives each, and the stages its tier-1
# run leaves to the slow tier (tests/test_extract_vcs.py SLOW); every other
# stage must be proved, as round_tpu's tests assert
PROOF_STAGES = (
    ("otr-extracted", "otr_extracted_stage_vcs", 400,
     {"Ci: max >= |C_pw|", "Di: msite <= w"}),
    ("lv-extracted", "lv_extracted_stage_vcs", 180, set()),
    ("epsilon-extracted", "epsilon_extracted_stage_vcs", 240, set()),
    ("tpce-extracted", "tpce_extracted_vcs", 240, set()),
    ("lve-extracted", "lve_extracted_stage_vcs", 240, set()),
)


def _print_tree(x) -> str:
    """Everything a builder returns, in order: formulas by repr,
    containers element by element, other objects (a StateSig) field by
    field, functions by name."""
    if isinstance(x, (list, tuple)):
        return "[" + ", ".join(_print_tree(y) for y in x) + "]"
    if isinstance(x, dict):
        return "{" + ", ".join(f"{_print_tree(k)}: {_print_tree(v)}"
                               for k, v in x.items()) + "}"
    if callable(x) and hasattr(x, "__qualname__"):
        return f"<fn {x.__qualname__}>"
    if hasattr(x, "__dict__") and type(x).__module__.startswith(
            "round_tpu_torch.verify.tr"):
        return type(x).__name__ + "(" + ", ".join(
            f"{k}={_print_tree(v)}" for k, v in sorted(vars(x).items())) + ")"
    return repr(x)


def proof_phases(torch, dev, card) -> None:
    """The port's verifier on the card's machine: its rtsat built there from
    round_tpu_torch/native/sat.cpp, the nine extracted builders traced on
    the card's tensors against the CPU's, and the tier-1 proof suites with
    the verdicts round_tpu's tests assert."""
    from round_tpu_torch.verify import protocols, solver
    from round_tpu_torch.verify.extract import canon
    from round_tpu_torch.verify.formula import And, Gt, Int, IntLit, Lt
    from round_tpu_torch.verify.formula import Variable

    # -- rtsat ----------------------------------------------------------------
    t0 = time.perf_counter()
    exe = Path(solver._sat_binary())
    build_s = time.perf_counter() - t0
    require(exe == ROOT / "round_tpu_torch" / "_build" / "rtsat",
            f"rtsat built at {exe}")
    x = Variable("x", Int)
    sat = solver.solve_ground(Gt(x, IntLit(1)), timeout_s=60)
    unsat = solver.solve_ground(And(Gt(x, IntLit(1)), Lt(x, IntLit(0))),
                                timeout_s=60)
    ses = solver.SatSession(2, [[1, 2], [-1, 2]])
    try:
        model = ses.solve(timeout_s=60)
        ses.add_clause([-2])
        dimacs_unsat = ses.solve(timeout_s=60) is None
    finally:
        ses.proc.kill()
        ses.proc.wait()
    require(sat == "sat" and unsat == "unsat" and model is not None
            and model[2] and dimacs_unsat,
            f"rtsat: x > 1 gave {sat}, x > 1 and x < 0 gave {unsat}")
    say_json("rtsat", exe=str(exe.relative_to(ROOT)), build_s=build_s,
             sat=sat, unsat=unsat, dimacs_sat=True, dimacs_unsat=True)

    # -- extract-card -----------------------------------------------------------
    t0 = time.perf_counter()
    on_card = [_print_tree(getattr(protocols, name)(*args, device=dev))
               for name, args in PROOF_BUILDERS]
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = [_print_tree(getattr(protocols, name)(*args, device="cpu"))
              for name, args in PROOF_BUILDERS]
    cpu_s = time.perf_counter() - t0
    for (name, args), a, b in zip(PROOF_BUILDERS, on_card, on_cpu):
        require(canon([a]) == canon([b]) and "ext!" in a,
                f"extract-card: {name}{args} prints differently on the card")
    say_json("extract-card", builders=len(PROOF_BUILDERS),
             chars=sum(len(a) for a in on_card), equal=True,
             raw_equal=on_card == on_cpu, card_s=card_s, cpu_s=cpu_s)

    # -- proof-suites -----------------------------------------------------------
    # host Python, one independent VC a task, over a pool of processes on
    # the machine's cores (no CUDA in them); the extracted stages are the
    # ones traced on the card, carried to the pool as pickles
    import concurrent.futures
    import copyreg
    import multiprocessing

    from round_tpu_torch.verify.formula import InterpretedFct

    copyreg.pickle(InterpretedFct, lambda fct: (_interpreted, (fct.name,)))
    tasks = [("tpc-hand", ("hand", "tpc_spec")),
             ("otr-hand", ("hand", "otr_spec"))]
    # LastVoting's staged chain as round_tpu's tier-1 run discharges it
    # (tests/test_lv_verify.py::test_lv_stage_subvcs: every proved entry
    # but the slow ones)
    tasks += [("lv-staged-chain", ("lv-sub", k))
              for k, (_l, _h, _c, _cfg, is_proved, slow)
              in enumerate(protocols.lv_stage_subvcs())
              if is_proved and not slow]
    for suite, builder, budget, slow in PROOF_STAGES:
        got = getattr(protocols, builder)(device=dev)
        stages = got[0] if isinstance(got, tuple) else got
        picked = [("stage", name, hyp, concl, cfg, budget)
                  for name, hyp, concl, cfg in stages if name not in slow]
        require(picked, f"proof-suites: {suite} has no stage")
        tasks += [(suite, t) for t in picked]
    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1) - 1)
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        results = list(pool.map(_proof_task, [t for _s, t in tasks]))
    wall = time.perf_counter() - t0
    copyreg.dispatch_table.pop(InterpretedFct, None)
    verdicts, secs = {}, {}
    for (suite, task), (ok, took) in zip(tasks, results):
        require(ok, f"proof-suites: {suite} {task[1]!r} not proved")
        verdicts[suite] = verdicts.get(suite, 0) + 1
        secs[suite] = secs.get(suite, 0.0) + took
    say_json("proof-suites", card=card, proved=verdicts, task_s=secs,
             workers=workers, wall_s=wall)


def _interpreted(name):
    """An interpreted symbol by name (how proof tasks carry the formula
    symbols, whose type schemes are closures)."""
    from round_tpu_torch.verify.formula import SYMBOL_BY_NAME

    return SYMBOL_BY_NAME[name]


def _proof_task(task):
    """One proof obligation in a pool process: a hand suite's full
    Verifier.check, one LastVoting sub-VC, or one extracted stage; returns
    (proved, seconds)."""
    from round_tpu_torch.verify import protocols
    from round_tpu_torch.verify.cl import entailment
    from round_tpu_torch.verify.verifier import Verifier

    t0 = time.perf_counter()
    if task[0] == "hand":
        ver = Verifier(getattr(protocols, task[1])())
        ok = ver.check() and "✗" not in ver.report()
    elif task[0] == "lv-sub":
        _label, hyp, concl, cfg, _p, _s = protocols.lv_stage_subvcs()[task[1]]
        ok = entailment(hyp, concl, cfg, timeout_s=400)
    else:
        _kind, _name, hyp, concl, cfg, budget = task
        ok = entailment(hyp, concl, cfg, timeout_s=budget)
    return bool(ok), time.perf_counter() - t0


# the analysis tier (round_tpu_torch/analysis, verify/param.py,
# apps/verifier_cli.py, apps/lint.py and rv/license.py's default prover)
ANALYSIS_MODELS = ("otr", "otr-hist", "lastvoting")
PARAM_VCS = {"param-otr": 19, "param-lv": 32}
# rv/license.py's verdicts as round_tpu's tests/test_rv.py asserts them
LICENSE_VERDICTS = (("otr", 4, "licensed"), ("lv", 5, "licensed"),
                    ("lvb", 9, "licensed"), ("otr", 3, "outside-envelope"),
                    ("benor", 9, "unlicensed"))
# the autoscale bench at round_tpu's defaults but one of its four load
# points, half as long: at all four (0.3-3x the knee, 5 s each) it took
# 114 s on an NVIDIA H100 80GB HBM3 at 700 W, which the full script's
# time limit cannot hold; the 3x point is the one that grows the fleet
AUTOSCALE_CUTS = {"multipliers": (3.0,), "point_s": 2.5}


def _lint_json(argv):
    """apps/lint.main in process: (exit code, its JSON document)."""
    from round_tpu_torch.apps import lint as lint_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_cli.main(argv + ["--json"])
    return rc, json.loads(buf.getvalue())


def _verifier_cli(argv):
    """apps/verifier_cli.main in process (its pool workers are processes
    of their own), its printout kept: (all proved, printout)."""
    from round_tpu_torch.apps import verifier_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = verifier_cli.main(argv)
    return ok, buf.getvalue()


def _finding_keys(doc):
    return sorted((f["rule"], f["severity"], f["model"], f["file"],
                   f["line"]) for key in ("findings", "suppressed")
                  for f in doc[key])


def analysis_phases(torch, dev, card) -> None:
    """The port's analysis tier on the card's machine: threshold automata
    traced on the card against the CPU, the parameterized suites through
    verifier_cli (cold, then from its cache), the default license prover
    and the autoscale bench it gates, and the lint over the models (traced
    on the card and on the CPU) and over the serving tier."""
    # the lint's CPU sweep, which the card's is held against, runs in a
    # process of its own beside the phases before it (one torch thread)
    t_cpu_lint = time.perf_counter()
    cpu_lint = subprocess.Popen(
        [sys.executable, "-m", "round_tpu_torch.apps.lint", "--all",
         "--json", "--device", "cpu"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        _threshold_card(dev)
        _param_and_license(dev, card)
        _lint_phase(dev, card, cpu_lint, t_cpu_lint)
    finally:
        if cpu_lint.poll() is None:
            cpu_lint.kill()
        cpu_lint.communicate()


def _threshold_card(dev) -> None:
    from round_tpu_torch.analysis.threshold import extract_automaton

    t0 = time.perf_counter()
    on_card = {m: extract_automaton(m, device=dev).to_dict()
               for m in ANALYSIS_MODELS}
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = {m: extract_automaton(m, device="cpu").to_dict()
              for m in ANALYSIS_MODELS}
    cpu_s = time.perf_counter() - t0
    for m in ANALYSIS_MODELS:
        require(on_card[m] == on_cpu[m],
                f"threshold-card: {m}'s automaton differs on the card")
    say_json("threshold-card", models=list(ANALYSIS_MODELS), equal=True,
             rules={m: len(on_card[m]["rules"]) for m in ANALYSIS_MODELS},
             card_s=card_s, cpu_s=cpu_s)


def _param_and_license(dev, card) -> None:
    import tempfile

    from round_tpu_torch.apps import fleet as fleet_app
    from round_tpu_torch.rv.license import ProofLicenseRegistry

    scratch = ROOT / "round_tpu_torch" / "_build"
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="analysis-",
                                     dir=scratch) as tmp:
        # -- param-suites ------------------------------------------------------
        jobs = max(1, (os.cpu_count() or 2) - 1)
        runs = {}
        for run in ("cold", "warm"):
            out = Path(tmp) / f"{run}.json"
            t0 = time.perf_counter()
            ok, printout = _verifier_cli(
                ["--suites", ",".join(PARAM_VCS), "--jobs", str(jobs),
                 "--json", str(out), "--cache", f"{tmp}/vc-cache",
                 "--device", str(dev)])
            wall = time.perf_counter() - t0
            require(ok, f"param-suites {run}: verifier_cli says "
                        f"{printout[-800:]}")
            runs[run] = (json.loads(out.read_text()), wall)
        (cold, cold_s), (warm, warm_s) = runs["cold"], runs["warm"]
        got = {s["name"]: s for s in cold["suites"]}
        for suite, count in PARAM_VCS.items():
            stages = got[suite]["stages"]
            require(len(stages) == count and all(st["ok"] for st in stages),
                    f"param-suites: {suite} proved "
                    f"{sum(st['ok'] for st in stages)} of {len(stages)} "
                    f"VCs, want all {count}")
        require(cold["all_ok"]
                and cold["cache"]["misses"] == len(PARAM_VCS),
                f"param-suites: the cold run {cold['cache']}")
        require(warm["all_ok"] and warm["cache"]["hits"] == len(PARAM_VCS)
                and all(s["cached"] for s in warm["suites"]),
                f"param-suites: the warm run {warm['cache']}")
        say_json("param-suites", card=card, jobs=jobs,
                 vcs={s: len(got[s]["stages"]) for s in PARAM_VCS},
                 proved=True, cold_s=cold_s, warm_s=warm_s,
                 warm_hits=warm["cache"]["hits"],
                 vc_hash={s: got[s]["vc_hash"][:16] for s in PARAM_VCS})

        # -- license -----------------------------------------------------------
        times, cached = {}, {}
        for run, solve in (("cold", True), ("cached", False)):
            reg = ProofLicenseRegistry(cache_dir=f"{tmp}/license-cache",
                                       solve=solve, device=dev)
            t0 = time.perf_counter()
            for a, n, want in LICENSE_VERDICTS:
                lic = reg.check(a, n)
                require(lic.status == want,
                        f"license ({run}): {a} at n={n} is {lic.status} "
                        f"({lic.reason}), want {want}")
                if lic.ok:
                    cached.setdefault(run, []).append(lic.cached)
            times[run] = time.perf_counter() - t0
    require(cached["cached"] == [True] * 3,
            f"license: the cache-only registry's hits {cached['cached']}")
    t0 = time.perf_counter()
    rep = fleet_app.run_autoscale_bench(
        model_path=str(ROOT / "CAPACITY_r02.json"), device=dev,
        **AUTOSCALE_CUTS)
    bench_s = time.perf_counter() - t0
    sup = rep["supervisor"]
    grows = [d["license"]["status"] for d in sup["decisions"]
             if d["action"] == "grow"]
    require(rep["license_prewarm"]["status"] == "licensed",
            f"license: the bench's pre-warm {rep['license_prewarm']}")
    require(grows and set(grows) == {"licensed"},
            f"license: autoscale grew {len(grows)} times, licenses {grows}")
    require(not rep["slo_met_by_shedding"] and not any(
        p["slo_met_by_shedding"] for p in rep["points"]),
        "license: a point met the SLO by shedding")
    say_json("license", card=card,
             verdicts={f"{a}@{n}": w for a, n, w in LICENSE_VERDICTS},
             cold_s=times["cold"], cached_s=times["cached"],
             bench_s=bench_s, grows=sup["grows"], shrinks=sup["shrinks"],
             refused=sup["refused"], shards=sup["shards"],
             multipliers=rep["multipliers"], slo_held=rep["slo_held"],
             achieved_dps=[p.get("achieved_dps") for p in rep["points"]],
             cuts=["multipliers (0.3, 1.0, 2.0, 3.0) -> (3.0,)",
                   "point_s 5.0 -> 2.5"])


def _lint_phase(dev, card, cpu_lint, t_cpu_lint) -> None:
    from round_tpu_torch import analysis
    from round_tpu_torch.analysis.threshold_fixtures import (
        THRESHOLD_FIXTURES_BY_NAME,
    )

    t0 = time.perf_counter()
    rc_card, doc_card = _lint_json(["--all", "--device", str(dev)])
    card_s = time.perf_counter() - t0
    out, err = cpu_lint.communicate(timeout=600)
    cpu_s = time.perf_counter() - t_cpu_lint
    require(cpu_lint.returncode == 0,
            f"lint --device cpu exited {cpu_lint.returncode}: {err[-800:]}")
    doc_cpu = json.loads(out)
    require(rc_card == 0 and doc_card["gating"] == 0,
            f"lint: {doc_card['gating']} gating findings on the card: "
            f"{doc_card['findings'][:3]}")
    require(_finding_keys(doc_card) == _finding_keys(doc_cpu),
            "lint: the card's findings differ from the CPU's")
    t0 = time.perf_counter()
    rc_rt, doc_rt = _lint_json(["--runtime", "--all"])
    runtime_s = time.perf_counter() - t0
    require(rc_rt == 0 and doc_rt["gating"] == 0,
            f"lint --runtime: {doc_rt['findings'][:3]}")
    # every family of the port's FAMILIES fires on the fixtures
    rc_fx, doc_fx = _lint_json(["--fixtures", "--device", str(dev)])
    rc_rfx, doc_rfx = _lint_json(["--runtime", "--fixtures"])
    fired = set(doc_fx["counts_by_family"]) | set(
        doc_rfx["counts_by_family"]) | {
        f.family for f in analysis.lint_model(
            THRESHOLD_FIXTURES_BY_NAME["tfix-data-bound"], dev)}
    missing = set(analysis.FAMILIES) - fired
    require(rc_fx == 1 and rc_rfx == 1 and not missing,
            f"lint: families no fixture fires: {sorted(missing)}")
    say_json("lint", card=card, models=len(analysis.REGISTRY),
             total=doc_card["total"], gating=doc_card["gating"],
             suppressed=len(doc_card["suppressed"]), same_as_cpu=True,
             runtime_gating=doc_rt["gating"],
             runtime_suppressed=len(doc_rt["suppressed"]),
             families_fired=sorted(fired), card_s=card_s, cpu_s=cpu_s,
             runtime_s=runtime_s)


# the replicated key-value store (round_tpu_torch/kv, the lane driver's and
# the fleet's kv paths, apps/kv.py): the array rider's log, round_tpu's
# test fixtures, and the bench at round_tpu's CLI defaults
KV_RECORDS, KV_ROW_B, KV_KEYSPACE = 4_096, 256, 4_096
KV_CONSENSUS_RECORDS = 64    # the log's head, decided by consensus too
KV_CLUSTER_B = 64            # round_tpu's tests/test_kv.py fixture width
KV_BENCH = dict(shards=2, n=3, lanes=16, rate=100.0, ops=400, warmup=4,
                payload_bytes=256, value_bytes=8, timeout_ms=200, keys=64,
                key_skew=0.8, read_frac=0.9, grade_mix=(0.2, 0.4, 0.4),
                keyspace=4_096, seed=0)  # round_tpu/apps/kv.py's defaults
# round_tpu's tests/test_kv.py broken-lease bench
KV_BROKEN = dict(KV_BENCH, timeout_ms=150, seed=7, keys=16,
                 grade_mix=(0.2, 0.6, 0.2), broken_lease=True)


def _kv_log(records: int, payload_bytes: int, keyspace: int):
    """A seeded decided record log: two clients' PUTs over ``keyspace``
    keys (each client counts its own per-key seqs, so equal-seq races
    happen), with txn, prepare, commit and abort records among them."""
    import numpy as np

    from round_tpu_torch.kv.store import (
        OP_ABORT, OP_COMMIT, OP_PREPARE, OP_PUT, OP_TXN, encode_record,
    )

    rng = np.random.default_rng(SEED)
    counters = [{}, {}]
    rows = []
    for i in range(records):
        key = b"key%d" % int(rng.integers(0, keyspace))
        c = int(rng.integers(0, 2))
        seq = counters[c][key] = counters[c].get(key, 0) + 1
        val = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
        op = OP_PUT if i % 16 else (OP_TXN, OP_PREPARE, OP_COMMIT,
                                    OP_ABORT)[(i // 16) % 4]
        rows.append(encode_record(op, [(seq, key, val)], payload_bytes,
                                  txn=i // 64 + 1, keyspace=keyspace))
    return rows


def _kv_cluster(device, shards: int):
    """round_tpu's tests/test_kv.py kv_cluster (one shard) or kv_cluster2
    (two) on ``device``, driven through the same operations.  Returns
    (the answers and decisions, every replica's store per shard, the
    shards' kv summaries)."""
    import numpy as np

    from round_tpu_torch.kv import reads as R
    from round_tpu_torch.kv.client import KVClient
    from round_tpu_torch.kv.lin import check_history
    from round_tpu_torch.kv.store import (
        OP_ABORT, OP_PREPARE, KvConfig, encode_record,
    )
    from round_tpu_torch.models.lastvoting import LastVotingBytes
    from round_tpu_torch.runtime.fleet import DriverServer, FleetRouter

    B = KV_CLUSTER_B
    srvs = [DriverServer(LastVotingBytes(payload_bytes=B), n=3, lanes=8,
                         timeout_ms=150, idle_ms=60_000, max_ms=120_000,
                         kv=KvConfig(), device=device)
            for _ in range(shards)]
    for s in srvs:
        s.start()
    router = FleetRouter(proto="tcp")
    for i, s in enumerate(srvs):
        router.add_shard(f"s{i}", s.replicas)
    cl = KVClient(router, payload_bytes=B, device=device)
    out = {}

    def drained(what):
        require(cl.drain(30.0), f"kv-cluster ({device}): {what} stuck")

    def last_read(key, grade=R.GRADE_LIN, issue=True):
        if issue:
            cl.read(key, grade)
            drained(f"read of {key!r}")
        op = [o for o in cl.history
              if o["op"] == "r" and o["key"] == key.hex()][-1]
        require(op["ok"], f"kv-cluster ({device}): read of {key!r} failed")
        return op["res_seq"], op["res_val"]

    def key_on(shard, prefix):
        return next(k for k in (f"{prefix}{i}".encode()
                                for i in range(4096))
                    if router.ring.owner_key(k) == shard)

    def txn(pairs):
        return cl.txn(pairs, deadline_s=60.0)["committed"]

    def blocker(op, ka):
        inst = cl._alloc_inst()
        router.propose(inst, encode_record(op, [(99, ka, b"blk")], B,
                                           txn=9001), shard="s0", txn=True)
        require(cl._wait_insts([inst], 30.0),
                f"kv-cluster ({device}): blocker {op} undecided")

    try:
        if shards == 1:
            cl.put(b"lin-k", b"v1")
            drained("put")
            out["lin"] = last_read(b"lin-k")
            cl.put(b"lin-k", b"v2")
            cl.read(b"lin-k", R.GRADE_LIN)
            drained("put + read")
            out["lin-behind-write"] = last_read(b"lin-k", issue=False)
            cl.put(b"lease-k", b"lv")
            drained("put")
            out["lease"] = last_read(b"lease-k", R.GRADE_LEASE)
            cl.put(b"stale-k", b"sv")
            drained("put")
            out["stale"] = last_read(b"stale-k", R.GRADE_STALE)
            out["txn"] = txn({b"txn-a": b"1", b"txn-b": b"2"})
            out["txn-reads"] = [last_read(b"txn-a"), last_read(b"txn-b")]
            require(out["lin-behind-write"][0] == 2 and out["txn"],
                    f"kv-cluster ({device}): {out}")
        else:
            ka, kb = key_on("s0", "ya"), key_on("s1", "yb")
            out["commit"] = txn({ka: b"A1", kb: b"B1"})
            blocker(OP_PREPARE, ka)
            out["conflict"] = txn({ka: b"A2", kb: b"B2"})
            out["after-abort"] = [last_read(ka), last_read(kb)]
            blocker(OP_ABORT, ka)
            out["retry"] = txn({ka: b"A3", kb: b"B3"})
            out["after-retry"] = [last_read(ka), last_read(kb)]
            require(out["commit"] and not out["conflict"] and out["retry"]
                    and out["after-abort"][0][1] == b"A1".hex(),
                    f"kv-cluster ({device}): {out}")
        viol = check_history(cl.history)
        require(not viol, f"kv-cluster ({device}): checker: {viol}")
        out["decisions"] = {
            i: None if v is None else np.asarray(v).tobytes().hex()
            for i, v in sorted(router.results.items())}
        # the stores are read once every replica of a shard has applied
        # what its siblings did (one replica may trail them by a round)
        t_end, steady = time.monotonic() + 30.0, 0
        while time.monotonic() < t_end and steady < 5:
            even = all(len({sh.state.applied for sh in s.kv_shards}) == 1
                       for s in srvs)
            steady = steady + 1 if even else 0
            time.sleep(0.1)
    finally:
        router.close()
        for s in srvs:
            s.stop()
        for s in srvs:
            s.join(30.0)
    stores = [[(sh.state.data, sh.state.txns, sh.state.locks,
                sh.state.applied) for sh in s.kv_shards] for s in srvs]
    return out, stores, [s.kv_summary() for s in srvs]


def _kv_loopback(device, kv: bool, writes: int = 16):
    """One replica on ``device`` serving ``writes`` records one at a time
    after one more, with kv off or on (and then a lin and a lease read
    after each write): its log, and the host copies and update waves of
    the ``writes`` records."""
    from round_tpu_torch.kv import reads as R
    from round_tpu_torch.kv.client import KVClient
    from round_tpu_torch.kv.store import OP_PUT, KvConfig, encode_record
    from round_tpu_torch.models.lastvoting import LastVotingBytes
    from round_tpu_torch.obs.metrics import METRICS
    from round_tpu_torch.runtime.fleet import DriverServer, FleetRouter

    names = ("lanes.update_dispatches", "host.d2h_copies",
             "host.h2d_copies")
    B = KV_CLUSTER_B
    srv = DriverServer(LastVotingBytes(payload_bytes=B), n=1, lanes=4,
                       timeout_ms=150, idle_ms=30_000, max_ms=60_000,
                       kv=KvConfig() if kv else None, device=device)
    srv.start()
    router = FleetRouter(proto="tcp")
    router.add_shard("s0", srv.replicas)
    cl = KVClient(router, payload_bytes=B, device=device)

    def write(i):
        rec = encode_record(OP_PUT, [(i + 1, b"lb", b"v%d" % i)], B)
        router.propose(i + 1, rec, shard="s0")
        require(cl._wait_insts([i + 1], 30.0),
                f"kv-cluster loopback: write {i + 1} undecided")
        if kv:
            cl.read(b"lb", R.GRADE_LIN)
            cl.read(b"lb", R.GRADE_LEASE)
            require(cl.drain(20.0), "kv-cluster loopback: reads stuck")

    try:
        # one write before the counts: the replica makes its one-time
        # layout upload as its driver starts, on its own thread, and
        # that may land on either side of an unguarded first reading
        write(0)
        c0 = [METRICS.counter(k).value for k in names]
        for i in range(1, writes + 1):
            write(i)
        d = {k: METRICS.counter(k).value - v for k, v in zip(names, c0)}
    finally:
        router.close()
        srv.stop()
        srv.join(30.0)
    return dict(srv.results[0]), d


def kv_phases(torch, dev, card) -> None:
    """The replicated key-value store (round_tpu_torch/kv, the lane
    driver's and the fleet's kv paths, apps/kv.py; no kernel of its own)
    on the card, each held against the CPU or its own checker."""
    import tempfile

    import numpy as np

    from round_tpu_torch.apps import kv as kv_app
    from round_tpu_torch.engine import scenarios
    from round_tpu_torch.kv.store import (
        OP_PUT, KVState, decode_record, key_index, kv_array_apply,
        kv_array_machine, value_digest,
    )

    cpu = torch.device("cpu")

    # -- kv-array -------------------------------------------------------------
    rows = _kv_log(KV_RECORDS, KV_ROW_B, KV_KEYSPACE)
    host = KVState()
    for row in rows:
        rec = decode_record(row)
        if rec["op"] == OP_PUT:
            host.apply(rec)
    # a slot holds the largest (seq, digest) of the keys hashed to it
    best = {}
    for key, (seq, val) in host.data.items():
        slot = key_index(key, KV_KEYSPACE)
        best[slot] = max(best.get(slot, (0, 0)), (seq, value_digest(val)))
    want = np.zeros((2, KV_KEYSPACE), np.int64)
    for slot, (seq, dig) in best.items():
        want[:, slot] = (seq, dig)

    def machine(device, window=16):
        return kv_array_machine(3, scenarios.full(3, device=device),
                                payload_bytes=KV_ROW_B, keyspace=KV_KEYSPACE,
                                window=window, device=device)

    def fold(device, count):
        m = machine(device)
        m.decided_batches = dict(enumerate(rows[:count]))
        m.next_instance = count
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if device.type == "cuda":
            (seqs, digs), syncs = device_syncs(torch, m.apply_decided)
            torch.cuda.synchronize()
        else:
            (seqs, digs), syncs = m.apply_decided(), None
        dt = time.perf_counter() - t0
        return (np.stack([seqs.cpu().numpy().astype(np.int64),
                          digs.cpu().numpy()]), dt, syncs)

    fold(dev, 64)  # first use of the fold's ops on the card
    card_t, card_s, syncs_all = fold(dev, KV_RECORDS)
    _t, _s, syncs_head = fold(dev, 64)
    cpu_t, cpu_s, _ = fold(cpu, KV_RECORDS)
    require(np.array_equal(card_t, cpu_t) and np.array_equal(card_t, want),
            "kv-array: the card's (seq, digest) tables differ from the "
            "CPU fold's or the host KVState's")
    require(syncs_all == syncs_head,
            f"kv-array: host syncs grow with the log: {syncs_head} at 64 "
            f"records, {syncs_all} at {KV_RECORDS}")
    # the launch calls of one record's fold step
    table = (torch.zeros(KV_KEYSPACE, dtype=torch.int32, device=dev),
             torch.zeros(KV_KEYSPACE, dtype=torch.int64, device=dev))
    row = torch.from_numpy(rows[1]).to(dev)
    kv_array_apply(table, row)
    torch.cuda.synchronize()
    step_launches = traced_launches(torch, lambda: kv_array_apply(table,
                                                                  row))[0]
    # the log's head through consensus on the card and on the CPU
    decided = {}
    for w, d in (("card", dev), ("cpu", cpu)):
        m = machine(d, window=KV_CONSENSUS_RECORDS)
        for row in rows[:KV_CONSENSUS_RECORDS]:
            m.propose(row.tolist())
        require(m.run((0, SEED)) == KV_CONSENSUS_RECORDS,
                f"kv-array: {w} consensus did not take every record")
        decided[w] = [m.decided_batches.get(i)
                      for i in range(KV_CONSENSUS_RECORDS)]
        seqs, digs = m.apply_decided()
        require(np.array_equal(np.stack([seqs.cpu().numpy(),
                                         digs.cpu().numpy()]),
                               fold(cpu, KV_CONSENSUS_RECORDS)[0]),
                f"kv-array: the {w} consensus log folds differently")
    require(all(a is not None and a.tobytes() == r.tobytes()
                for a, r in zip(decided["card"], rows))
            and all(a.tobytes() == b.tobytes()
                    for a, b in zip(decided["card"], decided["cpu"])),
            "kv-array: consensus on the card decided other records")
    say_json("kv-array", records=KV_RECORDS, payload_bytes=KV_ROW_B,
             keyspace=KV_KEYSPACE, keys_written=len(host.data),
             slots_written=len(best), fold_s=card_s,
             records_per_s=KV_RECORDS / card_s, cpu_fold_s=cpu_s,
             launch_calls_per_record=step_launches,
             syncs=syncs_all, syncs_at_64=syncs_head,
             consensus_records=KV_CONSENSUS_RECORDS,
             card_equal_cpu=True, equal_host_store=True, card=card)

    # -- kv-cluster -----------------------------------------------------------
    clusters = {}
    t0 = time.perf_counter()
    for shards in (1, 2):
        got = _kv_cluster(dev, shards)
        ref = _kv_cluster(cpu, shards)
        require(got[0] == ref[0],
                f"kv-cluster {shards}: the card's answers or decisions "
                f"differ from the CPU's: {got[0]} vs {ref[0]}")
        for s, (card_st, cpu_st) in enumerate(zip(got[1], ref[1])):
            require(all(st == card_st[0] for st in card_st + cpu_st),
                    f"kv-cluster {shards}: shard s{s}'s replica stores "
                    f"differ (card or CPU)")
        clusters[f"shards_{shards}"] = {
            "answers": {k: v for k, v in got[0].items()
                        if k != "decisions"},
            "decisions": len(got[0]["decisions"]),
            "summary": got[2]}
    log_off, d_off = _kv_loopback(dev, False)
    log_on, d_on = _kv_loopback(dev, True)
    require(log_on == log_off and d_on == d_off,
            f"kv-cluster: kv changed the one-replica run: {d_on} vs {d_off}")
    waves = max(1, d_on["lanes.update_dispatches"])
    say_json("kv-cluster", replicas=3, payload_bytes=KV_CLUSTER_B,
             runs=clusters, checker_clean=True, card_equal_cpu=True,
             stores_equal=True, loopback_waves=waves,
             d2h_per_wave={"off": d_off["host.d2h_copies"] / waves,
                           "on": d_on["host.d2h_copies"] / waves},
             h2d_per_wave={"off": d_off["host.h2d_copies"] / waves,
                           "on": d_on["host.h2d_copies"] / waves},
             wall_s=time.perf_counter() - t0, card=card)

    # -- kv-bench -------------------------------------------------------------
    dump_dir = tempfile.mkdtemp(prefix="kv-")
    t0 = time.perf_counter()
    rep = kv_app.run_kv_bench(**KV_BENCH, device=str(dev),
                              dump_dir=dump_dir)
    wall = time.perf_counter() - t0
    ol = rep["open_loop"]
    require(rep["lin_ok"], f"kv-bench: not linearizable: "
                           f"{rep['violations'][:3]}")
    require(rep["shed_accounting_ok"],
            f"kv-bench: shed {rep['shed_frames']} != NACKs "
            f"{rep['nacks_accounted']}")
    require(ol["completed"] == ol["issued"] == ol["ops"],
            f"kv-bench: completed {ol['completed']} of {ol['issued']} "
            f"issued, {ol['ops']} planned")
    require(all("error" not in o for o in rep["servers"].values()),
            f"kv-bench: a shard failed: {rep['servers']}")
    g = ol["read_grades"]
    lin_p50, lease_p50 = g["lin"]["p50_ms"], g["lease"]["p50_ms"]
    # where a write's rounds end: the lane driver counts every round
    # closed on its deadline (or wait cap) and every round run, summed
    # over a shard's replicas
    rounds = {}
    for d, o in rep["servers"].items():
        rounds[d] = {
            "rounds_run": o["rounds_run"], "timeouts": o["timeouts"],
            "decided_instances": o["decided_instances"],
            "deadline_share": (round(o["timeouts"] / o["rounds_run"], 4)
                               if o["rounds_run"] else None),
            "rounds_per_instance": (
                round(o["rounds_run"] / (o["n"] * o["decided_instances"]),
                      3) if o["decided_instances"] else None)}
    say_json("kv-bench", achieved_ops=ol["achieved_ops"],
             achieved_dps=ol["achieved_dps"], offered_rate=ol["offered_rate"],
             ops=ol["ops"], completed=ol["completed"],
             write_p50_ms=ol["write_p50_ms"], write_p99_ms=ol["write_p99_ms"],
             grades={k: {"count": v["count"], "p50_ms": v["p50_ms"],
                         "p99_ms": v["p99_ms"]} for k, v in g.items()},
             lease_vs_lin_p50=(round(lin_p50 / lease_p50, 2)
                               if lin_p50 and lease_p50 else None),
             lease_served=ol["lease_served"],
             lease_fallbacks=ol["lease_fallbacks"],
             give_ups=ol["give_ups"], checked_ops=rep["checked_ops"],
             lin_ok=True, shed_accounting_ok=True,
             startup_s=rep["startup_s"], peak_gib=rep["peak_gib"],
             kv={d: o.get("kv") for d, o in rep["servers"].items()},
             rounds=rounds, bench={k: v for k, v in KV_BENCH.items()},
             wall_s=wall, open_loop_wall_s=ol["wall_s"], card=card)

    # -- kv-broken-lease ------------------------------------------------------
    t0 = time.perf_counter()
    rep = kv_app.run_kv_bench(**KV_BROKEN, device=str(dev),
                              dump_dir=dump_dir)
    kinds = sorted({v["kind"] for v in rep["violations"]})
    require(not rep["lin_ok"] and set(kinds) & {
        "non-linearizable", "stale-read-uncommitted"},
        f"kv-broken-lease: the checker missed it: {kinds}")
    art = rep.get("artifact")
    require(art and os.path.exists(art), "kv-broken-lease: no artifact")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = kv_app.main(["check", art])
    replayed = json.loads(buf.getvalue().strip().splitlines()[-1])
    require(rc == 0 and replayed["matches_expected"],
            f"kv-broken-lease: apps/kv.py check gave {rc}: {replayed}")
    say_json("kv-broken-lease", caught=True, kinds=kinds,
             violations=len(rep["violations"]),
             checked_ops=rep["checked_ops"],
             artifact=os.path.basename(art), replay_matches=True,
             lease_served=rep["open_loop"]["lease_served"],
             wall_s=time.perf_counter() - t0, card=card)


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

    clock = Clock()
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
        require(only in ("sharded", "peers", "fuzz", "runtime", "host",
                         "serve", "verify", "kv", "proof", "analysis"),
                f"unknown --only {only}")
        if only == "sharded":
            part = sharded_phases(torch, gen)
        elif only == "fuzz":
            fuzz_phases(torch, dev)
            part = []
        elif only == "runtime":
            runtime_phases(torch, dev)
            part = []
        elif only == "host":
            host_phases(torch, dev)
            part = []
        elif only == "serve":
            serve_phases(torch, dev, card)
            part = []
        elif only == "verify":
            verify_phases(torch, dev, card)
            part = []
        elif only == "kv":
            kv_phases(torch, dev, card)
            part = []
        elif only == "proof":
            proof_phases(torch, dev, card)
            part = []
        elif only == "analysis":
            analysis_phases(torch, dev, card)
            part = []
        else:
            k4_vs_plain(torch, gen)
            part = [ring_peers(torch, gen)]
        print(json.dumps({"only": only}), flush=True)
        print(card, flush=True)
        print(json.dumps({"kernels": part}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    clock("build")

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
    k2_v32_err = k2_second_pass(torch, "hash")
    k2_err = max(k2_err, k2_v32_err)
    say("K2-vs-plain", n=N, S=S_CHECK, V=f"{V},24,32",
        p8="0,1,13,64,128,255,256",
        cases="rowmask x side, plus n=1000 and n=1008, plus the public "
              "wrapper vs CPU; V=24 and 32 take a second value pass",
        tolerance=0, max_abs_err=k2_err,
        second_pass_max_abs_err=k2_v32_err, equal=True)

    clock("K2-vs-plain")

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

    clock("K1-vs-plain")

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

    clock("K1-K3-vs-plain")

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
    k2hw_v32_err = k2_second_pass(torch, "hw")
    hw_err["hist_exchange_hw"] = max(hw_err["hist_exchange_hw"],
                                     k2hw_v32_err)
    say("hw-vs-plain", n=f"{N},1000,1008", S=f"{S_CHECK},7,7",
        p8=",".join(map(str, P8_GRID)),
        cases="K2 rowmask x side at V=16, 24 and 32; K1 OTR, FloodMin V=16, "
              "Ben-Or; the public hist_exchange and otr_loop vs CPU; "
              "run_hist(hw) vs run_otr_loop(hw)", tolerance=0,
        K2_second_pass_max_abs_err=k2hw_v32_err,
        max_abs_err=json.dumps(hw_err).replace(" ", ""),
        run_hist_equals_loop=True)

    clock("probes-hw-vs-plain")

    # -- 5. the main paths, through the bench's entry point ------------------
    common = ["--n", str(N), "--phases", str(ROUNDS), "--values", str(V),
              "--p-drop", str(P_DROP), "--seed", str(SEED), "--parity", "0",
              "--device", "cuda", "--no-ladder"]
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

    clock("main-paths")

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

    clock("parity")

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

    clock("ladder")

    # -- 6b'. the fifth rung, its dry-run segment, the bench's ladder arm ---
    fused.reset_launches()
    eps_res = ladder.rung_epsilon(repeats=2, device=dev)
    eps_launches = {k: v for k, v in fused.LAUNCHES.items() if v}
    ex = eps_res["extra"]
    say("ladder-epsilon", metric=eps_res["metric"],
        rounds_per_sec=ex["rounds_per_sec"],
        wall_s_per_run=ex["wall_s_per_run"],
        frac_lanes_decided=ex["frac_lanes_decided"],
        decided_phase_p50=ex["decided_phase_p50"],
        parity_exact=ex["parity_exact"], parity_frac=ex["parity_frac"],
        property_parity=ex["property_parity"], peak_gib=ex["peak_gib"],
        sharded=str(ex["sharded"]).lower(), devices=ex["devices"],
        launches=json.dumps(eps_launches).replace(" ", ""))
    require(eps_res["metric"] == "ladder_epsilon_n1024",
            f"the ε rung ran {eps_res['metric']}")
    require(ex["parity_exact"] is True,
            "ladder rung epsilon: parity_exact is false")
    require(ex["property_parity"] is True,
            "ladder rung epsilon: property_parity is false")
    require(ex["frac_lanes_decided"] > 0, "the ε rung decided nothing")
    require(ex["sharded"] is (torch.cuda.device_count() > 1),
            "the ε rung's sharding does not follow the visible cards")
    eps_breakdown(torch, dev, ex["wall_s_per_run"], ex["rounds_per_run"])

    from round_tpu_torch.parallel import mesh as mesh_mod

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mesh_mod.dryrun_eps(2, devices=[torch.device("cuda", 0)] * 2)
    line = buf.getvalue().strip()
    say("dryrun-eps", mesh="1x2 of cuda:0", n=16, f=2, S=4, phases=8,
        wall_s=round(time.perf_counter() - t0, 2), line=json.dumps(line))
    require(line.startswith("dryrun_multichip eps-fused ok"),
            f"dryrun eps segment: {line!r}")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mesh_mod.dryrun_pbft_vc(2, devices=[torch.device("cuda", 0)] * 2)
    line = buf.getvalue().strip()
    say("dryrun-pbft-vc", mesh="1x2 of cuda:0", n=16, S=4, rounds=12,
        wall_s=round(time.perf_counter() - t0, 2), line=json.dumps(line))
    require(line.startswith("dryrun_multichip view-change family ok"),
            f"dryrun view-change segment: {line!r}")

    lite_args = ["--ladder-only", "epsilon,lv", "--lite", "--device",
                 "cuda", "--seed", str(SEED)]
    parsed = bench.parse_args(lite_args)
    order = bench.ladder_rungs(parsed, dev)
    require(parsed.no_ladder and order == ["lv", "epsilon"],
            f"--ladder-only under --lite runs {order}")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lite = bench.main(lite_args)
    printed = [json.loads(ln) for ln in buf.getvalue().splitlines()
               if ln.startswith("{")]
    metrics = [r["metric"] for r in printed]
    say("bench-ladder", args=json.dumps(" ".join(lite_args)),
        precedence="--ladder-only over --lite's implied --no-ladder",
        lines=json.dumps(metrics).replace(" ", ""),
        lite_rounds_per_sec=lite["value"],
        extrapolated_flagship_rps=lite["extra"][
            "extrapolated_flagship_rps"],
        lv_rounds_per_sec=printed[1]["extra"]["rounds_per_sec"]
        if len(printed) > 1 else None,
        epsilon_rounds_per_sec=printed[2]["extra"]["rounds_per_sec"]
        if len(printed) > 2 else None,
        wall_s=round(time.perf_counter() - t0, 1))
    require(metrics == [f"otr_n{N}_s1000_rounds_per_sec", "ladder_lv_n256",
                        "ladder_epsilon_n1024"],
            f"bench --ladder-only epsilon,lv --lite printed {metrics}")
    require(printed[0] == lite and lite["extra"]["lite"] is True,
            "bench.main did not return the flagship's line")
    require(printed[1]["extra"]["parity_frac"] == 1.0
            and printed[2]["extra"]["parity_exact"] is True,
            "a rung of the bench's ladder arm lost parity")

    event_models(torch, dev)

    clock("epsilon-dryrun-bench-ladder")

    # -- 6b'. the fault-schedule fuzzer (no kernel of its own) ---------------
    fuzz_phases(torch, dev)

    clock("fuzz")

    # -- 6b'. the in-process runtime (no kernel of its own) ------------------
    runtime_phases(torch, dev)

    clock("runtime")

    # -- 6b'. the wire and the host runner (no kernel of their own) ----------
    host_phases(torch, dev)

    clock("host")

    # -- 6b'. the lane driver and the fleet (no kernel of their own) ---------
    serve_phases(torch, dev, card)

    clock("serve")

    # -- 6b'. the verification plane (no kernel of its own) ------------------
    verify_phases(torch, dev, card)

    clock("verify")

    # -- 6b'. the replicated key-value store (no kernel of its own) ----------
    kv_phases(torch, dev, card)

    clock("kv")

    # -- 6b'. the verifier (host Python and rtsat, no kernel) -----------------
    proof_phases(torch, dev, card)

    clock("proof")

    # -- 6b'''. the analysis tier (host Python and traces, no kernel) ---------
    analysis_phases(torch, dev, card)

    clock("analysis")

    # -- 6b''. the last histogram slice's engines at their users' widths ----
    kset_launches = families_wide(torch, dev)

    clock("families-wide")

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

    clock("bisect")

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
    # the plain versions on the first S_PLAIN_HASH and S_PLAIN_HW
    # scenarios (each scenario's run depends on its own row alone)
    cut = slice(0, S_PLAIN_HASH)
    (k1_plain_ms, plain), plain_smi = sampled(lambda: plain_ms(
        lambda: fused._hist_loop_plain(algo, *(a[cut] for a in args),
                                       ROUNDS, "hash")), 500)
    compare(f"K1 at the flagship shape (first {S_PLAIN_HASH} scenarios)",
            [o[cut] for o in out], plain)
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
            plain_scenarios=S_PLAIN_HW if o is out_hw else S_PLAIN_HASH,
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
    # the launch floor, the least card time a launch takes: a one-thread
    # kernel with no cycles to spin, queued the same way
    floor_ms = queued_ms(torch, lambda: torch.cuda._sleep(0), 100)
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
        bound_by=p1_by, launch_floor_ms=round(floor_ms, 5),
        of_floor=round(p1_ms / floor_ms, 3))
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
        bound_by=p2_by, pipe=p2_pipe, launch_floor_ms=round(floor_ms, 5),
        of_floor=round(p2_ms / floor_ms, 3))
    host_breakdown(torch, x)

    clock("kernel-times")

    # -- 8. K4 and the sharded paths ------------------------------------------
    ring_kernels = sharded_phases(torch, gen)

    kernels = [
        {"name": "otr_loop", "route": "cuda",
         "source": "round_tpu_torch/csrc/hist_loop.cu",
         "replaces": "round_tpu/ops/fused.py:557",
         "launches": k1_launches, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms,
         "plain_scenarios": S_PLAIN_HASH, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "hist_exchange", "route": "cuda",
         "source": "round_tpu_torch/csrc/hist_exchange.cu",
         "replaces": "round_tpu/ops/fused.py:167",
         "launches": k2_launches, "max_abs_err": k2_err,
         "kset_launches": kset_launches["hist_exchange"],
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
         "kset_launches": kset_launches["hist_exchange_hw"],
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
    clock("sharded")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
