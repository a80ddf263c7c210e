"""The BASELINE config ladder on the card: four benchmark rungs mirroring
the reference's test scripts, each timed and checked in the same run.

Port of round_tpu/apps/ladder.py.  Each rung reports rounds/sec plus
lane-exact differential parity against the general engine and
invariant/property parity from the spec checker (round_tpu_torch.spec), in
the reference's metric names and ``extra`` keys:

  otr4      ladder_otr_n4        OTR n=4, 1 scenario (testOTR.sh) on the
                                 general engine, plus the same shape on the
                                 whole-run OTR kernel (K1 otr_loop)
  floodmin  ladder_floodmin_n64  FloodMin n=64 x 256 crash-f scenarios,
                                 V=1000, on K1 floodmin_loop
  lv        ladder_lv_n256       LastVoting n=256 x 256 crash-f scenarios,
                                 4 phases, on K3 lv_loop (testLV.sh)
  benor     ladder_benor_n512    Ben-Or n=512 x 4096 omission scenarios
                                 (p_drop 0.05), 8 phases, on K1 benor_loop
                                 (testBenOr.sh)

    python -m round_tpu_torch.apps.ladder [--only lv,benor] [--device cuda]
        [--n N --scenarios S]    # one JSON line per rung

The reference's fifth rung, ε-agreement (``rung_epsilon``), is absent: it
runs engine/epsfast.py and ops/detsum.py, which are not ported yet
(ROADMAP Queue 1, item 11).

Link streams, as in the reference: the timed runs draw their links in
``mode="hw"`` on the card (the Philox stream of ops.fused, in the place of
the TPU's hardware PRNG) and in ``mode="hash"`` on the CPU; the parity and
spec checks replay the warm-up draw in hash mode, the one stream the
general engine reproduces.  Only otr4's kernel part (p8=26) and benor
(p8=13) draw links; floodmin and lv run p8=0, and lv is hash-only, as
round_tpu's ``lv_loop``.

Differences from the reference, on purpose:
  - the parity replays run the timed whole-run kernel in hash mode (the
    reference replays through the per-round engine, which agrees with it
    bit for bit);
  - nothing falls back: a rung whose kernel or check fails raises (no loop
    to per-round degradation, no general-engine stand-in for lv_loop, no
    caught-and-recorded rung failure, no time budget that skips rungs);
  - random draws (fault mixes, initial values) come from a
    ``torch.Generator`` seeded per repeat, not from threefry keys.

Timing: CUDA events around a run that ends in an on-device reduction to an
O(1) summary (``decided_summary``); only the summary is copied to the host
(``bench.timed``).
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from typing import Any, Callable, Dict, List, Optional

import torch

from round_tpu_torch.bench import card_info, timed
from round_tpu_torch.engine import fast, scenarios
from round_tpu_torch.engine.executor import (
    LocalTopology, init_lanes, run_instance,
)
from round_tpu_torch.models.benor import BenOr, BenOrState
from round_tpu_torch.models.common import consensus_io
from round_tpu_torch.models.floodmin import FloodMin, FloodMinState
from round_tpu_torch.models.lastvoting import LastVoting
from round_tpu_torch.models.otr import OTR, OtrState
from round_tpu_torch.ops import fused
from round_tpu_torch.ops.mailbox import first_true
from round_tpu_torch.spec import check_trace, replay_ho
from round_tpu_torch.utils.benchstat import decided_summary, speed_extra
from round_tpu_torch.utils.device import resolve_device


def _gen(seed: int, dev) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _timed_mode(dev) -> str:
    """The link stream of the timed runs: "hw" on the card, "hash" on the
    CPU (round_tpu/apps/ladder.py: ``"hash" if interpret else "hw"``)."""
    return "hash" if dev.type == "cpu" else "hw"


def _time_best(fn: Callable[[int], Any], repeats: int, dev):
    """(best seconds over seeds 0..repeats-1, that run's host copy of the
    summary) after one warm-up call (builds the kernels)."""
    timed(lambda: fn(0), dev)
    best = out = None
    for seed in range(repeats):
        secs, got = timed(lambda: fn(seed), dev)
        if best is None or secs < best:
            best, out = secs, got
    return best, out


def _parity_trace(algo, io, n, key, sampler, phases, rounds_per_phase, dev):
    """One recorded scenario through the spec checker
    (round_tpu/apps/ladder.py::_parity_trace).  ``key`` is the port's
    ``(salt0, salt1)`` scenario key."""
    res = run_instance(algo, io, n, key, sampler, phases,
                       record_fn=lambda s, d, r: s, device=dev)
    state0 = init_lanes(algo, io, n, LocalTopology(n, dev))
    ho = replay_ho(key, sampler, res.rounds_run)
    rep = check_trace(algo.spec, res.recorded, state0, n, ho=ho,
                      rounds_per_phase=rounds_per_phase)
    return res, rep


def _spec_parity(algo, io, n, sampler, phases, rounds_per_phase, traces,
                 dev):
    """(invariant parity, property parity) over `traces` recorded
    scenarios with keys (t, 0)."""
    inv_ok = prop_ok = True
    for t in range(traces):
        _res, rep = _parity_trace(algo, io, n, (t, 0), sampler, phases,
                                  rounds_per_phase, dev)
        inv_ok &= bool(rep.any_invariant.all())
        prop_ok &= bool(rep.all_safety_properties_hold())
    return inv_ok, prop_ok


def _diff_parity(state, dround, mix, make_algo, io, n, phases, fields, k,
                 dev) -> float:
    """Lane-exact differential parity (round_tpu/apps/ladder.py::
    _diff_parity): fraction of lanes over the first k scenarios where the
    fused outputs equal the general engine replaying the same FaultMix row
    (keys (s, 0))."""
    agree = total = 0
    for s in range(k):
        res = run_instance(make_algo(s), io, n, (s, 0),
                           scenarios.from_mix_row(mix, s), phases,
                           device=dev)
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        for name in fields:
            ok &= getattr(state, name)[s] == getattr(res.state, name)
        ok &= dround[s] == res.decided_round
        agree += int(ok.sum())
        total += n
    return agree / max(total, 1)


def _crash_mix(gen: torch.Generator, S: int, n: int, f: int,
               dev) -> fast.FaultMix:
    """f crash-stop processes per scenario, silent from round 0 — the
    FaultMix form of scenarios.crash (round_tpu/apps/ladder.py::_crash_mix;
    the permutation comes from `gen`, not from threefry)."""
    mix = fast.fault_free(gen, S, n, device=dev)
    perm = torch.argsort(torch.rand((S, n), generator=gen, device=dev), dim=1)
    return mix.replace(crashed=perm < f)


# ---------------------------------------------------------------------------
# rung bodies: the timed computation, mix -> engine -> outputs
# ---------------------------------------------------------------------------

def floodmin_body(mix: fast.FaultMix, init: torch.Tensor, f: int, V: int,
                  rounds: int, mode: str):
    """FloodMin's whole run on K1 (run_floodmin_loop) in `mode`.  Returns
    ((cnt, hist, checksum), state, decided_round)."""
    S, n = mix.crashed.shape
    state, _done, dround = fast.run_floodmin_loop(
        fast.FloodMinHist(n_values=V, f=f), FloodMinState.fresh(init, S, n),
        mix, max_rounds=rounds, mode=mode)
    return (decided_summary(state.decided, dround, rounds, state.decision),
            state, dround)


def lv_body(mix: fast.FaultMix, init: torch.Tensor, rounds: int):
    """LastVoting's whole run on K3 (lv_loop).  Returns
    ((cnt, hist, checksum), state, decided_round); `state` has the seven
    LVState fields."""
    S, n = mix.crashed.shape
    x0 = init.to(torch.int32).expand(S, n).contiguous()
    (x, ts, ready, commit, vote, decided, decision, _done,
     dround) = fused.lv_loop(x0, *fast._mix_args(mix), rounds=rounds)
    state = types.SimpleNamespace(x=x, ts=ts, ready=ready, commit=commit,
                                   vote=vote, decided=decided,
                                   decision=decision)
    return (decided_summary(decided, dround, rounds, decision), state,
            dround)


def benor_body(mix: fast.FaultMix, init: torch.Tensor, rounds: int,
               mode: str):
    """Ben-Or's whole run on K1 (run_benor_loop) in `mode`.  Returns
    ((cnt, hist, checksum), state, decided_round)."""
    S, n = mix.crashed.shape
    state, _done, dround = fast.run_benor_loop(
        fast.BenOrHist(), BenOrState.fresh(init, S, n), mix,
        max_rounds=rounds, mode=mode)
    summary = decided_summary(state.decided, dround, rounds,
                              state.decision.to(torch.int32))
    return summary, state, dround


def benor_mix(gen: torch.Generator, S: int, n: int, p_drop: float,
              dev) -> fast.FaultMix:
    """The Ben-Or rung's iid-omission mix: fault-free plus p8 = p_drop·256."""
    mix = fast.fault_free(gen, S, n, device=dev)
    return mix.replace(p8=torch.full((S,), max(1, round(p_drop * 256)),
                                     dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# the rungs
# ---------------------------------------------------------------------------

def rung_otr4(repeats: int = 2, device=None) -> Dict[str, Any]:
    """OTR at testOTR.sh's shape on the general engine, spec-checked, and
    the same shape on the whole-run OTR kernel with lane-exact parity
    (round_tpu/apps/ladder.py::rung_otr4)."""
    dev = resolve_device(device)
    n, S, phases = 4, 1, 6
    algo = OTR()
    sampler = scenarios.omission(n, 0.1, device=dev)

    def bench(seed):
        gen = _gen(seed, dev)
        decided, dround = [], []
        for s in range(S):
            init = torch.randint(0, 3, (n,), generator=gen, device=dev,
                                 dtype=torch.int32)
            res = run_instance(algo, consensus_io(init), n, (s, seed),
                               sampler, phases, device=dev)
            decided.append(algo.decided(res.state))
            dround.append(res.decided_round)
        return decided_summary(torch.stack(decided), torch.stack(dround),
                               phases)

    rounds = phases * algo.rounds_per_phase
    best, (cnt, hist) = _time_best(bench, repeats, dev)
    inv_ok, prop_ok = _spec_parity(
        algo, consensus_io(torch.arange(n, device=dev) % 3), n, sampler,
        phases, 1, 4, dev)
    # the general engine's histogram is in phase units (decided phase)
    extra = speed_extra(best, rounds, cnt, hist, n * S,
                        p50_key="decided_phase_p50")
    extra.update({"invariant_parity": inv_ok, "property_parity": prop_ok})

    # the same shape on the flagship loop kernel, timed in the ladder's
    # mode and parity-checked on a hash-mode replay
    V = 3
    rnd = fast.OtrHist(n_values=V, after_decision=2)
    p8 = max(1, round(0.1 * 256))
    mode = _timed_mode(dev)

    def loop_run(seed, run_mode):
        gen = _gen(seed, dev)
        mix = fast.fault_free(gen, S, n, device=dev).replace(
            p8=torch.full((S,), p8, dtype=torch.int32, device=dev))
        init = torch.randint(0, V, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        state, _done, dround = fast.run_otr_loop(
            rnd, OtrState.fresh(init, S, n), mix, max_rounds=phases,
            mode=run_mode)
        return state, dround, mix, init

    def loop_bench(seed):
        state, dround, _mix, _init = loop_run(seed, mode)
        return decided_summary(state.decided, dround, phases, state.decision)

    lbest, _ = _time_best(loop_bench, repeats, dev)
    state, dround, mix, init = loop_run(0, "hash")
    extra["loop_rounds_per_sec"] = round(rounds / lbest, 1)
    extra["loop_parity_frac"] = _diff_parity(
        state, dround, mix, lambda s: OTR(), consensus_io(init), n, phases,
        ("x", "decided", "decision"), S, dev)
    return {"metric": "ladder_otr_n4", "extra": extra}


def rung_floodmin(repeats: int = 2, n: int = 64, S: int = 256,
                  device=None) -> Dict[str, Any]:
    """FloodMin on the whole-run kernel under the crash-f FaultMix family,
    with lane-exact parity against the general engine and crash-tolerant
    agreement/validity over every scenario — testFloodMin.sh's shape
    (round_tpu/apps/ladder.py::rung_floodmin)."""
    dev = resolve_device(device)
    f = 2
    rounds = f + 2  # 1 round per phase
    V = 1000

    def draw(seed):
        gen = _gen(seed, dev)
        mix = _crash_mix(gen, S, n, f, dev)
        init = torch.randint(0, V, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        return mix, init

    mode = _timed_mode(dev)
    best, (cnt, hist, _ck) = _time_best(
        lambda seed: floodmin_body(*draw(seed), f, V, rounds, mode)[0],
        repeats, dev)

    # parity and safety on a hash-mode replay of the warm-up draw
    mix, init = draw(0)
    _summary, state, dround = floodmin_body(mix, init, f, V, rounds, "hash")
    parity_frac = _diff_parity(
        state, dround, mix, lambda s: FloodMin(f), consensus_io(init), n,
        rounds, ("x", "decided", "decision"), min(16, S), dev)
    alive = ~mix.crashed
    dec = state.decision
    lo = torch.where(alive, dec, torch.iinfo(torch.int32).max).min(1).values
    hi = torch.where(alive, dec, torch.iinfo(torch.int32).min).max(1).values
    ok = bool(state.decided.all()) and bool((lo == hi).all())
    ok &= bool(torch.isin(dec[state.decided], init).all())
    extra = speed_extra(best, rounds, cnt, hist, n * S)
    extra.update({
        "f": f, "engine": "loop", "parity_frac": round(parity_frac, 4),
        "property_parity": ok,
    })
    return {"metric": f"ladder_floodmin_n{n}", "extra": extra}


def rung_lv(repeats: int = 2, n: int = 256, S: int = 256,
            device=None) -> Dict[str, Any]:
    """LastVoting on its whole-run kernel (K3 lv_loop: O(n) hashes per
    round) under the crash-f FaultMix family, with lane-exact parity
    against the general engine and the spec-checker invariant run — the
    testLV.sh analogue (round_tpu/apps/ladder.py::rung_lv)."""
    dev = resolve_device(device)
    phases = 4
    rounds = 4 * phases
    f = max(1, n // 32)

    def draw(seed):
        gen = _gen(seed, dev)
        mix = _crash_mix(gen, S, n, f, dev)
        init = torch.randint(0, 64, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        return mix, init

    best, (cnt, hist, _ck) = _time_best(
        lambda seed: lv_body(*draw(seed), rounds)[0], repeats, dev)

    mix, init = draw(0)
    _summary, state, dround = lv_body(mix, init, rounds)
    parity_frac = _diff_parity(
        state, dround, mix, lambda s: LastVoting(), consensus_io(init), n,
        phases, ("x", "ts", "ready", "commit", "vote", "decided", "decision"),
        min(16, S), dev)
    inv_ok, prop_ok = _spec_parity(
        LastVoting(), consensus_io(torch.arange(n, device=dev) % 64), n,
        scenarios.crash(n, f, device=dev), phases, 4, 2, dev)
    extra = speed_extra(best, rounds, cnt, hist, n * S)
    extra.update({
        "f": f, "engine": "loop", "parity_frac": round(parity_frac, 4),
        "invariant_parity": inv_ok, "property_parity": prop_ok,
    })
    return {"metric": f"ladder_lv_n{n}", "extra": extra}


def rung_benor(repeats: int = 2, n: int = 512, S: int = 4096,
               device=None) -> Dict[str, Any]:
    """Ben-Or on the whole-run kernel (two subrounds per phase and the
    deterministic hash coin) under the iid-omission family, with lane-exact
    parity against the general engine replaying the same masks and coins,
    agreement over every scenario, and the spec-checker run —
    testBenOr.sh's shape (round_tpu/apps/ladder.py::rung_benor)."""
    dev = resolve_device(device)
    phases = 8
    rounds = 2 * phases
    p_drop = 0.05

    def draw(seed):
        gen = _gen(seed, dev)
        mix = benor_mix(gen, S, n, p_drop, dev)
        # near-even binary split: the hard randomized-consensus instance
        init = torch.rand((n,), generator=gen, device=dev) < 0.5
        return mix, init

    mode = _timed_mode(dev)
    best, (cnt, hist, _ck) = _time_best(
        lambda seed: benor_body(*draw(seed), rounds, mode)[0], repeats, dev)

    # parity (masks and coins) and agreement on a hash-mode replay of the
    # warm-up draw
    mix, init = draw(0)
    _summary, state, dround = benor_body(mix, init, rounds, "hash")
    parity_frac = _diff_parity(
        state, dround, mix,
        lambda s: BenOr(coin_salt=(int(mix.salt0[s]), int(mix.salt1[s]))),
        consensus_io(init), n, phases,
        ("x", "can_decide", "vote", "decided", "decision"), min(16, S), dev)
    # agreement over all S scenarios: every decided lane matches the
    # scenario's first decided lane
    ref = state.decision.gather(1, first_true(state.decided)[:, None])
    agree_ok = not bool((state.decided & (state.decision != ref)).any())
    inv_ok, prop_ok = _spec_parity(
        BenOr(), consensus_io(torch.arange(n, device=dev) % 2), n,
        scenarios.omission(n, p_drop, device=dev), phases, 2, 2, dev)
    extra = speed_extra(best, rounds, cnt, hist, n * S)
    extra.update({
        "engine": "loop", "parity_frac": round(parity_frac, 4),
        "agreement_parity": agree_ok,
        "invariant_parity": inv_ok, "property_parity": prop_ok,
    })
    return {"metric": f"ladder_benor_n{n}", "extra": extra}


RUNGS = {
    "otr4": rung_otr4,
    "floodmin": rung_floodmin,
    "lv": rung_lv,
    "benor": rung_benor,
}


def run_ladder(only: Optional[List[str]] = None, repeats: int = 2,
               device=None, n: Optional[int] = None,
               S: Optional[int] = None) -> List[Dict[str, Any]]:
    """Run the rungs in order (round_tpu/apps/ladder.py::run_ladder without
    its crash isolation: a failing rung raises).  `n` and `S` override the
    sizes of the floodmin, lv and benor rungs (otr4 keeps 4 x 1)."""
    unknown = set(only or ()) - set(RUNGS)
    if unknown:
        raise ValueError(f"unknown rungs {sorted(unknown)}; "
                         f"known: {sorted(RUNGS)}")
    sizes = {k: v for k, v in (("n", n), ("S", S)) if v is not None}
    out = []
    for name, fn in RUNGS.items():
        if only and name not in only:
            continue
        kw = {} if name == "otr4" else sizes
        out.append(fn(repeats=repeats, device=device, **kw))
    return out


def main(argv=None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma-separated rungs (otr4,floodmin,lv,benor)")
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None,
                    help="group size of the floodmin/lv/benor rungs")
    ap.add_argument("--scenarios", type=int, default=None,
                    help="scenarios of the floodmin/lv/benor rungs")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    only = [s for s in args.only.split(",") if s] or None
    card = card_info() if dev.type == "cuda" else {}
    results = run_ladder(only, args.repeats, dev, args.n, args.scenarios)
    for res in results:
        res["extra"].update({"backend": dev.type, **card})
        print(json.dumps(res), flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
