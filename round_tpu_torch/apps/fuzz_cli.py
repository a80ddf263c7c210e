"""fuzz_cli — coverage-guided fault-schedule search, minimization, replay.

Usage:
  python -m round_tpu_torch.apps.fuzz_cli search --algo otr --n 4 --rounds 12 \\
      --pop 1024 --generations 30 [--objective undecided|delay|safety] \\
      [--value-cap F] [--liar-seeds F] \\
      [--minimize] [--out artifact.json] [--host-record] [--time-box-s 60]
  python -m round_tpu_torch.apps.fuzz_cli crosscheck --algo otr --n 4 \\
      [--schedules 10000] [--bank DIR] [--host-record]
  python -m round_tpu_torch.apps.fuzz_cli replay --artifact artifact.json \\
      [--engine] [--host] [--processes]
  python -m round_tpu_torch.apps.fuzz_cli hostile [--frames 10000] [--seed 0]

`search` evolves fault schedules against one protocol on the batched
engine (round_tpu/fuzz, docs/FUZZING.md), optionally delta-debugs the best
finding to a minimal reproducer and exports it as a schedule artifact.
With --host-record the exported artifact also banks the real-wire outcome
(an in-process socket cluster), making it a self-checking regression.

`crosscheck` runs the proof/fuzzer cross-check (byz/): an
in-envelope sweep that must stay safety-violation-free and a
past-envelope sweep judged by the protocol's adversary model, with the
minimized equivocation counterexample optionally banked (--bank).

`replay` re-runs an artifact and exits nonzero if any recorded outcome
stops reproducing — the regression-bank check (tests/regressions/).

`hostile` runs the hostile-wire fuzz gate (fuzz/hostile.py):
structure-aware mutated frames against the Python codec, the FLAG_BATCH
splitter and the C pump parser, exiting nonzero unless every frame is
accounted (consumed or counted in wire.hostile_rejected) with no crash.

Port of round_tpu/apps/fuzz_cli.py.  `search`, `crosscheck` and `replay`
take `--device` (default cuda; where the card is absent they raise): the
batched evaluator and the host replays' replicas run there.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _objective(name: str, horizon: int, n: int):
    from round_tpu_torch.fuzz import objectives

    if name == "undecided":
        return objectives.undecided_at_horizon(min_lanes=1)
    if name == "all-undecided":
        return objectives.undecided_at_horizon(min_lanes=n)
    if name == "delay":
        return objectives.decision_delayed(min_round=horizon // 2)
    if name == "safety":
        return objectives.safety_violated()
    raise ValueError(f"unknown objective {name!r}")


def _cmd_search(args) -> int:
    from round_tpu_torch.fuzz import genome
    from round_tpu_torch.fuzz import minimize as fmin
    from round_tpu_torch.fuzz import replay
    from round_tpu_torch.fuzz.search import make_target, search

    target = make_target(args.algo, n=args.n, horizon=args.rounds,
                         seed=args.seed,
                         values=(np.array([int(v) for v in
                                           args.values.split(",")])
                                 if args.values else None),
                         device=args.device)
    pred = _objective(args.objective, target.horizon, target.n)
    log = (lambda m: print(m, file=sys.stderr)) if not args.quiet else None
    seeds = None
    value_cap = args.value_cap
    if args.liar_seeds > 0:
        from round_tpu_torch.byz.crosscheck import liar_rows

        seeds = liar_rows(target.n, target.horizon, args.liar_seeds,
                          seed=args.seed)
        if value_cap is None:
            # seeding liars implies opting into the value family —
            # otherwise mutate's benign default would scrub the seeds
            value_cap = args.liar_seeds
    res = search(target, pop_size=args.pop, generations=args.generations,
                 seed=args.seed, time_box_s=args.time_box_s,
                 value_cap=value_cap, seed_rows=seeds,
                 stop_when=pred if args.stop_on_hit else None, log_fn=log)
    # "hit" gates minimization, so it must describe the row minimize will
    # run on — the best-EVER genome, which a time-boxed or coverage-mode
    # search may have bred OUT of the final population (and conversely
    # the last generation may hit where the best-by-score row does not)
    best_out = target.evaluate(
        genome.Population.from_rows([res.best_row]))
    hit = bool(pred(best_out)[0])
    summary = {
        "algo": args.algo, "n": target.n, "rounds": target.horizon,
        "pop": args.pop, "generations": res.generations,
        "evaluated": res.evaluated,
        "schedules_per_sec": round(res.schedules_per_sec, 1),
        "best_score": round(res.best_score, 4),
        "best_outcome": res.best_outcome,
        "coverage_cells": int(res.coverage_map.sum()),
        "coverage_total": target.n_cells,
        "objective": getattr(pred, "__name__", str(pred)),
        "hit": hit,
    }
    if args.minimize or args.out:
        if not summary["hit"]:
            print(json.dumps({**summary, "error":
                              "objective never satisfied; nothing to "
                              "minimize/export"}))
            return 1
        mr = fmin.minimize(target, res.best_row, pred, log_fn=log)
        summary["dropped_links"] = {"initial": mr.dropped_initial,
                                    "minimal": mr.dropped_final}
        summary["value_events"] = {"initial": mr.value_initial,
                                   "minimal": mr.value_final}
        if args.out:
            art = replay.make_artifact(
                protocol=args.algo, schedule=mr.schedule,
                values=target.init_values, seed=args.seed,
                value_plan=mr.value_plan,
                meta={"objective": summary["objective"],
                      "generations": res.generations,
                      "search_seed": args.seed,
                      "best_score": summary["best_score"]})
            art["expected"]["engine"] = replay.replay_engine(
                art, device=args.device)
            if args.host_record:
                art["expected"]["host"] = replay.replay_host_threads(
                    art, timeout_ms=args.host_timeout_ms,
                    device=args.device)
            replay.dump_artifact(args.out, art)
            summary["artifact"] = args.out
            summary["expected"] = art["expected"]
    print(json.dumps(summary))
    return 0


def _cmd_replay(args) -> int:
    import tempfile

    from round_tpu_torch.fuzz import replay

    art = replay.load_artifact(args.artifact)
    out = {"artifact": args.artifact, "protocol": art["protocol"],
           "n": art["n"], "rounds": art["rounds"],
           "drops": len(art.get("drops", [])),
           "value_subs": len(art.get("value_subs", [])),
           "stale_subs": len(art.get("stale_subs", []))}
    rc = 0
    if args.engine or not (args.host or args.processes):
        ok, got = replay.check_engine(art, device=args.device)
        out["engine"] = {"ok": ok, "got": got}
        rc |= 0 if ok else 1
    if args.host:
        ok, got = replay.check_host(art, timeout_ms=args.host_timeout_ms,
                                    device=args.device)
        out["host"] = {"ok": ok, "got": got}
        rc |= 0 if ok else 1
    if args.processes:
        with tempfile.TemporaryDirectory() as d:
            got = replay.run_schedule_cluster(
                d, args.artifact, timeout_ms=args.host_timeout_ms,
                device=args.device)
        got = {k: got[k] for k in ("decided", "decision", "rounds")}
        want = art.get("expected", {}).get("host")
        ok = want is not None and got == want
        out["processes"] = {"ok": ok, "got": got}
        rc |= 0 if ok else 1
    print(json.dumps(out))
    return rc


def _cmd_crosscheck(args) -> int:
    from round_tpu_torch.byz.crosscheck import crosscheck

    log = (lambda m: print(m, file=sys.stderr)) if not args.quiet else None
    res = crosscheck(args.algo, args.n, min_schedules=args.schedules,
                     pop_size=args.pop, seed=args.seed,
                     time_box_s=args.time_box_s, bank_dir=args.bank,
                     host_record=args.host_record, log_fn=log,
                     device=args.device)
    print(json.dumps(res.record()))
    return 0 if res.ok else 1


def _cmd_hostile(args) -> int:
    from round_tpu_torch.fuzz.hostile import run_gate

    out = run_gate(args.frames, seed=args.seed)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fuzz_cli", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("search", help="evolve fault schedules")
    s.add_argument("--algo", default="otr")
    s.add_argument("--n", type=int, default=4)
    s.add_argument("--rounds", type=int, default=12,
                   help="schedule horizon in rounds (rounded up to whole "
                        "phases)")
    s.add_argument("--pop", type=int, default=1024)
    s.add_argument("--generations", type=int, default=30)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--values", type=str, default=None,
                   help="comma-separated per-process proposals")
    s.add_argument("--objective",
                   choices=["undecided", "all-undecided", "delay",
                            "safety"],
                   default="undecided")
    s.add_argument("--no-stop-on-hit", dest="stop_on_hit",
                   action="store_false", default=True,
                   help="keep searching after the objective is first "
                        "satisfied (coverage mode)")
    s.add_argument("--time-box-s", type=float, default=None)
    s.add_argument("--minimize", action="store_true")
    s.add_argument("--out", type=str, default=None, metavar="ARTIFACT",
                   help="export the minimized finding (implies --minimize)")
    s.add_argument("--host-record", action="store_true",
                   help="also bank the real-wire outcome in the artifact")
    s.add_argument("--host-timeout-ms", type=int, default=250)
    s.add_argument("--value-cap", type=int, default=None,
                   help="max byzantine-VALUE adversaries per genome "
                        "(byz/).  Default: value family OFF "
                        "(the benign search) unless --liar-seeds "
                        "opts in; pass (n-1)//3 for the envelope cap")
    s.add_argument("--liar-seeds", type=int, default=0, metavar="F",
                   help="seed the population with F-liar genomes "
                        "(byz/crosscheck.liar_rows) so the value "
                        "adversary needn't evolve from zero")
    s.add_argument("--quiet", action="store_true")
    s.add_argument("--device", default="cuda",
                   help="where the evaluator and replicas run")
    s.set_defaults(fn=_cmd_search)

    c = sub.add_parser(
        "crosscheck",
        help="proof/fuzzer cross-check: in/past-envelope sweeps "
             "(byz/crosscheck.py)")
    c.add_argument("--algo", default="otr")
    c.add_argument("--n", type=int, default=4)
    c.add_argument("--schedules", type=int, default=10_000,
                   help="minimum schedules the in-envelope sweep must "
                        "clear violation-free")
    c.add_argument("--pop", type=int, default=512)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--time-box-s", type=float, default=None)
    c.add_argument("--bank", type=str, default=None, metavar="DIR",
                   help="bank a minimized past-envelope counterexample "
                        "artifact under DIR")
    c.add_argument("--host-record", action="store_true",
                   help="also bank the real-wire outcome in the artifact")
    c.add_argument("--quiet", action="store_true")
    c.add_argument("--device", default="cuda",
                   help="where the evaluator and replicas run")
    c.set_defaults(fn=_cmd_crosscheck)

    h = sub.add_parser("hostile", help="hostile-wire fuzz gate")
    h.add_argument("--frames", type=int, default=10_000)
    h.add_argument("--seed", type=int, default=0)
    h.set_defaults(fn=_cmd_hostile)

    r = sub.add_parser("replay", help="re-run an artifact, verify outcomes")
    r.add_argument("--artifact", required=True)
    r.add_argument("--engine", action="store_true",
                   help="engine replay (the default when no surface given)")
    r.add_argument("--host", action="store_true",
                   help="in-process socket-cluster replay")
    r.add_argument("--processes", action="store_true",
                   help="multi-process host_replica cluster replay")
    r.add_argument("--host-timeout-ms", type=int, default=250)
    r.add_argument("--device", default="cuda",
                   help="where the evaluator and replicas run")
    r.set_defaults(fn=_cmd_replay)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
