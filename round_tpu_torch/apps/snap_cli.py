"""Offline cut auditing: the standalone face of round_tpu_torch/snap.

Port of round_tpu/apps/snap_cli.py: the same subcommands and report;
the batched evaluator runs on ``--device`` (default cuda; where the card
is absent it raises).  Cuts banked by either package load in the other.

Banked ``.snapcut`` files (host_replica --snap-bank / fleet serve
--snap-bank, snap/collect.py bank_cut) are complete round-consistent
global states — everything the live collector audits, on disk.  This
CLI re-runs the SAME batched evaluator over them after the fact:

    # audit every banked cut of a run (one dispatch per pow2 batch —
    # the live auditor's exact verdict path)
    python -m round_tpu_torch.apps.snap_cli audit snap_bank/ --algo otr

    # inspect one cut: coordinate, contributors, digest vector
    python -m round_tpu_torch.apps.snap_cli show snap_bank/cut-e0-i3-r4.snapcut

    # divergence forensics: which replicas' digests changed between two
    # cuts of one instance (the round a state trajectory forked)
    python -m round_tpu_torch.apps.snap_cli diff A.snapcut B.snapcut

``audit`` exits nonzero when any formula fails, printing one JSON
report; with ``--dump-dir`` each violation also becomes a fuzz-replay
artifact through the shared rv/dump.py pipeline, exactly like a live
trip.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cut_paths(args_paths):
    paths = []
    for p in args_paths:
        if os.path.isdir(p):
            paths.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.endswith(".snapcut")))
        else:
            paths.append(p)
    if not paths:
        raise SystemExit("no .snapcut files found")
    return paths


def audit_main(args) -> int:
    from round_tpu_torch.apps.selector import select
    from round_tpu_torch.snap.audit import (
        SnapConfig, SnapRuntime, audit_program,
    )
    from round_tpu_torch.snap.collect import load_cut

    paths = _cut_paths(args.cuts)
    cuts, protos = [], set()
    for p in paths:
        cut, proto = load_cut(p)
        cuts.append((p, cut))
        if proto:
            protos.add(proto)
    proto = args.algo or (protos.pop() if len(protos) == 1 else None)
    if proto is None:
        raise SystemExit(
            "cut files carry no (single) protocol name; pass --algo")
    algo = select(proto)
    cfg = SnapConfig(policy="log", protocol=proto,
                     dump_dir=args.dump_dir)
    # a bank dir can legitimately span a membership resize (the
    # collector keeps banking across epoch moves at the new n), so FULL
    # cuts audit grouped by their OWN n — pinning everything to the
    # first cut's n would silently exclude every other group from the
    # audit while the report read clean
    by_n = {}
    partial = 0
    for p, c in cuts:
        if c.full:
            by_n.setdefault(c.n, []).append((p, c))
        else:
            partial += 1
    report = {"cuts": len(cuts), "protocol": proto,
              "ns": sorted(by_n), "audited": 0,
              "partial_skipped": partial, "geometry_skipped": 0,
              "violations": [], "artifacts": []}
    rt = SnapRuntime(cfg, node=-1, n=0, seed=args.seed,
                     max_rounds=args.max_rounds, device=args.device)
    for n in sorted(by_n):
        prog = audit_program(algo, n, device=args.device)
        if prog is None:
            report["note"] = ("no cut-auditable formulas for this "
                              "protocol (digest layer only)")
            continue
        report.setdefault("formulas", prog.labels)
        report.setdefault("not_cut_evaluable", prog.skipped)
        full = [(p, c) for p, c in by_n[n]
                if len(c.state) == prog.n_leaves]
        report["geometry_skipped"] += len(by_n[n]) - len(full)
        if not full:
            continue
        rt.n = n
        ok = prog.check_batch(
            [c.state for _, c in full],
            [prog.init_rows(c.values) if prog.needs_init else None
             for _, c in full],
            [c.round for _, c in full])
        report["audited"] += len(full)
        for (path, c), row in zip(full, ok):
            for fidx, good in enumerate(row):
                if not good:
                    rt.violate(
                        inst=c.inst, round_=c.round,
                        label=prog.labels[fidx],
                        values=[int(v) for v in c.values],
                        observed={
                            "surface": "snapshot-audit-offline",
                            "cut_file": path,
                            "digests": {
                                str(i): (d.hex() if d else None)
                                for i, d in enumerate(c.digests)},
                        })
    report["violations"] = rt.violations
    report["artifacts"] = rt.artifacts
    print(json.dumps(report, indent=1))
    return 1 if report["violations"] else 0


def show_main(args) -> int:
    from round_tpu_torch.snap.collect import load_cut

    for p in _cut_paths(args.cuts):
        cut, proto = load_cut(p)
        print(json.dumps({
            "file": p, "protocol": proto, "epoch": cut.epoch,
            "inst": cut.inst, "round": cut.round, "n": cut.n,
            "present": [int(x) for x in cut.present],
            "missing": cut.missing,
            "values": [int(v) for v in cut.values],
            "digests": {str(i): (d.hex() if d else None)
                        for i, d in enumerate(cut.digests)},
            "leaves": [{"shape": list(x.shape[1:]), "dtype": str(x.dtype)}
                       for x in cut.state],
        }))
    return 0


def diff_main(args) -> int:
    from round_tpu_torch.snap.collect import load_cut

    a, _ = load_cut(args.a)
    b, _ = load_cut(args.b)
    changed = sorted(
        i for i in range(min(a.n, b.n))
        if a.digests[i] is not None and b.digests[i] is not None
        and a.digests[i] != b.digests[i])
    print(json.dumps({
        "a": {"inst": a.inst, "round": a.round, "epoch": a.epoch},
        "b": {"inst": b.inst, "round": b.round, "epoch": b.epoch},
        "same_instance": a.inst == b.inst and a.epoch == b.epoch,
        "changed_replicas": changed,
        "unchanged_replicas": sorted(
            i for i in range(min(a.n, b.n))
            if a.digests[i] is not None
            and a.digests[i] == b.digests[i]),
    }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="offline audit of banked round-consistent cuts "
                    "(snap/, docs/SNAPSHOTS.md)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    au = sub.add_parser("audit", help="run the batched full-state audit "
                                      "over banked cuts")
    au.add_argument("cuts", nargs="+",
                    help=".snapcut files or directories of them")
    au.add_argument("--algo", type=str, default=None,
                    help="protocol selector name (default: from the "
                         "cut files)")
    au.add_argument("--dump-dir", type=str, default=None, metavar="DIR",
                    help="also dump violations as fuzz-replay artifacts")
    au.add_argument("--seed", type=int, default=0)
    au.add_argument("--max-rounds", type=int, default=32,
                    help="replay horizon recorded into artifacts")
    au.add_argument("--device", default="cuda",
                    help="where the audit runs (default cuda)")
    sh = sub.add_parser("show", help="print cut coordinates + digests")
    sh.add_argument("cuts", nargs="+")
    df = sub.add_parser("diff", help="digest diff of two cuts "
                                     "(divergence forensics)")
    df.add_argument("a")
    df.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "audit":
        return audit_main(args)
    if args.cmd == "show":
        return show_main(args)
    return diff_main(args)


if __name__ == "__main__":
    sys.exit(main())
