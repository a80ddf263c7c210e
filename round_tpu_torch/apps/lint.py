"""roundlint CLI: the static gate over round code.

Port of round_tpu/apps/lint.py.  The model sweep traces round code on
``--device`` (the card by default, raising where there is none); the
runtime sweep is static.

Usage:
    python -m round_tpu_torch.apps.lint --all                 # whole registry
    python -m round_tpu_torch.apps.lint --all --device cpu    # traces on the CPU
    python -m round_tpu_torch.apps.lint otr lastvoting        # named models
    python -m round_tpu_torch.apps.lint --all --json          # machine output
    python -m round_tpu_torch.apps.lint --all --baseline round_tpu_torch/analysis/baseline.json
    python -m round_tpu_torch.apps.lint --list                # registry contents
    python -m round_tpu_torch.apps.lint --runtime --all       # serving-tier sweep
    python -m round_tpu_torch.apps.lint --check-docs          # obs-vocab drift only
    python -m round_tpu_torch.apps.lint --runtime --fixtures  # broken corpus

Exit status: 0 when every finding is baselined (or none exist), 1 when any
non-baselined finding remains, 2 on usage errors.  Rule catalog and the
suppression workflow: docs/ANALYSIS.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from round_tpu_torch import analysis


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="round_tpu_torch.apps.lint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("models", nargs="*",
                    help="registry names to lint (see --list)")
    ap.add_argument("--all", action="store_true",
                    help="lint every registered model")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON document instead of text")
    ap.add_argument("--baseline", default=None,
                    help="suppression baseline (JSON; 'none' disables); "
                         "default: round_tpu_torch/analysis/baseline.json, or "
                         "runtime_baseline.json under --runtime")
    ap.add_argument("--fixtures", action="store_true",
                    help="lint the broken self-test corpus "
                         "(round_tpu_torch/analysis/fixtures.py, or the "
                         "runtime_fixtures/ corpus under --runtime) "
                         "instead of the registry — demo/debugging aid")
    ap.add_argument("--runtime", action="store_true",
                    help="run the serving-tier sweep (runtimelint: lock/"
                         "pump discipline, wire coherence, fold "
                         "determinism, counter accounting, obs vocab) "
                         "instead of the model registry")
    ap.add_argument("--check-docs", action="store_true", dest="check_docs",
                    help="runtime obs-vocab family only: diff the emitted "
                         "metric/event vocabulary against "
                         "round_tpu_torch/docs/OBSERVABILITY.md in both "
                         "directions (implies --runtime)")
    ap.add_argument("--list", action="store_true", dest="list_models",
                    help="list registered models and exit")
    ap.add_argument("--device", default="cuda",
                    help="device the model sweep traces round code on "
                         "(default: the card; cpu for a machine without "
                         "one)")
    ns = ap.parse_args(sys.argv[1:] if argv is None else argv)

    if ns.list_models:
        try:
            for e in analysis.REGISTRY:
                print(f"{e.name:18s} n={e.n:<4d} {e.note}")
        except BrokenPipeError:  # `lint --list | head` closed the pipe
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0

    runtime = ns.runtime or ns.check_docs
    if ns.check_docs and ns.fixtures:
        ap.error("--check-docs and --fixtures are mutually exclusive")
    default_bl = (analysis.default_runtime_baseline_path() if runtime
                  else analysis.default_baseline_path())
    bl_path = ns.baseline if ns.baseline is not None else default_bl

    if runtime:
        from round_tpu_torch.analysis.runtimelint import runtime_lint

        if ns.fixtures:
            from round_tpu_torch.analysis.runtime_fixtures import (
                RUNTIME_FIXTURES,
            )

            findings = []
            for fx in RUNTIME_FIXTURES:
                findings.extend(runtime_lint(fx.config, fx.families))
            baseline = []
        else:
            fams = ("obs-vocab",) if ns.check_docs else None
            findings = runtime_lint(families=fams)
            baseline = ([] if bl_path in ("none", "")
                        else analysis.load_baseline(bl_path))
    elif ns.fixtures:
        from round_tpu_torch.analysis.fixtures import FIXTURES

        findings = analysis.lint_all(registry=FIXTURES, device=ns.device)
        baseline = []
    else:
        if not ns.all and not ns.models:
            ap.error("name at least one model, or pass --all (see --list)")
        try:
            findings = analysis.lint_all(ns.models or None,
                                         device=ns.device)
        except KeyError as e:
            print(e.args[0], file=sys.stderr)
            return 2
        baseline = ([] if bl_path in ("none", "")
                    else analysis.load_baseline(bl_path))

    gating, suppressed, stale = analysis.apply_baseline(findings, baseline)
    if ns.check_docs:
        # a single-family sweep cannot tell which other families' baseline
        # entries are stale
        stale = []
    if not (ns.all or ns.fixtures or runtime):
        # a partial lint cannot tell which OTHER models' entries are stale
        stale = []

    if ns.as_json:
        counts = {}
        for f in findings:
            counts[f.family] = counts.get(f.family, 0) + 1
        print(json.dumps({
            "findings": [f.to_dict() for f in gating],
            "suppressed": [f.to_dict() for f in suppressed],
            "stale_baseline": [vars(s).copy() for s in stale],
            "counts_by_family": counts,
            "total": len(findings),
            "gating": len(gating),
        }, indent=2))
    else:
        for f in gating:
            print(f.render())
        if suppressed:
            print(f"{len(suppressed)} finding(s) suppressed by baseline "
                  f"({bl_path})")
        for s in stale:
            print(f"note: stale baseline entry matched nothing: "
                  f"{s.render()} — remove it", file=sys.stderr)
        verdict = "CLEAN" if not gating else f"{len(gating)} gating finding(s)"
        print(verdict)
    return 0 if not gating else 1


if __name__ == "__main__":
    sys.exit(main())
