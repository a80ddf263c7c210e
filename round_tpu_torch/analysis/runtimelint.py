"""runtimelint driver: the static gate over the serving runtime.

Port of round_tpu/analysis/runtimelint.py over the port's tree.  The
obs-vocab family diffs against the port's own copy of the observability
doc, ``round_tpu_torch/docs/OBSERVABILITY.md``: round_tpu's text plus a
section for the names only the port emits.

Assembles the declared registries in ``runtimerules.py`` into one
``RuntimeLintConfig`` and runs the five runtime families over it:

    from round_tpu_torch.analysis.runtimelint import runtime_lint
    findings = runtime_lint()                 # shipped tree, all families
    findings = runtime_lint(families=("obs-vocab",))   # --check-docs

CLI: ``python -m round_tpu_torch.apps.lint --runtime --all`` (exit 0 =
clean modulo ``analysis/runtime_baseline.json``); ``--check-docs`` runs
only the obs-vocabulary diff.  The broken-fixture corpus lives in
``round_tpu_torch/analysis/runtime_fixtures/`` — each fixture is a tiny
``RuntimeLintConfig`` over deliberately broken sources, linted by
tests/test_torch_runtimelint.py with golden (rule, file:line) pins.

Everything here is CPU-only and static; the only code executed from the
tree under analysis is the registered SMR folds, evaluated on tiny
closed domains (fold-determinism's exhaustive discharge)."""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

from round_tpu_torch.analysis.findings import Finding
from round_tpu_torch.analysis import runtimerules as rr

#: the runtime rule families, in sweep order (subset of
#: findings.FAMILIES; docs/ANALYSIS.md catalogs the rules)
RUNTIME_FAMILIES = (
    "lock-discipline",
    "wire-coherence",
    "fold-determinism",
    "counter-accounting",
    "obs-vocab",
)


@dataclasses.dataclass(frozen=True)
class RuntimeLintConfig:
    """One sweep's inputs.  Every field is optional-by-emptiness so
    fixture configs exercise exactly one family; ``default_config()``
    fills all of them from the runtimerules registries."""

    lock_files: Tuple[str, ...] = ()
    pump_specs: Tuple[rr.PumpSpec, ...] = ()
    cpp_file: str = ""
    flags_file: str = ""
    codec_file: str = ""
    cpp_pins: Tuple[rr.CppPin, ...] = rr.DEFAULT_CPP_PINS
    surfaces: Tuple[rr.SurfaceSpec, ...] = ()
    non_dispatch: Tuple[Tuple[str, str], ...] = ()
    fold_specs: Tuple[rr.FoldSpec, ...] = ()
    obs_files: Tuple[str, ...] = ()
    dynamic_names: Tuple[rr.DynamicNames, ...] = ()
    counter_pairs: Tuple[rr.CounterPair, ...] = ()
    docs_file: str = ""


def _obs_sweep_files() -> Tuple[str, ...]:
    """Every Python file whose emissions belong to the documented
    vocabulary: the whole package minus the analysis tier (whose fixture
    corpus deliberately emits junk names)."""
    root = rr.repo_path("round_tpu_torch")
    out = []
    for path in sorted(glob.glob(os.path.join(root, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, root)
        if rel.split(os.sep)[0] == "analysis":
            continue
        out.append(path)
    return tuple(out)


def default_config() -> RuntimeLintConfig:
    """The shipped tree: all registries, absolute paths."""
    return RuntimeLintConfig(
        lock_files=tuple(rr.repo_path(*f.split("/"))
                         for f in rr.LOCK_FILES),
        pump_specs=tuple(dataclasses.replace(
            s, file=rr.repo_path(*s.file.split("/")))
            for s in rr.PUMP_SPECS),
        cpp_file=rr.repo_path("round_tpu_torch", "native", "transport.cpp"),
        flags_file=rr.repo_path("round_tpu_torch", "runtime", "oob.py"),
        codec_file=rr.repo_path("round_tpu_torch", "runtime", "codec.py"),
        surfaces=tuple(dataclasses.replace(
            s, file=rr.repo_path(*s.file.split("/")))
            for s in rr.SURFACES),
        non_dispatch=tuple(sorted(rr.NON_DISPATCH.items())),
        fold_specs=rr.default_fold_specs(),
        obs_files=_obs_sweep_files(),
        dynamic_names=rr.DYNAMIC_NAMES,
        counter_pairs=rr.COUNTER_PAIRS,
        docs_file=rr.repo_path("round_tpu_torch", "docs",
                               "OBSERVABILITY.md"),
    )


def _dedupe_sorted(findings: Sequence[Finding]) -> List[Finding]:
    seen, out = set(), []
    for f in sorted(findings,
                    key=lambda f: (f.file, f.line, f.rule, f.message)):
        key = (f.rule, f.model, f.file, f.line, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def runtime_lint(config: Optional[RuntimeLintConfig] = None,
                 families: Optional[Sequence[str]] = None
                 ) -> List[Finding]:
    """Run the runtime families over ``config`` (default: shipped tree;
    round_tpu/analysis/runtimelint.py::runtime_lint).  ``families``
    filters the sweep (``--check-docs`` = obs-vocab only)."""
    cfg = config if config is not None else default_config()
    fams = set(families if families is not None else RUNTIME_FAMILIES)
    unknown = fams - set(RUNTIME_FAMILIES)
    if unknown:
        raise ValueError(f"unknown runtime families: {sorted(unknown)}")
    out: List[Finding] = []

    if "lock-discipline" in fams:
        for path in cfg.lock_files:
            out.extend(rr.lock_discipline(path))
        for spec in cfg.pump_specs:
            out.extend(rr.pump_discipline(spec))

    if "wire-coherence" in fams:
        if cfg.cpp_file and cfg.flags_file:
            out.extend(rr.wire_constants(
                cfg.cpp_file, cfg.flags_file,
                cfg.codec_file or None, cfg.cpp_pins))
        if cfg.surfaces and cfg.flags_file:
            out.extend(rr.dispatch_totality(
                cfg.surfaces, cfg.flags_file, dict(cfg.non_dispatch)))

    if "fold-determinism" in fams:
        for spec in cfg.fold_specs:
            out.extend(rr.fold_determinism(spec))

    sweep = None
    if ("counter-accounting" in fams or "obs-vocab" in fams) \
            and cfg.obs_files:
        sweep = rr.sweep_emissions(cfg.obs_files, cfg.dynamic_names)

    if "counter-accounting" in fams and sweep is not None:
        out.extend(sweep.findings)
        out.extend(rr.counter_pairs(sweep, cfg.counter_pairs))

    if "obs-vocab" in fams and sweep is not None and cfg.docs_file:
        out.extend(rr.obs_vocab(sweep, cfg.docs_file))

    return _dedupe_sorted(out)


def counts_by_rule(findings: Sequence[Finding]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out
