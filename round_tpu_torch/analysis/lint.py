"""The lint driver: run every rule family over registered models.

Port of round_tpu/analysis/lint.py.  ``lint_model`` combines the AST
passes (astrules.py) with the tracing passes (tracerules.py and the
threshold-extractable family, threshold.py) for one registry entry, the
traces on ``device`` (the card unless the caller names one); ``lint_all``
sweeps the registry.  Nothing runs a protocol: the traces are make_fx
graphs of single rounds at a small n.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from round_tpu_torch.analysis.astrules import ast_rules
from round_tpu_torch.analysis.findings import Finding, relpath
from round_tpu_torch.analysis.registry import REGISTRY, ModelEntry, get
from round_tpu_torch.analysis.tracerules import resolve_device, trace_rules


def _dedupe_sorted(findings: Iterable[Finding]) -> List[Finding]:
    seen, out = set(), []
    for f in findings:
        key = (f.rule, f.model, f.file, f.line, f.message)
        if key in seen:
            continue
        seen.add(key)
        out.append(f)
    out.sort(key=lambda f: (f.model, f.file, f.line, f.rule))
    return out


def lint_model(entry: ModelEntry, device=None) -> List[Finding]:
    """All findings for one registered model, traced on ``device``
    (round_tpu/analysis/lint.py::lint_model)."""
    device = resolve_device(device)
    try:
        algo, io = entry.build()
    except Exception as e:  # noqa: BLE001 — a broken registry entry IS a finding
        return [Finding(
            rule="comm-closure/init", severity="error", model=entry.name,
            file=relpath(__file__), line=0,
            message=f"registry build() for {entry.name!r} raised "
                    f"{type(e).__name__}: {e}",
            hint="fix the ModelEntry in analysis/registry.py (or the model "
                 "constructor it calls)",
        )]
    findings = list(ast_rules(entry.name, algo))
    findings += trace_rules(entry.name, entry.n, algo, io, device)
    from round_tpu_torch.analysis.threshold import threshold_rules

    findings += threshold_rules(entry, device)
    return _dedupe_sorted(findings)


def lint_all(
    names: Optional[Sequence[str]] = None,
    registry: Sequence[ModelEntry] = REGISTRY,
    device=None,
) -> List[Finding]:
    """Findings across models (the whole registry by default), traced on
    ``device`` (round_tpu/analysis/lint.py::lint_all)."""
    entries = [get(n) for n in names] if names else list(registry)
    findings: List[Finding] = []
    for entry in entries:
        findings.extend(lint_model(entry, device))
    return findings
