"""Typed lint findings + the suppression baseline.

Port of round_tpu/analysis/findings.py.  The port's families are
round_tpu's less ``tpu-lowerability``: that family read the TPU dtype-path
tables of round_tpu/engine/fast.py, which the port does not carry.

A finding is one statically-detected defect in a model's round/spec code:
a rule id (``family/check``), a severity, a ``file:line`` anchor inside the
code that owns the defect, and a fix hint.  The baseline
(``round_tpu_torch/analysis/baseline.json``) suppresses *documented* pre-existing
findings — every entry carries a mandatory reason string, and matching is
by (model, rule, file) so entries survive unrelated line drift.

Reference parity: this is the reporting half of the reference's macro-time
round analysis (Verifier.scala rejects ill-formed protocols before they
run); here the report is a typed value instead of a compiler error.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, List, Optional, Sequence, Tuple

#: severity order, gating-first.  "error" = will fail at trace/run time,
#: "warn" = runs but violates a purity or extractability contract.  Both gate
#: (exit nonzero) unless baselined.
SEVERITIES = ("error", "warn")

#: the rule families the gate covers (docs/ANALYSIS.md catalog, less
#: tpu-lowerability).  The first five lint model-layer round/spec code;
#: the last five are the runtime families (runtimelint.py): the serving
#: tier — locks, wire constants, SMR folds, and the obs vocabulary.
FAMILIES = (
    "comm-closure",
    "recompile-hazard",
    "purity",
    "spec-coherence",
    "threshold-extractable",
    "lock-discipline",
    "wire-coherence",
    "fold-determinism",
    "counter-accounting",
    "obs-vocab",
)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def relpath(path: str) -> str:
    """Repo-relative form of a source path (stable across checkouts)."""
    path = os.path.abspath(path)
    return os.path.relpath(path, _REPO) if path.startswith(_REPO) else path


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis finding.

    rule:     ``family/check`` id, e.g. ``comm-closure/state-drift``.
    severity: "error" | "warn".
    model:    registry name of the model it was found in.
    file:     repo-relative source path owning the defect.
    line:     1-based line anchor.
    message:  what is wrong, concretely.
    hint:     how to fix (or why one would baseline) — one sentence.
    """

    rule: str
    severity: str
    model: str
    file: str
    line: int
    message: str
    hint: str = ""

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity
        assert self.family in FAMILIES, self.rule

    @property
    def family(self) -> str:
        return self.rule.split("/", 1)[0]

    @property
    def anchor(self) -> str:
        return f"{self.file}:{self.line}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["family"] = self.family
        return d

    def render(self) -> str:
        hint = f"  [fix: {self.hint}]" if self.hint else ""
        return (
            f"{self.anchor}: {self.severity}: {self.rule} ({self.model}): "
            f"{self.message}{hint}"
        )


@dataclasses.dataclass(frozen=True)
class Suppression:
    """One baseline entry: (model, rule, file) + a mandatory reason.
    ``since`` names the PR that added the entry, so baseline archaeology
    does not need git blame."""

    model: str
    rule: str
    file: str
    reason: str
    since: str = ""

    def matches(self, f: Finding) -> bool:
        return (
            self.model in (f.model, "*")
            and self.rule == f.rule
            and (f.file == self.file or f.file.endswith(self.file))
        )

    def render(self) -> str:
        since = f" [since {self.since}]" if self.since else ""
        return f"{self.model} {self.rule} {self.file}{since}"


class BaselineError(ValueError):
    """Malformed baseline file (missing keys, empty reason)."""


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


def default_runtime_baseline_path() -> str:
    """The runtime sweep's suppression file.  Separate from the model
    baseline so each gate's stale-entry report stays exact (a model-only
    lint cannot tell whether a runtime entry still matches anything,
    and vice versa)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "runtime_baseline.json")


def load_baseline(path: Optional[str] = None) -> List[Suppression]:
    """Parse a baseline file.  Every entry must name model, rule, file and a
    non-empty reason — an undocumented suppression defeats the gate."""
    path = path or default_baseline_path()
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        data = json.load(fh)
    entries = data.get("suppressions", data) if isinstance(data, dict) else data
    out = []
    for i, e in enumerate(entries):
        missing = [k for k in ("model", "rule", "file", "reason") if not e.get(k)]
        if missing:
            raise BaselineError(
                f"{path}: suppression #{i} is missing/empty {missing} — every "
                f"baseline entry needs a model, a rule id, a file and a "
                f"non-empty reason string"
            )
        out.append(Suppression(e["model"], e["rule"], e["file"], e["reason"],
                               e.get("since", "")))
    return out


def apply_baseline(
    findings: Sequence[Finding], baseline: Iterable[Suppression]
) -> Tuple[List[Finding], List[Finding], List[Suppression]]:
    """Split findings into (gating, suppressed); also return baseline
    entries that matched nothing (stale — surfaced so the baseline shrinks
    as findings get fixed, instead of rotting)."""
    baseline = list(baseline)
    used = [False] * len(baseline)
    gating, suppressed = [], []
    for f in findings:
        hit = False
        for i, s in enumerate(baseline):
            if s.matches(f):
                used[i] = True
                hit = True
        (suppressed if hit else gating).append(f)
    stale = [s for i, s in enumerate(baseline) if not used[i]]
    return gating, suppressed, stale
