"""Broken-fixture corpus for the runtime lint families.

Port of round_tpu/analysis/runtime_fixtures: the same files, their
imports pointing at the port's package, every ``lint:`` marker on the
line round_tpu's is on.

One minimal deliberately-broken module per rule family, plus a clean
control that satisfies all of them — the same discipline as the model
fixtures (``analysis/fixtures.py``).  Each fixture is a tiny
``RuntimeLintConfig`` over files in this package; every ``lint:`` marker
comment in those files pins a golden (rule, file:line) finding that
tests/test_torch_runtimelint.py asserts exactly.

The package is excluded from the shipped tree's obs sweep (the whole
analysis tier is), and nothing imports the broken modules at runtime —
only the fold fixture's ``build()`` executes fixture code, on a closed
domain.

CLI: ``python -m round_tpu_torch.apps.lint --runtime --fixtures`` lints the
corpus and must exit nonzero.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Tuple

from round_tpu_torch.analysis import runtimerules as rr
from round_tpu_torch.analysis.runtimelint import RuntimeLintConfig

_HERE = os.path.dirname(os.path.abspath(__file__))


def fixture_path(name: str) -> str:
    return os.path.join(_HERE, name)


_MARKER_RE = re.compile(r"lint:\s*([a-z-]+/[a-z-]+)")


def marker_lines(path: str) -> Dict[str, List[int]]:
    """rule -> sorted marker lines in one fixture file — the golden
    anchors.  Works for .py, .cpp and .md (the marker is just text)."""
    out: Dict[str, List[int]] = {}
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            m = _MARKER_RE.search(line)
            if m:
                out.setdefault(m.group(1), []).append(i)
    return out


@dataclasses.dataclass(frozen=True)
class RuntimeFixture:
    """One corpus entry: the config to lint, the families to run, and
    the fixture files whose ``lint:`` markers define the golden set
    (empty marker set = the clean control, which must produce zero
    findings)."""

    name: str
    families: Tuple[str, ...]
    config: RuntimeLintConfig
    files: Tuple[str, ...]

    def golden(self) -> List[Tuple[str, str, int]]:
        """The expected findings as (rule, abspath, line) triples."""
        out = []
        for f in self.files:
            p = fixture_path(f)
            for rule, lines in marker_lines(p).items():
                out.extend((rule, p, ln) for ln in lines)
        return sorted(out)


def _fold_broken_spec() -> rr.FoldSpec:
    path = fixture_path("_broken_fold.py")
    line = marker_lines(path)["fold-determinism/non-commutative"][0]

    def build() -> dict:
        from round_tpu_torch.analysis.runtime_fixtures import _broken_fold as bf
        records = [(seq, v) for seq in (1, 2) for v in ("a", "b")]
        return {
            "apply": bf.lww_apply, "records": records,
            "starts": [{}, {"k": (1, "a")}],
            "eq": lambda x, y: x == y,
            "describe": lambda r: f"(seq={r[0]}, value={r[1]!r})",
        }

    return rr.FoldSpec("fx-seq-lww-prefix", path, line, build)


def _fold_clean_spec() -> rr.FoldSpec:
    path = fixture_path("_clean_control.py")

    def build() -> dict:
        from round_tpu_torch.analysis.runtime_fixtures import _clean_control as cc
        records = [(1, 10, "a"), (1, 11, "b"), (2, 10, "c")]
        return {
            "apply": cc.lww_apply, "records": records,
            "starts": [{}, {"k": (1, 10, "a")}],
            "eq": lambda x, y: x == y,
            "describe": lambda r: f"(seq={r[0]}, dig={r[1]})",
        }

    return rr.FoldSpec("fx-seq-lww-clean", path, 1, build)


RUNTIME_FIXTURES: Tuple[RuntimeFixture, ...] = (
    RuntimeFixture(
        name="lock",
        families=("lock-discipline",),
        config=RuntimeLintConfig(
            lock_files=(fixture_path("_broken_lock.py"),),
            pump_specs=(rr.PumpSpec(
                file=fixture_path("_broken_lock.py"),
                class_name="BrokenDriver"),),
        ),
        files=("_broken_lock.py",),
    ),
    RuntimeFixture(
        name="wire",
        families=("wire-coherence",),
        config=RuntimeLintConfig(
            cpp_file=fixture_path("_broken_wire.cpp"),
            flags_file=fixture_path("_broken_wire.py"),
            surfaces=(rr.SurfaceSpec(
                "fx.receiver", fixture_path("_broken_wire.py"),
                "BrokenReceiver.on_frame",
                frozenset({"FLAG_NORMAL", "FLAG_DECISION",
                           "FLAG_NACK"})),),
            non_dispatch=(("FLAG_BATCH",
                           "container flag: split natively"),),
        ),
        files=("_broken_wire.py", "_broken_wire.cpp"),
    ),
    RuntimeFixture(
        name="fold",
        families=("fold-determinism",),
        config=RuntimeLintConfig(fold_specs=(_fold_broken_spec(),)),
        files=("_broken_fold.py",),
    ),
    RuntimeFixture(
        name="counters",
        families=("counter-accounting",),
        config=RuntimeLintConfig(
            obs_files=(fixture_path("_broken_counters.py"),),
            counter_pairs=(rr.CounterPair(
                "fx shed accounting",
                lhs=("fx.shed_frames",), rhs=("fx.nacks_sent",)),),
        ),
        files=("_broken_counters.py",),
    ),
    RuntimeFixture(
        name="obs",
        families=("obs-vocab",),
        config=RuntimeLintConfig(
            obs_files=(fixture_path("_broken_obs.py"),),
            docs_file=fixture_path("_broken_obs.md"),
        ),
        files=("_broken_obs.py", "_broken_obs.md"),
    ),
    RuntimeFixture(
        name="clean",
        families=("lock-discipline", "wire-coherence",
                  "fold-determinism", "counter-accounting", "obs-vocab"),
        config=RuntimeLintConfig(
            lock_files=(fixture_path("_clean_control.py"),),
            pump_specs=(rr.PumpSpec(
                file=fixture_path("_clean_control.py"),
                class_name="CleanDriver"),),
            cpp_file=fixture_path("_clean_control.cpp"),
            flags_file=fixture_path("_clean_control.py"),
            surfaces=(rr.SurfaceSpec(
                "fxclean.receiver", fixture_path("_clean_control.py"),
                "CleanDriver.on_frame",
                frozenset({"FLAG_NORMAL", "FLAG_DECISION"})),),
            non_dispatch=(("FLAG_BATCH",
                           "container flag: split natively"),),
            fold_specs=(_fold_clean_spec(),),
            obs_files=(fixture_path("_clean_control.py"),),
            counter_pairs=(rr.CounterPair(
                "fxclean frames", lhs=("fxclean.frames",), rhs=()),),
            docs_file=fixture_path("_clean_control.md"),
        ),
        files=("_clean_control.py", "_clean_control.cpp",
               "_clean_control.md"),
    ),
)

BY_NAME = {f.name: f for f in RUNTIME_FIXTURES}
