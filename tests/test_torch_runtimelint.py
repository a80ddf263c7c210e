"""The runtime static gate in the port (round_tpu_torch/analysis/
runtimelint.py) against round_tpu's.

round_tpu's tests/test_runtimelint.py run over the port — golden findings
on the broken-fixture corpus, zero non-baselined findings on the port's
serving tier, the CLI exit-code contract (its ``slow`` subprocess test
stays ``slow``) — plus the twins' comparison: every runtime fixture gives
round_tpu's findings (rule, severity, file name, line), and the port's
baseline is round_tpu's with the port's paths.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from round_tpu import analysis as r_analysis
from round_tpu.analysis import runtime_fixtures as r_rfx
from round_tpu.analysis.runtimelint import runtime_lint as r_runtime_lint
from round_tpu_torch import analysis
from round_tpu_torch.analysis import runtime_fixtures as rfx
from round_tpu_torch.analysis import runtimerules as rr
from round_tpu_torch.analysis.runtimelint import (
    RUNTIME_FAMILIES,
    counts_by_rule,
    default_config,
    runtime_lint,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.lint

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _triples(findings):
    """Findings as comparable (rule, basename, line) triples — matching
    the fixture marker goldens, which anchor by file basename."""
    return sorted({(f.rule, os.path.basename(f.file), f.line)
                   for f in findings})


# -- golden findings: every broken fixture fires exactly its markers --------


@pytest.mark.parametrize(
    "name", [f.name for f in rfx.RUNTIME_FIXTURES if f.name != "clean"])
def test_broken_fixture_golden(name):
    fx = rfx.BY_NAME[name]
    golden = sorted({(rule, os.path.basename(path), line)
                     for rule, path, line in fx.golden()})
    assert golden, f"fixture {name} has no lint: markers"
    got = _triples(runtime_lint(fx.config, fx.families))
    assert got == golden, (
        f"fixture {name}: findings drifted off the golden markers\n"
        f"  got : {got}\n  want: {golden}")
    for rule, _, _ in golden:
        assert rule.split("/", 1)[0] in fx.families


@pytest.mark.parametrize("name", [f.name for f in r_rfx.RUNTIME_FIXTURES])
def test_fixture_findings_equal_round_tpus(name):
    """The same fixture through both packages: the same findings."""
    def key(findings):
        return sorted((f.rule, f.severity, os.path.basename(f.file), f.line)
                      for f in findings)

    ours, theirs = rfx.BY_NAME[name], r_rfx.BY_NAME[name]
    assert ours.families == theirs.families
    assert key(runtime_lint(ours.config, ours.families)) == \
        key(r_runtime_lint(theirs.config, theirs.families))


def test_clean_control_zero_findings():
    fx = rfx.BY_NAME["clean"]
    assert tuple(sorted(fx.families)) == tuple(sorted(RUNTIME_FAMILIES))
    assert runtime_lint(fx.config, fx.families) == []


# -- the acceptance-named catches, asserted by rule -------------------------


def test_desynced_flag_is_caught():
    """The deliberately desynced kFlagNormal (0x01 vs Python 0x00) is a
    constant-mismatch, and the lost fallback route is native-fallback."""
    fx = rfx.BY_NAME["wire"]
    rules = counts_by_rule(runtime_lint(fx.config, fx.families))
    assert rules.get("wire-coherence/constant-mismatch") == 1
    assert rules.get("wire-coherence/native-fallback") == 1
    assert rules.get("wire-coherence/dispatch-gap") == 1


def test_prefix_seq_lww_fold_is_caught():
    """The pre-fix seq-LWW fold (equal-seq `>=`, arrival-order ties) is
    re-caught as order-dependence on the closed domain."""
    fx = rfx.BY_NAME["fold"]
    findings = runtime_lint(fx.config, fx.families)
    assert findings
    assert all(f.rule == "fold-determinism/non-commutative"
               for f in findings)


def test_fold_refusal_semantics():
    """A fold whose build fails REFUSES (gating warn) instead of
    silently passing."""

    def build():
        raise RuntimeError("domain unavailable")

    spec = rr.FoldSpec("fx-unbuildable", rfx.fixture_path("__init__.py"),
                       1, build)
    out = rr.fold_determinism(spec)
    assert [f.rule for f in out] == ["fold-determinism/refused"]
    assert "build failed" in out[0].message


def test_shipped_folds_are_the_ports_torch_folds():
    """The fold pass discharges the port's kv.store folds, the array rider
    evaluated with torch (its traceability probe a make_fx trace)."""
    specs = rr.default_fold_specs()
    assert [s.name for s in specs] == ["kv-host-seq-lww", "kv-array-seq-lww"]
    for spec in specs:
        assert spec.file.endswith(os.path.join("round_tpu_torch", "kv",
                                               "store.py"))
        d = spec.build()
        if d.get("trace") is not None:
            d["trace"]()
        assert rr.fold_determinism(spec) == []
    arr = specs[1].build()
    assert isinstance(arr["starts"][0][0], torch.Tensor)


# -- shipped tree: clean modulo the reasoned runtime baseline ---------------


def test_shipped_tree_clean_modulo_baseline():
    findings = runtime_lint()
    baseline = analysis.load_baseline(
        analysis.default_runtime_baseline_path())
    gating, suppressed, stale = analysis.apply_baseline(findings, baseline)
    assert not gating, "\n".join(f.render() for f in gating)
    assert not stale, "\n".join(s.render() for s in stale)
    # every suppression earned its keep and documents its provenance
    assert suppressed
    for s in baseline:
        assert s.reason and s.since


def test_runtime_baseline_is_round_tpus_with_the_ports_paths():
    ours = [(s.model, s.rule, s.file, s.reason, s.since)
            for s in analysis.load_baseline(
                analysis.default_runtime_baseline_path())]
    theirs = [(s.model, s.rule,
               s.file.replace("round_tpu/", "round_tpu_torch/", 1),
               s.reason, s.since)
              for s in r_analysis.load_baseline(
                  r_analysis.default_runtime_baseline_path())]
    assert ours == theirs


def test_shipped_wire_constants_agree():
    """codec.py/oob.py ↔ transport.cpp constant + dispatch-totality
    agreement, proven statically with no baseline help."""
    cfg = default_config()
    assert rr.wire_constants(cfg.cpp_file, cfg.flags_file,
                             cfg.codec_file, cfg.cpp_pins) == []
    assert rr.dispatch_totality(cfg.surfaces, cfg.flags_file,
                                dict(cfg.non_dispatch)) == []


def test_obs_vocab_reads_the_ports_own_document():
    """obs-vocab diffs against round_tpu_torch/docs/OBSERVABILITY.md:
    round_tpu's text plus the names only the port emits, which are
    emitted and documented there."""
    cfg = default_config()
    assert cfg.docs_file == os.path.join(
        _REPO, "round_tpu_torch", "docs", "OBSERVABILITY.md")
    sweep = rr.sweep_emissions(cfg.obs_files, cfg.dynamic_names)
    assert rr.obs_vocab(sweep, cfg.docs_file) == []
    metrics, _prefixes, _events, _any = rr.parse_doc_vocab(cfg.docs_file)
    for name in ("host.d2h_copies", "host.h2d_copies"):
        assert name in sweep.metrics and name in metrics
    assert all(p.startswith(os.path.join(_REPO, "round_tpu_torch"))
               and os.sep + "analysis" + os.sep not in p
               for p in cfg.obs_files)


def test_runtime_families_registered():
    assert set(RUNTIME_FAMILIES) <= set(analysis.FAMILIES)
    with pytest.raises(ValueError):
        runtime_lint(families=("no-such-family",))


# -- the since field (baseline archaeology without git blame) ---------------


def test_baseline_since_field():
    for path in (analysis.default_baseline_path(),
                 analysis.default_runtime_baseline_path()):
        for s in analysis.load_baseline(path):
            assert s.since.startswith("PR "), (path, s)
            assert f"[since {s.since}]" in s.render()


# -- budget: the whole runtime sweep stays inside the lint budget -----------


def test_runtime_sweep_budget():
    t0 = time.monotonic()
    runtime_lint()
    wall = time.monotonic() - t0
    assert wall < 60, f"runtime_lint() took {wall:.1f}s"


def test_cli_runtime_in_process(capsys):
    """In process: ``--runtime --all --json`` exits 0, ``--check-docs``
    exits 0, and ``--runtime --fixtures`` gates (exit 1)."""
    from round_tpu_torch.apps import lint as lint_cli

    assert lint_cli.main(["--runtime", "--all", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["gating"] == 0 and doc["suppressed"]
    assert lint_cli.main(["--check-docs"]) == 0
    capsys.readouterr()
    assert lint_cli.main(["--runtime", "--fixtures"]) == 1
    assert "gating finding(s)" in capsys.readouterr().out


# -- CLI exit-code contract (subprocess; slow) ------------------------------


@pytest.mark.slow  # 3 interpreter spawns; the in-process gate is tier-1
def test_cli_exit_codes():
    def run(*args):
        env = {k: v for k, v in os.environ.items()
               if k != "JAX_PLATFORMS"}
        return subprocess.run(
            [sys.executable, "-m", "round_tpu_torch.apps.lint", *args],
            capture_output=True, text=True, env=env, timeout=300,
            cwd=_REPO)

    clean = run("--runtime", "--all", "--json")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    doc = json.loads(clean.stdout)
    assert doc["gating"] == 0

    docs = run("--check-docs")
    assert docs.returncode == 0, docs.stdout + docs.stderr

    broken = run("--runtime", "--fixtures")
    assert broken.returncode == 1, broken.stdout + broken.stderr
    assert "gating finding(s)" in broken.stdout
