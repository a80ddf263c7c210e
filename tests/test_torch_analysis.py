"""The static-analysis gate in the port (round_tpu_torch/analysis, the
model families) against round_tpu's.

round_tpu's tests/test_analysis.py run over the port — golden findings
on the broken fixture corpus, zero non-baselined findings across the
port's models, the SpecFieldError satellite, the verifier CLI's argument
handling (its ``slow`` CLI sweep stays ``slow``) — plus the twins'
comparison: each fixture's findings, and each registered model's, as
round_tpu's (rule, severity) multisets less the tpu-lowerability family,
which the port does not carry.  Traces run on the CPU.
"""

import collections
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from round_tpu import analysis as r_analysis
from round_tpu.analysis import fixtures as r_fixtures
from round_tpu.analysis import registry as r_registry
from round_tpu_torch import analysis
from round_tpu_torch.analysis import fixtures
from round_tpu_torch.spec.dsl import SpecFieldError

torch.set_num_threads(1)

pytestmark = pytest.mark.lint

CPU = "cpu"
FIXTURE_FILE = "round_tpu_torch/analysis/fixtures.py"
DROPPED = "tpu-lowerability"


def _lint(name):
    return analysis.lint_model(fixtures.FIXTURES_BY_NAME[name], CPU)


def _marker_line(rule):
    """Line number of the `# lint: <rule>` marker in the fixture source."""
    src = inspect.getsource(fixtures).splitlines()
    for i, line in enumerate(src, start=1):
        if f"# lint: {rule}" in line:
            return i
    raise AssertionError(f"no marker for {rule} in fixtures.py")


def _def_line(fn):
    return fn.__code__.co_firstlineno


def _multiset(findings):
    return sorted(collections.Counter(
        (f.rule, f.severity) for f in findings
        if f.family != DROPPED).items())


# -- every rule family fires on the broken corpus, with correct anchors -----


def test_every_family_fires_on_fixtures():
    found = {}
    for entry in fixtures.FIXTURES:
        if entry.name == "fixture-clean":
            continue
        for f in analysis.lint_model(entry, CPU):
            assert f.file.endswith(FIXTURE_FILE), f
            assert f.line > 0, f
            found.setdefault(f.family, []).append(f)
    # the threshold-extractable family has its own corpus
    # (threshold_fixtures.py; goldens in tests/test_torch_threshold.py) —
    # its negative fixture is what fires the family
    from round_tpu_torch.analysis import threshold_fixtures as tfx

    for f in analysis.lint_model(
            tfx.THRESHOLD_FIXTURES_BY_NAME["tfix-data-bound"], CPU):
        if f.family == "threshold-extractable":
            found.setdefault(f.family, []).append(f)
    # the five runtime families fire on the runtime_fixtures/ corpus
    # (goldens in tests/test_torch_runtimelint.py)
    from round_tpu_torch.analysis import runtime_fixtures as rfx
    from round_tpu_torch.analysis.runtimelint import runtime_lint

    for fx in rfx.RUNTIME_FIXTURES:
        for f in runtime_lint(fx.config, fx.families):
            found.setdefault(f.family, []).append(f)
    missing = set(analysis.FAMILIES) - set(found)
    assert not missing, f"rule families with no fixture finding: {missing}"


def test_families_are_round_tpus_less_the_tpu_family():
    assert analysis.FAMILIES == tuple(
        f for f in r_analysis.FAMILIES if f != DROPPED)


@pytest.mark.parametrize("name", [e.name for e in r_fixtures.FIXTURES])
def test_fixture_findings_equal_round_tpus(name):
    """Each fixture's findings as round_tpu's (rule, severity) multiset,
    less the dropped family.  round_tpu's int-reduce fixture demos that
    family alone, so the port carries no such fixture and nothing else
    of it is lost."""
    r_found = r_analysis.lint_model(r_fixtures.FIXTURES_BY_NAME[name])
    entry = fixtures.FIXTURES_BY_NAME.get(name)
    if entry is None:
        assert name == "fixture-int-reduce"
        assert {f.family for f in r_found} == {DROPPED}
        return
    assert _multiset(analysis.lint_model(entry, CPU)) == _multiset(r_found)


def test_golden_anchor_state_drift():
    fs = _lint("fixture-dtype-drift")
    (f,) = [x for x in fs if x.rule == "comm-closure/state-drift"]
    assert f.line == _def_line(fixtures.DtypeDriftRound.update)
    assert "int32[4] -> float32[4]" in f.message
    assert f.severity == "error"


def test_golden_anchor_mailbox_misuse():
    fs = _lint("fixture-mailbox-misuse")
    (f,) = [x for x in fs if x.rule == "comm-closure/mailbox"]
    assert f.line == _def_line(fixtures.MailboxMisuseRound.update)
    assert "'vote'" in f.message and "est" in f.message


def test_golden_anchors_purity():
    fs = _lint("fixture-impure")
    by_rule = {f.rule: f for f in fs}
    assert by_rule["purity/unseeded-random"].line == \
        _marker_line("purity/unseeded-random")
    assert by_rule["purity/time"].line == _marker_line("purity/time")
    assert by_rule["purity/closure-mutation"].line == \
        _marker_line("purity/closure-mutation")
    assert all(f.severity == "error" for f in by_rule.values())


def test_golden_anchor_spec_typo():
    fs = _lint("fixture-spec-typo")
    (f,) = [x for x in fs if x.rule == "spec-coherence/missing-field"]
    lam = fixtures.TypoSpec().properties[0][1]
    assert f.line == lam.__code__.co_firstlineno
    assert "decidedd" in f.message          # the typo'd field
    assert "Agreement" in f.message         # the formula's name
    assert "x, decided, decision" in f.message  # the fields that DO exist


def test_torch_idioms_of_the_ast_rules():
    """The AST rules read torch's idioms for round_tpu's defects: a
    global-generator draw without ``generator=`` and ``manual_seed`` are
    unseeded RNG, ``.item()``/``.cpu()``/``.numpy()`` on a traced value
    concretize, a print is a host callback; a draw with a generator, and
    a branch on a static attribute, are not findings."""
    from round_tpu_torch.analysis.astrules import scan_function

    def update(self, ctx, state, mbox):
        a = torch.rand(3)
        b = torch.randint(0, 4, (2,), generator=self.gen)
        torch.manual_seed(7)
        c = mbox.size().item()
        d = state.x.cpu()
        e = state.x.numpy()
        print(c)
        if state.x.dim() == 1:
            a = a + 1
        return a, b, d, e

    got = sorted((f.rule, f.line - update.__code__.co_firstlineno)
                 for f in scan_function("m", update))
    assert got == [
        ("purity/host-callback", 7),
        ("purity/unseeded-random", 1),
        ("purity/unseeded-random", 3),
        ("recompile-hazard/concretize", 4),
        ("recompile-hazard/concretize", 5),
        ("recompile-hazard/concretize", 6),
    ]


def test_batched_tensor_guard_skips_host_only_branches():
    """The port's host-only-branch guard (functorch's batched-tensor
    predicate, round_tpu's isinstance(..., Tracer)) skips its body."""
    from round_tpu_torch.analysis.astrules import scan_function

    def make_init_state(self, ctx, io):
        x = io["initial_value"]
        if not torch._C._functorch.is_batchedtensor(x):
            if int(x.max()) >= 4:
                raise ValueError("out of range")
        return x

    assert scan_function("m", make_init_state) == []


def test_spec_coherence_safety_predicate_has_no_old():
    """check_trace evaluates safety_predicate on a pre-state Env with
    old=None (spec/check.py); a safety formula touching i.old must fail
    the lint, not first blow up mid-run."""
    from round_tpu_torch.analysis.registry import ModelEntry
    from round_tpu_torch.spec.dsl import Spec

    class OldInSafety(Spec):
        def __init__(self):
            self.safety_predicate = \
                lambda e: e.P.forall(lambda i: i.old.x == i.x)

    class Algo(fixtures.CleanToy):
        def __init__(self):
            super().__init__()
            self.spec = OldInSafety()

    entry = ModelEntry(
        "old-in-safety",
        lambda: (Algo(), {"initial_value": np.arange(4, dtype=np.int32)}),
        n=4,
    )
    fs = analysis.lint_model(entry, CPU)
    (f,) = [x for x in fs if x.rule == "spec-coherence/trace-error"]
    assert "safety_predicate" in f.message
    assert "previous-round snapshot" in f.message


def test_golden_anchor_traced_branch():
    fs = _lint("fixture-traced-branch")
    rules = {f.rule for f in fs}
    assert "recompile-hazard/traced-branch" in rules
    (f,) = [x for x in fs if x.rule == "recompile-hazard/traced-branch"]
    assert f.line == _marker_line("recompile-hazard/traced-branch")
    # the trace independently confirms the hazard
    assert "recompile-hazard/concretize" in rules


def test_clean_fixture_has_zero_findings():
    assert _lint("fixture-clean") == []


# -- the shipped tree is clean modulo the documented baseline ---------------


def test_models_gate_zero_nonbaselined_findings():
    t0 = time.monotonic()
    findings = analysis.lint_all(device=CPU)
    wall = time.monotonic() - t0
    gating, suppressed, stale = analysis.apply_baseline(
        findings, analysis.load_baseline()
    )
    assert not gating, "non-baselined findings:\n" + "\n".join(
        f.render() for f in gating
    )
    assert not stale, f"stale baseline entries (fixed findings?): {stale}"
    for f in suppressed:
        assert f.family == "threshold-extractable", (
            "only the documented outside-the-threshold-fragment class is "
            f"baselined; got {f.render()}"
        )
    # acceptance: the full sweep stays comfortably inside the 60 s budget
    assert wall < 60, f"lint --all took {wall:.1f}s"


def test_baseline_is_round_tpus_less_the_tpu_family():
    """The port's baseline lists the port's files with round_tpu's
    reason strings kept."""
    def key(s, root):
        return (s.model, s.rule, s.file.replace(root, "", 1), s.reason,
                s.since)

    ours = sorted(key(s, "round_tpu_torch/")
                  for s in analysis.load_baseline())
    theirs = sorted(key(s, "round_tpu/") for s in r_analysis.load_baseline()
                    if not s.rule.startswith(DROPPED))
    assert ours == theirs
    assert all(s.file.startswith("round_tpu_torch/")
               and os.path.exists(s.file) is not None
               for s in analysis.load_baseline())


@pytest.mark.parametrize("name", ["lastvoting-event", "pbft-vc"])
def test_model_findings_equal_round_tpus(name):
    """The two slowest registered models (the rest are held family by
    family in tests/test_torch_threshold.py and by the gate above): all
    their findings as round_tpu's, less the dropped family."""
    ours = analysis.lint_model(analysis.registry.get(name), CPU)
    theirs = r_analysis.lint_model(r_registry.get(name))
    assert _multiset(ours) == _multiset(theirs)
    assert sorted(os.path.basename(f.file) for f in ours) == sorted(
        os.path.basename(f.file) for f in theirs if f.family != DROPPED)


def test_registry_covers_exported_models():
    """Every Algorithm round_tpu's models package exports is lintable via
    the port's registry (the port's models package exports no names; its
    modules are round_tpu's, class for class)."""
    import round_tpu.models as RM
    from round_tpu.core.algorithm import Algorithm as RAlgorithm

    exported = {
        name for name in RM.__all__
        if isinstance(getattr(RM, name), type)
        and issubclass(getattr(RM, name), RAlgorithm)
    }
    registered = set()
    for entry in analysis.REGISTRY:
        algo, _io = entry.build()
        registered.add(type(algo).__name__)
    missing = {n for n in exported if n not in registered}
    assert not missing, f"models exported but not in the lint registry: {missing}"
    assert [e.name for e in analysis.REGISTRY] == \
        [e.name for e in r_analysis.REGISTRY]
    assert [e.build_at is None for e in analysis.REGISTRY] == \
        [e.build_at is None for e in r_analysis.REGISTRY]


def test_baseline_entries_require_reasons(tmp_path):
    p = tmp_path / "b.json"
    p.write_text(json.dumps({"suppressions": [
        {"model": "otr", "rule": "threshold-extractable/opaque-control",
         "file": "round_tpu_torch/models/otr.py", "reason": ""}
    ]}))
    from round_tpu_torch.analysis.findings import BaselineError

    with pytest.raises(BaselineError):
        analysis.load_baseline(str(p))


@pytest.mark.slow  # ~40 s subprocess sweep; the in-process
# zero-nonbaselined gate stays tier-1
def test_cli_json_clean_without_accelerator_env():
    """End-to-end: the CLI exits 0 on the shipped tree with its traces on
    the CPU and emits valid JSON."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run(
        [sys.executable, "-m", "round_tpu_torch.apps.lint", "--all",
         "--json", "--device", CPU],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    assert doc["gating"] == 0
    assert doc["total"] == len(doc["suppressed"])
    assert set(doc["counts_by_family"]) <= set(analysis.FAMILIES)


def test_cli_lints_the_fixture_corpus_and_exits_nonzero(capsys):
    """In process: ``--fixtures --json`` lints the broken corpus on the
    CPU and gates (exit 1); ``--list`` names round_tpu's registry."""
    from round_tpu_torch.apps import lint as lint_cli

    assert lint_cli.main(["--fixtures", "--json", "--device", CPU]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["gating"] == doc["total"] > 0
    assert lint_cli.main(["--list"]) == 0
    listed = [line.split()[0]
              for line in capsys.readouterr().out.splitlines()]
    assert listed == [e.name for e in r_analysis.REGISTRY]
    with pytest.raises(SystemExit):
        lint_cli.main([])  # no model, no --all


# -- satellite: SpecFieldError replaces the opaque AttributeError -----------


def _toy_state(n, T=None):
    shape = (n,) if T is None else (T, n)
    return fixtures.ToyState(
        x=torch.zeros(shape, dtype=torch.int32),
        decided=torch.zeros(shape, dtype=torch.bool),
        decision=torch.full(shape, -1, dtype=torch.int32),
    )


def test_check_trace_names_missing_field_and_formula():
    from round_tpu_torch.spec.check import check_trace

    n = 4
    with pytest.raises(SpecFieldError) as ei:
        check_trace(fixtures.TypoSpec(), _toy_state(n, T=2), _toy_state(n), n)
    msg = str(ei.value)
    assert "decidedd" in msg                     # the missing field
    assert "Agreement" in msg                    # which formula
    assert "x, decided, decision" in msg         # what exists instead


def test_procview_old_snapshot_field_error():
    from round_tpu_torch.spec.dsl import Env, ProcView

    n = 4
    env = Env(state=_toy_state(n), n=n, old=_toy_state(n))
    view = ProcView(env, 0)
    with pytest.raises(SpecFieldError) as ei:
        _ = view.old.nope
    assert "old-snapshot" in str(ei.value) and "nope" in str(ei.value)
    # well-formed access still works
    assert view.decided.shape == ()


def test_procview_reads_a_round_derived_index_on_the_device():
    """``e.proc`` of a round-derived (0-d tensor) index reads its fields
    without a host read: the lint traces LastVoting's invariant, which
    picks the phase's coordinator so, and a plain ``v[idx]`` would read
    the index to the host."""
    from round_tpu_torch.analysis.tracerules import trace_graph
    from round_tpu_torch.spec.dsl import Env

    n = 4
    st = _toy_state(n)

    def coord_x(x, r):
        env = Env(state=fixtures.ToyState(x=x, decided=st.decided,
                                          decision=st.decision), n=n)
        return env.proc((r // 4) % n).x

    trace_graph(coord_x, (torch.arange(n, dtype=torch.int32),
                          torch.tensor(9, dtype=torch.int32)))
    assert int(coord_x(torch.arange(n, dtype=torch.int32) * 3,
                       torch.tensor(9))) == 6


def test_verifier_cli_all_arg_handling():
    from round_tpu_torch.apps import verifier_cli

    with pytest.raises(SystemExit):
        verifier_cli.main([])                 # no protocol, no --all
    with pytest.raises(SystemExit):
        verifier_cli.main(["--all", "tpc"])   # --all takes no protocol
