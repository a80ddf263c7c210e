"""Threshold-automaton extraction in the port (round_tpu_torch/analysis/
threshold.py) against round_tpu's.

round_tpu's tests/test_threshold.py, run over the port (the goldens are
round_tpu's, the traces the port's aten graphs on the CPU), plus the
twins' comparison: the same model's automaton from both packages must be
equal as ``to_dict()`` — guard names, thresholds, locations and rules —
for every fixture and for otr, otr-hist and lastvoting, and the
``threshold-extractable`` findings of every registered model must be
round_tpu's.
"""

import os

import pytest
import torch

from round_tpu.analysis import registry as r_registry
from round_tpu.analysis import threshold as r_threshold
from round_tpu.analysis import threshold_fixtures as r_tfx
from round_tpu_torch.analysis import registry as p_registry
from round_tpu_torch.analysis.threshold import (
    DEFAULT_SAMPLES, LINT_SAMPLES, ThresholdExtractionError,
    extract_automaton, extract_automaton_from, fit_affine, parse_envelope,
    threshold_rules,
)
from round_tpu_torch.analysis.threshold_fixtures import (
    THRESHOLD_FIXTURES, THRESHOLD_FIXTURES_BY_NAME,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.lint

CPU = "cpu"


def _fixture(name):
    return THRESHOLD_FIXTURES_BY_NAME[name]


def _extract_fixture(name, samples=LINT_SAMPLES):
    a, problems = extract_automaton_from(
        _fixture(name).build_at, name, samples, strict=True, device=CPU)
    assert not problems
    return a


def _guard_exprs(automaton):
    return sorted(g.render() for g in automaton.thresholds())


# -- the affine fit ---------------------------------------------------------

FIT_CASES = [
    (list(DEFAULT_SAMPLES), lambda n: (2 * n) // 3),
    (list(DEFAULT_SAMPLES), lambda n: n // 2),
    (list(DEFAULT_SAMPLES), lambda n: n),
    (list(DEFAULT_SAMPLES), lambda n: 0),
    (list(DEFAULT_SAMPLES), lambda n: n - 2),
    (list(DEFAULT_SAMPLES), lambda n: (n * n) // 4),
    ([5, 7, 9, 12], lambda n: (2 * n) // 3),
    (list(LINT_SAMPLES), lambda n: (2 * n + 1) // 3),
]


@pytest.mark.parametrize("k", range(len(FIT_CASES)))
def test_fit_affine_equals_round_tpus(k):
    ns, t = FIT_CASES[k]
    ts = [t(n) for n in ns]
    assert fit_affine(ns, ts) == r_threshold.fit_affine(ns, ts)


def test_fit_affine_recovers_floor_forms():
    ns = list(DEFAULT_SAMPLES)
    assert fit_affine(ns, [(2 * n) // 3 for n in ns]) == (2, 0, 3)
    assert fit_affine(ns, [n // 2 for n in ns]) == (1, 0, 2)
    assert fit_affine(ns, [n for n in ns]) == (1, 0, 1)
    assert fit_affine(ns, [0 for _ in ns]) == (0, 0, 1)
    assert fit_affine(ns, [n - 2 for n in ns]) == (1, -2, 1)


def test_fit_affine_refuses_nonaffine():
    ns = list(DEFAULT_SAMPLES)
    assert fit_affine(ns, [(n * n) // 4 for n in ns]) is None


def test_fit_affine_disambiguates_aliased_forms():
    """floor(2n/3) and floor((3n-3)/4) agree on {5,7,9,12}; the default
    sample set must pick the true form."""
    assert fit_affine([5, 7, 9, 12], [(2 * n) // 3 for n in [5, 7, 9, 12]],
                      ) in ((2, 0, 3), (3, -3, 4))  # ambiguous on 4 points
    assert fit_affine(list(DEFAULT_SAMPLES),
                      [(2 * n) // 3 for n in DEFAULT_SAMPLES]) == (2, 0, 3)


def test_parse_envelope():
    assert parse_envelope("n > 3f") == (3, "n > 3f")
    assert parse_envelope("n > 2*f") == (2, "n > 2f")
    assert parse_envelope(None) is None
    with pytest.raises(ThresholdExtractionError):
        parse_envelope("n >= 3f + 1")


# -- fixture corpus goldens -------------------------------------------------

def test_majority_fixture_golden():
    a = _extract_fixture("tfix-majority")
    assert _guard_exprs(a) == ["size > (1n)//2"]
    assert a.fields == ("decided",)
    assert [r.render(a.guards) for r in a.rules] == [
        "r0: {} -> {decided} when size > (1n)//2"
    ]
    assert a.resilience == (2, "n > 2f")


def test_two_thirds_fixture_golden():
    a = _extract_fixture("tfix-two-thirds")
    assert _guard_exprs(a) == ["size > (2n)//3"]
    assert a.resilience == (3, "n > 3f")
    assert len(a.rules) == 1


def test_plurality_fixture_golden():
    """Relative threshold: two counts, coefficients (2, -1), bound 0."""
    a = _extract_fixture("tfix-plurality")
    (thr,) = [g.threshold for g in a.thresholds()]
    assert thr.op == "gt"
    assert sorted(zip(thr.counts, thr.coeffs)) == [
        ("size", -1), ("support[x]", 2)]
    assert (thr.a, thr.b, thr.d) == (0, 0, 1)


def test_fold_probe_fixture_golden():
    """The FoldRound go_ahead probe extracts like a plain majority round."""
    a = _extract_fixture("tfix-fold-probe")
    assert _guard_exprs(a) == ["size > (1n)//2"]
    assert [r.render(a.guards) for r in a.rules] == [
        "r0: {} -> {decided} when size > (1n)//2"
    ]


def test_negative_fixture_refused_not_misextracted():
    with pytest.raises(ThresholdExtractionError) as ei:
        extract_automaton_from(
            _fixture("tfix-data-bound").build_at, "tfix-data-bound",
            LINT_SAMPLES, strict=True, device=CPU)
    assert "data-dependent" in str(ei.value)


def test_lint_rule_flags_negative_and_passes_positive():
    assert threshold_rules(_fixture("tfix-majority"), CPU) == []
    findings = threshold_rules(_fixture("tfix-data-bound"), CPU)
    assert findings, "the data-dependent fixture must produce findings"
    assert all(f.rule.startswith("threshold-extractable/")
               for f in findings)
    assert any("data-dependent" in f.rule for f in findings)
    # anchored to the round's update (actionable), with a fix hint
    assert all(f.file.endswith("threshold_fixtures.py") for f in findings)
    assert all(f.hint for f in findings)


@pytest.mark.parametrize("name", [e.name for e in THRESHOLD_FIXTURES])
def test_fixture_automaton_equals_round_tpus(name):
    """Both packages' extraction of a fixture: the same automaton (or the
    same refusal, problem for problem)."""
    r_entry = r_tfx.THRESHOLD_FIXTURES_BY_NAME[name]
    ra, rp = r_threshold.extract_automaton_from(
        r_entry.build_at, name, r_threshold.LINT_SAMPLES, strict=False)
    pa, pp = extract_automaton_from(
        _fixture(name).build_at, name, LINT_SAMPLES, strict=False,
        device=CPU)
    assert (pa.to_dict() if pa else None) == (ra.to_dict() if ra else None)
    assert [(p.rule, p.round, p.message) for p in pp] == \
        [(p.rule, p.round, p.message) for p in rp]


# -- flagship protocol goldens (extracted from the port's aten graphs) -----

def test_otr_automaton_golden():
    a = extract_automaton("otr", device=CPU)
    assert a.resilience == (3, "n > 3f")
    assert a.fields == ("decided",)
    # the one-third rule, recovered from the traces: both the update
    # quorum and the decision support threshold are > 2n/3
    assert _guard_exprs(a) == ["size > (2n)//3", "support[x] > (2n)//3"]
    assert [r.render(a.guards) for r in a.rules] == [
        "r0: {} -> {decided} when size > (2n)//3 & support[x] > (2n)//3"
    ]


def test_otr_hist_automaton_golden():
    """The histogram fast path decides on the max of the value-support
    histogram — same thresholds, max_support count kind."""
    a = extract_automaton("otr-hist", samples=LINT_SAMPLES, device=CPU)
    assert _guard_exprs(a) == ["max_support[x] > (2n)//3",
                               "size > (2n)//3"]


def test_lastvoting_automaton_golden():
    a = extract_automaton("lastvoting", device=CPU)
    assert a.resilience == (2, "n > 2f")
    assert a.fields == ("commit", "decided", "ready")
    exprs = _guard_exprs(a)
    # collect majority, ack majority over phase-stamped senders, and the
    # first-phase bootstrap
    assert "size > (1n)//2" in exprs
    assert "support[ts] > (1n)//2" in exprs
    assert "size > 0" in exprs
    rendered = [r.render(a.guards) for r in a.rules]
    assert ("r0: {} -> {commit} when id == coord(r) & size > (1n)//2"
            in rendered)
    assert ("r2: {commit} -> {commit,ready} when id == coord(r) & "
            "support[ts] > (1n)//2" in rendered)
    assert "r3: {commit,ready} -> {decided} when heard(coord(r))" in rendered
    # round 1 (propose/adopt) changes only data fields — no control rules
    assert not any(r.round == 1 for r in a.rules)
    # decided is absorbing in every rule
    for r in a.rules:
        if dict(r.src).get("decided"):
            assert dict(r.dst).get("decided")


@pytest.mark.parametrize("model", ["otr", "otr-hist", "lastvoting"])
def test_protocol_automaton_equals_round_tpus(model):
    """OTR's one rule and LastVoting's four-round skeleton: the port's
    automaton over DEFAULT_SAMPLES is round_tpu's, guard names included
    (the guard table numbers every comparison a round registers)."""
    assert extract_automaton(model, device=CPU).to_dict() == \
        r_threshold.extract_automaton(model).to_dict()


def test_unregistered_model_is_refused():
    with pytest.raises(ThresholdExtractionError) as ei:
        extract_automaton("cgol", device=CPU)  # no build_at: out of scope
    assert "build_at" in str(ei.value)


def test_automaton_to_dict_roundtrips_render():
    a = extract_automaton("otr", samples=LINT_SAMPLES, device=CPU)
    d = a.to_dict()
    assert d["protocol"] == "otr"
    assert d["resilience"] == "n > 3f"
    assert d["rules"][0]["src"] == {"decided": False}
    assert d["rules"][0]["dst"] == {"decided": True}
    assert all("//3" in g for g in d["rules"][0]["guard"])


def test_extraction_traces_on_the_card_by_default():
    """The entry points trace on the card unless the caller names a
    device; where torch finds none they raise, never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default traces there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        extract_automaton_from(_fixture("tfix-majority").build_at,
                               "tfix-majority", LINT_SAMPLES)


# -- the threshold-extractable family over the registry ---------------------

def _threshold_findings(findings):
    return sorted((f.rule, f.severity, os.path.basename(f.file), f.message)
                  for f in findings)


@pytest.mark.parametrize(
    "name", [e.name for e in r_registry.REGISTRY
             if e.name not in ("lastvoting-event", "pbft-vc")])
def test_threshold_rules_equal_round_tpus(name):
    """Every registered model's threshold-extractable findings, as
    round_tpu's (rule, severity, file name, message); the two slowest
    models are held in tests/test_torch_analysis.py through lint_model."""
    assert _threshold_findings(
        threshold_rules(p_registry.get(name), CPU)) == \
        _threshold_findings(r_threshold.threshold_rules(
            r_registry.get(name)))
