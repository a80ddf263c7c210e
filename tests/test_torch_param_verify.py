"""Parameterized verification in the port (round_tpu_torch/verify/param.py,
apps/verifier_cli.py and the default license prover) against round_tpu's.

round_tpu's tests/test_param_verify.py run over the port (its markers
kept: the federated-dispatch subprocess A/B is ``slow``), plus the twins'
comparison: the port's param VCs carry round_tpu's names, print equal
under verify/extract.py::canon (round_tpu's side is built, not solved —
its own test proves it), and every port verdict is PROVED; every suite's
VC-hash cache key equals round_tpu's; the CLI handles its arguments as
round_tpu's; the default license prover licenses and refuses as round_tpu's
test asserts with a scripted prover.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from round_tpu.apps import verifier_cli as r_cli
from round_tpu.verify import param as r_param
from round_tpu.verify.printer import pretty as r_pretty
from round_tpu_torch.apps import verifier_cli as p_cli
from round_tpu_torch.verify.extract import canon
from round_tpu_torch.verify.param import (
    PARAM_SUITES, build_param_suite, generate_param_vcs, run_param_suite,
    threshold_applied,
)
from round_tpu_torch.verify.printer import pretty

torch.set_num_threads(1)

pytestmark = pytest.mark.verify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


# -- VC generation shape ----------------------------------------------------

def test_generated_vc_matrix_shape_otr():
    automaton, vcs = build_param_suite("param-otr", CPU)
    names = [vc.name for vc in vcs]
    # two quorum guards → 2 enabledness pairs, 3 intersection pairs
    # (each with the >f byzantine form under n > 3f), 2 no-faulty-quorum,
    # 1 counter rule, 2 structural, 4 cross-checks
    assert sum("correct processes fire" in n for n in names) == 2
    assert sum("good-HO round enables" in n for n in names) == 2
    assert sum("quorums intersect" in n for n in names) == 3
    assert sum("exceeds the fault budget" in n for n in names) == 3
    assert sum("no faulty-only quorum" in n for n in names) == 2
    assert sum(n.startswith("counters:") for n in names) == 1
    assert sum(n.startswith("structure:") for n in names) == 2
    assert sum(n.startswith("cross-check:") for n in names) == 4
    assert len(vcs) == 19


def test_generated_vc_matrix_shape_lv():
    automaton, vcs = build_param_suite("param-lv", CPU)
    names = [vc.name for vc in vcs]
    # majority envelope (n > 2f): intersection lemmas are the >= 1 form
    # only — no byzantine >f rows
    assert sum("quorums intersect" in n for n in names) == 3
    assert sum("exceeds the fault budget" in n for n in names) == 0
    assert sum(n.startswith("cross-check:") for n in names) == 3
    # every (src, dst) location move gets one conservation VC
    assert sum(n.startswith("counters:") for n in names) == len(
        {(r.src, r.dst) for r in automaton.rules if r.src != r.dst})
    assert len(vcs) == 32


def _prints(vcs, pp):
    out = []
    for vc in vcs:
        if vc.check is None:
            out.append([pp(vc.hyp), pp(vc.concl), repr(vc.config),
                        vc.origin])
        else:
            out.append([vc.origin])
    return out


@pytest.mark.parametrize("suite", sorted(PARAM_SUITES))
def test_param_vcs_equal_round_tpus(suite):
    """The port's suite is round_tpu's: the same automaton, the same VC
    names in the same order, and each VC's hypothesis and conclusion
    print the same under canon (round_tpu's side built, not solved)."""
    pa, pvcs = build_param_suite(suite, CPU)
    ra, rvcs = r_param.build_param_suite(suite)
    assert pa.to_dict() == ra.to_dict()
    assert [v.name for v in pvcs] == [v.name for v in rvcs]
    for p, r in zip(_prints(pvcs, pretty), _prints(rvcs, r_pretty)):
        assert canon(p) == canon(r)


def test_threshold_applied_floor_elimination():
    """count > floor((2n)/3) must export as 3*count > 2n (integrality)."""
    from round_tpu_torch.analysis.threshold import Threshold
    from round_tpu_torch.verify.formula import (
        Card, FSet, Variable, procType,
    )

    thr = Threshold(op="gt", counts=("size",), coeffs=(1,), a=2, b=0, d=3)
    A = Variable("A", FSet(procType))
    s = pretty(threshold_applied(thr, [Card(A)]))
    assert "3" in s and "2" in s and "|A|" in s
    from round_tpu.analysis.threshold import Threshold as RThreshold
    from round_tpu.verify.formula import (
        Card as RCard, FSet as RFSet, Variable as RVariable,
        procType as rprocType,
    )

    r = r_pretty(r_param.threshold_applied(
        RThreshold(op="gt", counts=("size",), coeffs=(1,), a=2, b=0, d=3),
        [RCard(RVariable("A", RFSet(rprocType)))]))
    assert s == r


def test_missing_envelope_is_an_error():
    from round_tpu_torch.analysis.threshold import extract_automaton
    import dataclasses

    automaton = extract_automaton("otr", samples=(5, 7, 9), device=CPU)
    stripped = dataclasses.replace(automaton, resilience=None)
    with pytest.raises(ValueError, match="fault envelope"):
        generate_param_vcs(stripped)


# -- the all-n proofs (the acceptance surface) ------------------------------

def test_param_otr_all_n_proved():
    """OTR safe/live lemmas for ALL n under n > 3f, from the extracted
    automaton, cross-checked against protocols.otr_spec's proven
    invariant (both entailment directions)."""
    ok, results = run_param_suite("param-otr", quiet=True, device=CPU)
    failed = [r.name for r in results if not r.ok]
    assert ok, f"NOT PROVED: {failed}"
    assert any("cross-check" in r.name for r in results)
    assert len(results) == 1 + 19  # the extraction, then every VC


def test_param_lv_all_n_proved():
    """LastVoting majority lemmas for ALL n under n > 2f, cross-checked
    against the lv_spec anchor/stamp majorities the staged chains use."""
    ok, results = run_param_suite("param-lv", quiet=True, device=CPU)
    failed = [r.name for r in results if not r.ok]
    assert ok, f"NOT PROVED: {failed}"
    assert len(results) == 1 + 32


def test_lv_cross_check_rejects_misfitted_threshold():
    """The LV cross-checks anchor against the LITERAL protocols.py
    formulas, so a mis-extracted threshold must FAIL them — the negative
    control that keeps the cross-check from being self-referential."""
    import dataclasses

    from round_tpu_torch.analysis.threshold import extract_automaton
    from round_tpu_torch.verify.param import _lv_cross_vcs, solve_param_vc

    auto = extract_automaton("lastvoting", device=CPU)
    bad_guards = {}
    for name, g in auto.guards.items():
        if g.threshold and any("ts" in c for c in g.threshold.counts):
            g = dataclasses.replace(
                g, threshold=dataclasses.replace(g.threshold, d=3, a=1))
        bad_guards[name] = g
    bad = dataclasses.replace(auto, guards=bad_guards)
    vcs = _lv_cross_vcs(bad)
    r = solve_param_vc(vcs[0])  # ack guard weakened to > n/3
    assert not r.ok, "a > n/3 ack fit must not entail the stamp majority"


# -- federated dispatch and the cache keys ----------------------------------

def test_suite_vc_hash_stable_across_builds():
    """Rebuilding a spec creates fresh payload-fn symbols (id-derived
    suffixes); the hash must normalize them or the cache never hits."""
    assert p_cli.suite_vc_hash("tpc") == p_cli.suite_vc_hash("tpc")


@pytest.mark.parametrize("suite", r_cli.ALL_SUITES)
def test_suite_vc_hash_equals_round_tpus(suite):
    """Every suite's cache key is round_tpu's, so one warm cache serves
    both packages (the extracted lemma suites' counter-made suffixes
    differ; their first-occurrence order does not)."""
    assert p_cli.suite_vc_hash(suite, CPU) == r_cli.suite_vc_hash(suite)


def test_param_suites_registered_in_cli():
    assert set(PARAM_SUITES) == set(p_cli._PARAM_SUITES)
    for s in PARAM_SUITES:
        assert s in p_cli.ALL_SUITES
    assert p_cli.ALL_SUITES == r_cli.ALL_SUITES
    assert set(p_cli._LEMMA_SUITES) == set(r_cli._LEMMA_SUITES)
    assert set(p_cli._spec_registry()) == set(r_cli._spec_registry())


def test_cli_rejects_unknown_suites():
    for cli in (p_cli, r_cli):
        with pytest.raises(SystemExit):
            cli.main(["--suites", "nope"])
        with pytest.raises(SystemExit):
            cli.main(["--all", "tpc"])


def test_cli_cache_round_trip(tmp_path, capsys):
    """--suites param-otr --json --cache over the CPU: PROVED and stored
    cold, a cache hit warm; round_tpu's lookup of the same directory hits
    the record the port stored (one key for both packages)."""
    cache, out = str(tmp_path / "cache"), str(tmp_path / "rep.json")
    argv = ["--suites", "param-otr", "--json", out, "--cache", cache,
            "--device", CPU]
    assert p_cli.main(argv)
    cold = json.load(open(out))
    assert cold["all_ok"] and cold["cache"]["misses"] == 1
    (rec,) = cold["suites"]
    assert rec["ok"] and len(rec["stages"]) == 1 + 19
    assert p_cli.main(argv)
    warm = json.load(open(out))
    assert warm["cache"]["hits"] == 1 and warm["suites"][0]["cached"]
    digest, hit = r_cli._cache_lookup(cache, "param-otr")
    assert hit is not None and hit["ok"] and digest == rec["vc_hash"]
    capsys.readouterr()


# -- the default license prover ---------------------------------------------

def test_default_license_prover_verdicts(tmp_path):
    """round_tpu's tests/test_rv.py verdicts (asserted there with a
    scripted prover), here from the default prover solving on the CPU:
    otr at n=4, lv at 5 and lvb at 9 licensed, otr at 3 outside its
    envelope, benor unlicensed; then a registry on the same cache,
    cache-only, licenses from the cache."""
    from round_tpu_torch.rv.license import ProofLicenseRegistry

    cache = str(tmp_path / "cache")
    reg = ProofLicenseRegistry(cache_dir=cache, device=CPU)
    lic = reg.check("otr", 4)
    assert lic.ok and lic.suite == "param-otr" \
        and lic.envelope == "n > 3f" and lic.f_max == 1 \
        and lic.cached is False
    assert reg.check("otr", 3).status == "outside-envelope"
    assert reg.check("lv", 5).ok
    lvb = reg.check("lvb", 9)
    assert lvb.ok and lvb.model == "lastvoting" \
        and lvb.envelope == "n > 2f" and lvb.f_max == 4
    assert reg.check("benor", 9).status == "unlicensed"
    warm = ProofLicenseRegistry(cache_dir=cache, solve=False, device=CPU)
    for algo, n in (("otr", 4), ("lv", 5)):
        lic = warm.check(algo, n)
        assert lic.ok and lic.cached is True


@pytest.mark.slow
def test_federated_dispatch_end_to_end(tmp_path):
    """The CLI A/B the soak rung runs continuously: jobs=1 vs jobs=2 over
    a real suite subset, identical verdicts, JSON report shape, and a
    100% cache hit rate on the warm rerun."""
    cache = str(tmp_path / "cache")

    def sweep(jobs, use_cache):
        out = str(tmp_path / f"rep-{jobs}-{use_cache}.json")
        cmd = [sys.executable, "-m", "round_tpu_torch.apps.verifier_cli",
               "--suites", "tpc,param-otr,param-lv", "--jobs", str(jobs),
               "--json", out, "--device", CPU]
        if use_cache:
            cmd += ["--cache", cache]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, cwd=REPO)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        with open(out) as fh:
            return json.load(fh)

    seq = sweep(1, use_cache=False)
    par = sweep(2, use_cache=True)    # cold cache: fills
    warm = sweep(2, use_cache=True)   # warm: must hit

    def verdicts(doc):
        return {s["name"]: s["ok"] for s in doc["suites"]}

    assert seq["all_ok"] and par["all_ok"] and warm["all_ok"]
    assert verdicts(seq) == verdicts(par) == verdicts(warm)
    assert warm["cache"]["hits"] == len(warm["suites"])
    for s in seq["suites"]:
        assert s["stages"], f"suite {s['name']} reported no stages"
        assert all("seconds" in st for st in s["stages"])
