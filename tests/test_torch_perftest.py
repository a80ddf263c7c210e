"""Port parity of the runtime's apps (round_tpu_torch/apps/perftest.py,
round_tpu_torch/apps/dynamic_membership.py).

``perftest.run`` at n=4, 64 instances, ``-rt`` 16 under a drop-free
network (``--p-drop 0`` is ``scenarios.full``) writes the same decision
TSV, byte for byte, as round_tpu's, so the digests agree; the CLI takes
round_tpu's flags with ``--device`` for ``--platform``; and
``MembershipManager`` decides an add and a remove to the same directory
and view numbers."""

import json

import pytest
import torch

from round_tpu.apps import dynamic_membership as jdm
from round_tpu.apps import perftest as jperf
from round_tpu.runtime.config import Options as JOptions
from round_tpu.runtime.decisions import DecisionLog as JDecisionLog
from round_tpu.runtime.membership import Directory as JDirectory
from round_tpu.runtime.membership import local_group as jlocal_group
from round_tpu.runtime.stats import stats as jstats
from round_tpu_torch.apps import dynamic_membership as tdm
from round_tpu_torch.apps import perftest as tperf
from round_tpu_torch.obs.trace import TRACE as TTRACE
from round_tpu_torch.runtime.config import Options as TOptions
from round_tpu_torch.runtime.decisions import DecisionLog as TDecisionLog
from round_tpu_torch.runtime.membership import Directory as TDirectory
from round_tpu_torch.runtime.membership import local_group as tlocal_group
from round_tpu_torch.runtime.stats import stats as tstats

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def quiet_globals():
    """--stat, --metrics-json and --trace switch on process-wide
    collectors; switch them off again after each test."""
    yield
    jstats.enabled = tstats.enabled = False
    TTRACE.disable()


@pytest.mark.parametrize("algo", ["otr", "lv"])
def test_perftest_run_matches_round_tpu(tmp_path, algo):
    kw = dict(n=4, rate=16, max_phases=6, algorithm=algo)
    jlog, tlog = str(tmp_path / "j.tsv"), str(tmp_path / "t.tsv")
    jout = jperf.run(JOptions(log_file=jlog, **kw), n_instances=64,
                     p_drop=0.0)
    into = TDecisionLog()
    tout = tperf.run(TOptions(log_file=tlog, **kw), n_instances=64,
                     p_drop=0.0, device="cpu", log=into)
    assert (tout["decided"], tout["total"]) == (jout["decided"],
                                                jout["total"]) == (64, 64)
    with open(tlog, "rb") as a, open(jlog, "rb") as b:
        assert a.read() == b.read()
    assert into.digest() == JDecisionLog.load_tsv(jlog).digest()
    assert tout["decisions_per_s"] > 0


def test_perftest_cli_matches_round_tpu(tmp_path, capsys):
    common = ["-a", "otr", "-n", "4", "-rt", "16", "--instances", "40",
              "--p-drop", "0", "--max-phases", "5"]
    outs = {}
    for name, mod, extra in (("j", jperf, ["--platform", "cpu"]),
                             ("t", tperf, ["--device", "cpu"])):
        outs[name] = mod.main(common + extra + [
            "--log", str(tmp_path / f"{name}.tsv"),
            "--metrics-json", str(tmp_path / f"{name}.json")])
    assert "'decided': 40" in capsys.readouterr().out
    assert outs["t"]["decided"] == outs["j"]["decided"] == 40
    assert (tmp_path / "t.tsv").read_bytes() == \
        (tmp_path / "j.tsv").read_bytes()
    metrics = json.loads((tmp_path / "t.json").read_text())
    assert metrics["gauges"]["engine.decisions_per_sec"] > 0
    # three windows of 16, 16 and 8 (the count is process-wide)
    assert metrics["histograms"]["engine.run"]["count"] >= 3
    trace = tmp_path / "t.jsonl"
    tperf.main(common + ["--device", "cpu", "--trace", str(trace)])
    kinds = [json.loads(line)["ev"]
             for line in trace.read_text().splitlines()]
    assert kinds.count("decision") == 40 and "ho_stats" in kinds


def test_membership_manager_add_and_remove_match_round_tpu():
    out = []
    for Directory, local_group, mod, kw in (
            (JDirectory, jlocal_group, jdm, {}),
            (TDirectory, tlocal_group, tdm, {"device": "cpu"})):
        d = Directory(local_group(4))
        mm = mod.MembershipManager(d, **kw)
        got = [mm.propose(mod.ADD, 4450), mm.propose(mod.REMOVE, 1)]
        out.append((got, mm.view_nbr, [(r.id, r.address, r.port)
                                       for r in d.group.replicas]))
    assert out[0] == out[1]
    assert out[1][0] == [(tdm.ADD, 4450), (tdm.REMOVE, 1)]
    assert out[1][1] == 2 and len(out[1][2]) == 4
