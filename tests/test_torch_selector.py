"""The port's apps/selector.py against round_tpu/apps/selector.py: every
name gives the same algorithm class with the same round count, rounds and
options; the test-fixture prefixes raise instead of passing as unknown."""

import pytest

from round_tpu.apps import selector as jselector
from round_tpu_torch.apps import selector as tselector

CASES = [
    ("otr", None), ("otr", {"after_decision": 5}),
    ("lv", None), ("lastvoting", None),
    ("lvb", None), ("lastvoting-bytes", {"payload_bytes": 64}),
    ("lastvotingbytes", None),
    ("lve", None), ("lastvotingevent", None),
    ("slv", None), ("short", None),
    ("mlv", None), ("multi", None),
    ("benor", None),
    ("floodmin", None), ("floodmin", {"f": 3}),
    ("kset", None), ("kset", {"k": 4}),
    ("tpc", None),
    ("pbft", None), ("pbft", {"synchronized": True}),
    ("pbft-vc", None), ("pbftvc", None), ("PBFT-VC", None),
]
OPTION_ATTRS = ("after_decision", "payload_bytes", "f", "k", "t")


@pytest.mark.parametrize("name,options", CASES,
                         ids=[f"{n}-{o}" for n, o in CASES])
def test_select_matches_jax(name, options):
    want = jselector.select(name, options)
    got = tselector.select(name, options)
    assert type(got).__name__ == type(want).__name__
    assert got.rounds_per_phase == want.rounds_per_phase
    assert [type(r).__name__ for r in got.rounds] == \
        [type(r).__name__ for r in want.rounds]
    for attr in OPTION_ATTRS:
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    for attr in ("fault_envelope", "adversary_model", "decision_null"):
        assert getattr(got, attr) == getattr(want, attr), attr
    if name.lower().startswith("pbft") and not name.lower().endswith("vc"):
        inner = [type(getattr(r, "inner", r)).__name__ for r in got.rounds]
        assert inner == ["BcpPrePrepare", "BcpPrepare", "BcpCommit"]


def test_every_name_is_covered():
    assert set(tselector.NAMES) <= {n.lower() for n, _ in CASES}


@pytest.mark.parametrize("name", ["rv-broken-agreement", "snap-broken-x",
                                  "RV-BROKEN-anything"])
def test_fixture_prefixes_raise_with_a_reason(name):
    with pytest.raises(ValueError, match="not ported those packages"):
        tselector.select(name)


def test_unknown_name_raises_like_jax():
    with pytest.raises(ValueError) as want:
        jselector.select("paxos")
    with pytest.raises(ValueError) as got:
        tselector.select("paxos")
    assert str(got.value) == str(want.value)
