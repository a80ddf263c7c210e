"""The port's apps/selector.py against round_tpu/apps/selector.py: every
name gives the same algorithm class with the same round count, rounds and
options; the test-fixture prefixes raise instead of passing as unknown."""

import pytest
import torch

from round_tpu.apps import selector as jselector
from round_tpu_torch.apps import selector as tselector

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

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
    """The fixture prefixes load their fixtures as round_tpu's selector
    does (same rounds, envelope and Spec labels); a name under either
    prefix that names no fixture raises round_tpu's error."""
    from round_tpu_torch.rv.fixtures import FIXTURES as RV
    from round_tpu_torch.snap.fixtures import FIXTURES as SNAP

    for fixture in (*RV, *SNAP):
        got, want = tselector.select(fixture), jselector.select(fixture)
        assert [type(r).__name__ for r in got.rounds] == \
            [type(r).__name__ for r in want.rounds]
        assert got.fault_envelope == want.fault_envelope
        assert got.adopt_decision(None, 1) is None
    if name in RV:
        assert type(tselector.select(name).rounds[0]).__name__ == \
            type(jselector.select(name).rounds[0]).__name__
        return
    with pytest.raises(ValueError) as want:
        jselector.select(name)
    with pytest.raises(ValueError) as got:
        tselector.select(name)
    assert str(got.value) == str(want.value)


def test_unknown_name_raises_like_jax():
    with pytest.raises(ValueError) as want:
        jselector.select("paxos")
    with pytest.raises(ValueError) as got:
        tselector.select("paxos")
    assert str(got.value) == str(want.value)
