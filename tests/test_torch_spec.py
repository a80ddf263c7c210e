"""Port parity: the spec checker (round_tpu_torch.spec against round_tpu.spec).

round_tpu records a trace (run_instance with record_fn) and replays its HO
schedule; the trace, the initial state and the HO matrices cross over
through numpy and round_tpu_torch.interop, and the port's check_trace must
give the same report, step for step, as round_tpu's: every invariant of
the chain, any_invariant, the safety predicate, every property and the
round invariants.  Cases: OTR, FloodMin (under a spec written in the test,
since round_tpu states none for it), Ben-Or and LastVoting, plus a
corrupted trace on which properties fail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import scenarios as jscen
from round_tpu.engine.executor import (
    LocalTopology as JLocalTopology, init_lanes as jinit_lanes,
    run_instance as jrun_instance,
)
from round_tpu.models.benor import BenOr as JBenOr
from round_tpu.models.common import consensus_io as jconsensus_io
from round_tpu.models.floodmin import FloodMin as JFloodMin
from round_tpu.models.lastvoting import LastVoting as JLastVoting
from round_tpu.models.otr import OTR as JOTR
from round_tpu.spec import check as jcheck
from round_tpu.spec import dsl as jdsl
from round_tpu_torch import interop
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.models.benor import BenOrSpec
from round_tpu_torch.models.lastvoting import LVSpec
from round_tpu_torch.models.otr import OtrSpec
from round_tpu_torch.spec import check as tcheck
from round_tpu_torch.spec import dsl as tdsl

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

OTR_FIELDS = ("x", "decided", "decision", "after")
FM_FIELDS = ("x", "decided", "decision")
BENOR_FIELDS = ("x", "can_decide", "vote", "decided", "decision")
LV_FIELDS = ("x", "ts", "ready", "commit", "vote", "decided", "decision")


def _floodmin_spec(dsl):
    """A FloodMin spec, written once for either DSL: estimates stay initial
    values, a decision is the decider's estimate, every process hears
    itself (the safety predicate, over HO), and the consensus
    properties."""
    implies = dsl.implies

    class FloodMinSpec(dsl.Spec):
        def __init__(self):
            self.safety_predicate = lambda e: e.P.forall(
                lambda p: p.HO.contains(p))
            self.invariants = (
                lambda e: e.P.forall(
                    lambda i: e.P.exists(lambda j: i.x == j.init.x)),
                lambda e: e.P.forall(
                    lambda i: implies(i.decided, i.decision == i.x)),
            )
            self.properties = (
                ("Agreement", lambda e: e.P.forall(lambda i: e.P.forall(
                    lambda j: implies(i.decided & j.decided,
                                      i.decision == j.decision)))),
                ("Termination", lambda e: e.P.forall(lambda i: i.decided)),
            )

    return FloodMinSpec()


def _otr():
    n = 7
    algo = JOTR()
    return (algo, algo.spec, OtrSpec(), jconsensus_io(jnp.arange(n) % 3), n,
            jscen.omission(n, 0.2), 6, 1, interop.otr_state_from_numpy,
            OTR_FIELDS)


def _floodmin():
    n = 6
    algo = JFloodMin(2)
    return (algo, _floodmin_spec(jdsl), _floodmin_spec(tdsl),
            jconsensus_io((jnp.arange(n) * 5) % 11), n, jscen.crash(n, 2), 4,
            1, interop.floodmin_state_from_numpy, FM_FIELDS)


def _benor():
    n = 6
    algo = JBenOr()
    return (algo, algo.spec, BenOrSpec(), jconsensus_io(jnp.arange(n) % 2),
            n, jscen.omission(n, 0.25), 4, 2, interop.benor_state_from_numpy,
            BENOR_FIELDS)


def _lastvoting():
    n = 5
    algo = JLastVoting()
    return (algo, algo.spec, LVSpec(), jconsensus_io(jnp.arange(n) + 3), n,
            jscen.omission(n, 0.15), 3, 4, interop.lv_state_from_numpy,
            LV_FIELDS)


def _record(case, seed):
    """round_tpu's recorded trace, initial state and HO schedule."""
    algo, jspec, tspec, io, n, sampler, phases, k, convert, fields = case()
    key = jax.random.PRNGKey(seed)
    res = jrun_instance(algo, io, n, key, sampler, phases,
                        record_fn=lambda s, d, r: s)
    state0 = jinit_lanes(algo, io, n, JLocalTopology(n))
    ho = jcheck.replay_ho(key, sampler, res.rounds_run)
    return jspec, tspec, n, k, convert, fields, res.recorded, state0, ho


def _to_port(convert, fields, state):
    return convert({f: np.asarray(getattr(state, f)) for f in fields},
                   device="cpu")


def _assert_same_report(got, want):
    np.testing.assert_array_equal(got.invariant_held.numpy(),
                                  np.asarray(want.invariant_held))
    np.testing.assert_array_equal(got.any_invariant.numpy(),
                                  np.asarray(want.any_invariant))
    np.testing.assert_array_equal(got.safety_ok.numpy(),
                                  np.asarray(want.safety_ok))
    assert set(got.properties) == set(want.properties)
    for name, vals in want.properties.items():
        np.testing.assert_array_equal(got.properties[name].numpy(),
                                      np.asarray(vals), err_msg=name)
        assert bool(got.final_properties[name]) == bool(
            want.final_properties[name])
    if want.round_invariant_ok is None:
        assert got.round_invariant_ok is None
    else:
        np.testing.assert_array_equal(got.round_invariant_ok.numpy(),
                                      np.asarray(want.round_invariant_ok))
    assert bool(got.all_safety_properties_hold()) == bool(
        want.all_safety_properties_hold())


@pytest.mark.parametrize("case,seed", [(_otr, 0), (_otr, 5), (_floodmin, 1),
                                       (_benor, 2), (_benor, 9),
                                       (_lastvoting, 3)])
def test_check_trace_matches_jax(case, seed):
    jspec, tspec, n, k, convert, fields, trace, state0, ho = _record(case,
                                                                     seed)
    want = jcheck.check_trace(jspec, trace, state0, n, ho=ho,
                              rounds_per_phase=k)
    got = tcheck.check_trace(tspec, _to_port(convert, fields, trace),
                             _to_port(convert, fields, state0), n,
                             ho=torch.as_tensor(np.array(ho)),
                             rounds_per_phase=k)
    _assert_same_report(got, want)


def test_check_trace_on_a_corrupted_trace():
    """One lane's decision flipped from the middle of an OTR trace on: both
    checkers see Agreement, Irrevocability and the invariants fail at the
    same steps."""
    jspec, tspec, n, k, convert, fields, trace, state0, ho = _record(_otr, 0)
    T = trace.x.shape[0]
    bad = trace.replace(
        decided=trace.decided.at[T // 2:, 0].set(True),
        decision=trace.decision.at[T // 2:, 0].set(2))
    bad = bad.replace(decision=bad.decision.at[T // 2:, 1].set(1),
                      decided=bad.decided.at[T // 2:, 1].set(True))
    want = jcheck.check_trace(jspec, bad, state0, n, ho=ho)
    got = tcheck.check_trace(tspec, _to_port(convert, fields, bad),
                             _to_port(convert, fields, state0), n,
                             ho=torch.as_tensor(np.array(ho)))
    _assert_same_report(got, want)
    assert not bool(np.asarray(want.properties["Agreement"]).all())


def test_check_cut_matches_jax():
    """check_cut (the offline formulas on one snapshot) at every step of a
    LastVoting trace: same labels, same verdicts, same not-evaluable
    (None) entries."""
    jspec, tspec, n, k, convert, fields, trace, state0, _ho = _record(
        _lastvoting, 3)
    tinit = _to_port(convert, fields, state0)
    for r in range(trace.x.shape[0]):
        cut = jax.tree_util.tree_map(lambda a: a[r], trace)
        want = jcheck.check_cut(jspec, cut, n, r, init0=state0,
                                rounds_per_phase=k)
        got = tcheck.check_cut(tspec, _to_port(convert, fields, cut), n, r,
                               init0=tinit, rounds_per_phase=k)
        assert got == want
    # without an init snapshot the chain is not evaluable in either
    cut = jax.tree_util.tree_map(lambda a: a[0], trace)
    assert tcheck.check_cut(tspec, _to_port(convert, fields, cut), n, 0) == \
        jcheck.check_cut(jspec, cut, n, 0)


@pytest.mark.parametrize("pair", [
    (lambda: JOTR().spec, OtrSpec), (lambda: JBenOr().spec, BenOrSpec),
    (lambda: JLastVoting().spec, LVSpec),
    (lambda: _floodmin_spec(jdsl), lambda: _floodmin_spec(tdsl)),
])
def test_spec_formulas_enumerate_alike(pair):
    """Same labels, kinds, names, groups and scopes in the same order."""
    want = jcheck.spec_formulas(pair[0]())
    got = tcheck.spec_formulas(pair[1]())
    assert [(f.label, f.kind, f.name, f.group, f.scope) for f in got] == \
        [(f.label, f.kind, f.name, f.group, f.scope) for f in want]


@pytest.mark.parametrize("p_drop,rounds", [(0.1, 5), (0.5, 3)])
def test_replay_ho_matches_jax_sampler(p_drop, rounds):
    """The port's replay_ho over its hash sampler gives round_tpu's masks
    when the port's key is the salts of round_tpu's HO key (round_tpu
    splits the scenario key first; the port hands its key over as is)."""
    n = 9
    key = jax.random.PRNGKey(17)
    want = jcheck.replay_ho(key, jscen.omission(n, p_drop), rounds)
    ho_key = np.asarray(jax.random.split(key)[0]).astype(np.uint32)
    got = tcheck.replay_ho((int(ho_key[0]), int(ho_key[1])),
                           tscen.omission(n, p_drop, device="cpu"), rounds)
    assert got.shape == (rounds, n, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unknown_field_names_the_formula():
    class Typo(tdsl.Spec):
        def __init__(self):
            self.invariants = (lambda e: e.P.forall(lambda i: i.nope > 0),)

    _jspec, _tspec, n, _k, convert, fields, trace, state0, _ho = _record(
        _otr, 0)
    with pytest.raises(tdsl.SpecFieldError, match=r"'nope'.*invariants\[0\]"):
        tcheck.check_trace(Typo(), _to_port(convert, fields, trace),
                           _to_port(convert, fields, state0), n)
