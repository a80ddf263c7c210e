"""Port parity: the engines of the flagship slice, end to end on the CPU.

The port's run_hist(OtrHist), run_otr_loop and general engine
(run_instance(OTR) over from_mix_row) are held bit for bit (tolerance 0)
against round_tpu's on the same FaultMix, carried over through numpy and
round_tpu_torch.interop."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.engine import scenarios as jscen
from round_tpu.engine.executor import run_instance as jrun_instance
from round_tpu.models.common import consensus_io as jconsensus_io
from round_tpu.models.otr import OTR as JOTR, OtrState as JOtrState
from round_tpu_torch import interop
from round_tpu_torch.engine import executor as texecutor
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.models.common import consensus_io as tconsensus_io
from round_tpu_torch.models.otr import OTR as TOTR, OtrState as TOtrState
from round_tpu_torch.utils import benchstat

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

V = 8
N = 16
S = 12
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")
REPO = Path(__file__).resolve().parent.parent


def _port_mix(mix):
    return interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}, device="cpu")


def _mix_and_init(seed=7, p_drop=0.1):
    key = jax.random.PRNGKey(seed)
    mix = jfast.standard_mix(key, S, N, p_drop=p_drop, f=3, crash_round=1)
    init = jax.random.randint(jax.random.fold_in(key, 9), (N,), 0, V,
                              dtype=jnp.int32)
    return mix, init


def _assert_same(tstate, tdone, tdround, jstate, jdone, jdround):
    for name in ("x", "decided", "decision", "after"):
        np.testing.assert_array_equal(
            getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
            err_msg=name)
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tdround.numpy(), np.asarray(jdround))


@pytest.mark.parametrize("seed,p_drop", [(7, 0.1), (3, 0.3)])
def test_run_hist_matches_jax(seed, p_drop):
    mix, init = _mix_and_init(seed, p_drop)
    want = jfast.run_hist(jfast.OtrHist(V), JOtrState.fresh(init, S, N),
                          lambda s: s.decided, mix, max_rounds=6,
                          mode="hash", interpret=True)
    tinit = torch.as_tensor(np.array(init))
    got = tfast.run_hist(tfast.OtrHist(V), TOtrState.fresh(tinit, S, N),
                         lambda s: s.decided, _port_mix(mix), max_rounds=6,
                         mode="hash")
    _assert_same(*got, *want)


@pytest.mark.parametrize("seed,p_drop", [(7, 0.1), (3, 0.3)])
def test_run_otr_loop_matches_jax(seed, p_drop):
    mix, init = _mix_and_init(seed, p_drop)
    want = jfast.run_otr_loop(jfast.OtrHist(V), JOtrState.fresh(init, S, N),
                              mix, max_rounds=6, mode="hash", interpret=True)
    # the state crosses over through interop, as a JAX caller would hand it
    st0 = JOtrState.fresh(init, S, N)
    tst0 = interop.otr_state_from_numpy(
        {k: np.asarray(getattr(st0, k)) for k in
         ("x", "decided", "decision", "after")}, device="cpu")
    got = tfast.run_otr_loop(tfast.OtrHist(V), tst0, _port_mix(mix),
                             max_rounds=6, mode="hash")
    _assert_same(*got, *want)


def test_run_otr_loop_refuses_a_resumed_state():
    mix, init = _mix_and_init()
    st0 = TOtrState.fresh(torch.as_tensor(np.array(init)), S, N)
    for bad in (st0.replace(decided=st0.decided.clone().fill_(True)),
                st0.replace(after=st0.after - 1)):
        with pytest.raises(ValueError, match="fresh state0"):
            tfast.run_otr_loop(tfast.OtrHist(V), bad, _port_mix(mix), 4)


@pytest.mark.parametrize("seed", [7, 21])
def test_run_instance_matches_jax_on_every_row(seed):
    """The general engine over from_mix_row, every scenario row (the
    differential bridge of tests/test_fast.py:74-111), and the fused
    engines agree with it."""
    mix, init = _mix_and_init(seed)
    tmix = _port_mix(mix)
    tinit = torch.as_tensor(np.array(init))
    rounds = 6
    fast_state, _, fast_dround = tfast.run_hist(
        tfast.OtrHist(V), TOtrState.fresh(tinit, S, N), lambda s: s.decided,
        tmix, rounds, mode="hash")
    for s in range(S):
        want = jrun_instance(JOTR(2, V), jconsensus_io(init), N,
                             jax.random.fold_in(jax.random.PRNGKey(seed), s),
                             jscen.from_mix_row(mix, s), max_phases=rounds)
        got = texecutor.run_instance(TOTR(2, V), tconsensus_io(tinit), N,
                                     (s, seed), tscen.from_mix_row(tmix, s),
                                     rounds, device="cpu")
        _assert_same(got.state, got.done, got.decided_round,
                     want.state, want.done, want.decided_round)
        assert torch.equal(fast_state.decision[s], got.state.decision)
        assert torch.equal(fast_dround[s], got.decided_round)


def test_run_instance_without_value_hint_matches_jax():
    """OTR without n_values takes the sender-equality mmor path."""
    mix, init = _mix_and_init(5)
    tmix = _port_mix(mix)
    tinit = torch.as_tensor(np.array(init))
    for s in (0, 1, 2, 3):
        want = jrun_instance(JOTR(2), jconsensus_io(init), N,
                             jax.random.PRNGKey(s), jscen.from_mix_row(mix, s),
                             max_phases=5)
        got = texecutor.run_instance(TOTR(2), tconsensus_io(tinit), N, (s, 0),
                                     tscen.from_mix_row(tmix, s), 5,
                                     device="cpu")
        _assert_same(got.state, got.done, got.decided_round,
                     want.state, want.done, want.decided_round)


def test_simulate_and_recording():
    n = 10
    init = torch.arange(n, dtype=torch.int32) % 3
    res = texecutor.simulate(
        TOTR(2, 4), tconsensus_io(init), n, (1, 2),
        tscen.omission(n, 0.2, device="cpu"), 4, n_scenarios=3,
        record_fn=lambda st, done, r: st.decided, device="cpu")
    assert res.state.x.shape == (3, n)
    assert res.recorded.shape == (3, 4, n)
    assert res.rounds_run == 4
    # fault-free: round 0 adopts the plurality value 0 (4 of 10, no super
    # quorum yet), round 1 decides it everywhere
    ff = texecutor.run_instance(TOTR(2, 4), tconsensus_io(init), n, (0, 0),
                                tscen.full(n, device="cpu"), 3, device="cpu")
    assert bool(ff.state.decided.all())
    assert bool((ff.state.decision == 0).all())
    assert bool((ff.decided_round == 1).all())


def test_standard_mix_structure():
    """The port draws from a torch.Generator, so the mix is checked for
    structure, not bits."""
    S_, n, f = 40, 32, 5
    mix = tfast.standard_mix(torch.Generator().manual_seed(0), S_, n,
                             p_drop=0.25, f=f, crash_round=2, heal_round=4,
                             rotate_period=3, device="cpu")
    fam = torch.arange(S_) % 4
    crashed_per = mix.crashed.sum(1)
    assert bool((crashed_per[fam == 1] == f).all())
    assert bool((crashed_per[fam != 1] == 0).all())
    assert bool((mix.crash_round == 2).all())
    expected_p8 = torch.tensor([64, 16, 0, 16])[fam]
    assert torch.equal(mix.p8, expected_p8.to(torch.int32))
    assert bool((mix.side[fam != 2] == 0).all())
    assert bool(((mix.side[fam == 2] == 0) | (mix.side[fam == 2] == 1)).all())
    assert 0 < float(mix.side[fam == 2].float().mean()) < 1
    assert torch.equal(mix.heal_round,
                       torch.where(fam == 2, 4, 0).to(torch.int32))
    assert torch.equal(mix.rotate_down,
                       torch.where(fam == 3, 3, 0).to(torch.int32))
    assert mix.salt0.dtype == torch.int32 and mix.salt1.dtype == torch.int32
    assert len(set(mix.salt0.tolist())) == S_
    again = tfast.standard_mix(torch.Generator().manual_seed(0), S_, n,
                               device="cpu")
    assert torch.equal(again.crashed, tfast.standard_mix(
        torch.Generator().manual_seed(0), S_, n, device="cpu").crashed)


@pytest.mark.parametrize("kw", [
    {}, {"crash_round": 2, "heal_round": 3, "rotate_period": 3},
    {"p_drop": 1.0, "rotate_period": 5}])
def test_round_params_table_matches_round_params(kw):
    """The engines' per-run table of round inputs equals round_tpu's
    round_params and the port's round by round, dtypes included."""
    rounds = 13
    mix = jfast.standard_mix(jax.random.PRNGKey(7), S, N, f=3, **kw)
    tmix = _port_mix(mix)
    params = tfast.round_params_table(tmix, rounds)
    for r in range(rounds):
        got = params(r)
        for g, one, w in zip(got, tfast.round_params(tmix, r),
                             jfast.round_params(mix, r)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert g.dtype == one.dtype and torch.equal(g, one), r


def test_round_params_matches_jax():
    mix, _ = _mix_and_init()
    tmix = _port_mix(mix)
    for r in (0, 1, 4, 7):
        want = jfast.round_params(mix, r)
        got = tfast.round_params(tmix, r)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("field", ["byz_value", "equiv_p8", "stale_p8"])
def test_interop_refuses_value_adversaries(field):
    """The value-adversary fields are carried, not refused: a mix that sets
    one keeps it bit for bit (as bool or int32) and leaves the others
    None."""
    mix, _ = _mix_and_init()
    d = {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}
    d["byz_value"] = d["equiv_p8"] = d["stale_p8"] = None
    rng = np.random.default_rng(1)
    d[field] = (rng.random(d["crashed"].shape) < 0.5 if field == "byz_value"
                else rng.integers(0, 256, d["p8"].shape).astype(np.int32))
    got = interop.fault_mix_from_numpy(d, device="cpu")
    np.testing.assert_array_equal(getattr(got, field).numpy(), d[field])
    for other in {"byz_value", "equiv_p8", "stale_p8"} - {field}:
        assert getattr(got, other) is None


def test_benchstat_matches_jax():
    from round_tpu.utils import benchstat as jbenchstat

    rng = np.random.default_rng(0)
    decided = rng.random((6, 9)) < 0.7
    dround = np.where(decided, rng.integers(0, 5, (6, 9)), -1).astype(np.int32)
    decision = rng.integers(0, 4, (6, 9)).astype(np.int32)
    want = jbenchstat.decided_summary(jnp.asarray(decided),
                                      jnp.asarray(dround), 5,
                                      jnp.asarray(decision))
    got = benchstat.decided_summary(torch.as_tensor(decided),
                                    torch.as_tensor(dround), 5,
                                    torch.as_tensor(decision))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hist = np.asarray(want[1])
    assert benchstat.p50_from_hist(hist) == jbenchstat.p50_from_hist(hist)
    assert benchstat.speed_extra(0.5, 5, 10, hist, 54) == \
        jbenchstat.speed_extra(0.5, 5, 10, hist, 54)


def test_entry_points_default_to_cuda():
    """With no card, an entry point that is not told device='cpu' raises
    instead of running somewhere else."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfast.standard_mix(torch.Generator(), 4, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tscen.full(4)


@pytest.mark.parametrize("engine", ["loop", "fused"])
def test_bench_cli_on_cpu(engine):
    out = subprocess.run(
        [sys.executable, "-m", "round_tpu_torch.bench", "--device", "cpu",
         "--n", "16", "--scenarios", "8", "--phases", "4", "--parity", "4",
         "--repeats", "1", "--engine", engine],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "otr_n16_s8_rounds_per_sec"
    assert rec["unit"] == "rounds/sec" and rec["value"] > 0
    # the bench times hw links by default and replays its parity in hash
    assert rec["extra"]["parity_frac"] == 1.0
    assert rec["extra"]["rng"] == "hw"
    assert rec["extra"]["backend"] == "cpu"
