"""Port parity on the general engine: k-set agreement (both forms), ◇S, the
self-stabilizing mutex, Game of Life, Θ and PBFT (with and without view
change), and the byzantine synchronizer.

Mirrors tests/test_models_wave2.py's tests of those models and
tests/test_kset.py.  Each case runs round_tpu's general engine and the
port's on the same io and the same HO schedule — an explicit schedule, or
the masks round_tpu's sampler draws for each scenario key, replayed
through the port's from_schedule — and holds every state field, ``done``
and ``decided_round`` bit for bit (tolerance 0: integers and bools), then
checks the reference test's own property on the port's run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import scenarios as jscen
from round_tpu.engine.executor import run_instance as jrun_instance
from round_tpu.engine.executor import simulate as jsimulate
from round_tpu.models import failure_detector as jfd
from round_tpu.models import gameoflife as jgol
from round_tpu.models import kset as jkset
from round_tpu.models import mutex as jmutex
from round_tpu.models import pbft as jpbft
from round_tpu.models import theta as jtheta
from round_tpu.models.common import consensus_io as jconsensus_io
from round_tpu_torch import interop
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.engine.executor import run_instance as trun_instance
from round_tpu_torch.models import failure_detector as tfd
from round_tpu_torch.models import gameoflife as tgol
from round_tpu_torch.models import kset as tkset
from round_tpu_torch.models import mutex as tmutex
from round_tpu_torch.models import pbft as tpbft
from round_tpu_torch.models import theta as ttheta
from round_tpu_torch.models.common import consensus_io as tconsensus_io
from round_tpu_torch.utils.tree import tree_leaves

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _assert_same(got, want, what=""):
    gl = tree_leaves(got.state) + [got.done, got.decided_round]
    wl = jax.tree_util.tree_leaves(want.state) + [want.done,
                                                  want.decided_round]
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype, (what, i)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} leaf {i}")
    if want.recorded is not None:
        np.testing.assert_array_equal(got.recorded.numpy(),
                                      np.asarray(want.recorded))


def _both(jalgo, talgo, jio, tio, n, ho, phases, record_fn=None):
    """One instance through both general engines on the [T, n, n]
    schedule `ho`; returns the port's result."""
    want = jrun_instance(jalgo, jio, n, jax.random.PRNGKey(0),
                         jscen.from_schedule(jnp.asarray(ho)),
                         max_phases=phases, record_fn=record_fn)
    got = trun_instance(talgo, tio, n, (0, 0),
                        tscen.from_schedule(torch.as_tensor(ho)), phases,
                        record_fn=record_fn, device=CPU)
    _assert_same(got, want, type(talgo).__name__)
    return got


def _both_simulated(jalgo, talgo, jio, tio, n, key, jsampler, phases, S):
    """round_tpu's simulate against the port's run_instance per scenario on
    the masks round_tpu's sampler draws for that scenario's key."""
    want = jsimulate(jalgo, jio, n, key, jsampler, max_phases=phases,
                     n_scenarios=S)
    T = phases * len(jalgo.rounds)
    keys = jax.random.split(key, S)
    got_rows = []
    for s in range(S):
        # round_tpu's run_phases hands the sampler the first half of each
        # scenario key's split (its round-invariant ho_key)
        ho_key = jax.random.split(keys[s])[0]
        ho = np.stack([np.asarray(jsampler(ho_key, jnp.int32(r)))
                       for r in range(T)])
        got = trun_instance(talgo, tio, n, (0, 0),
                            tscen.from_schedule(torch.as_tensor(ho)), phases,
                            device=CPU)
        row = jax.tree_util.tree_map(lambda x: x[s], want)
        _assert_same(got, row, f"{type(talgo).__name__} scenario {s}")
        got_rows.append(got)
    return got_rows


# -- k-set agreement (tests/test_kset.py) ---------------------------------

def test_kset_full_network_converges_to_min():
    n, k = 4, 2
    init = [9, 4, 7, 6]
    got = _both(jkset.KSetAgreement(k), tkset.KSetAgreement(k),
                jconsensus_io(init), tconsensus_io(init), n,
                np.ones((4, n, n), dtype=bool), 4)
    assert bool(got.state.decided.all())
    assert got.state.decision.tolist() == [4] * n
    assert got.decided_round.tolist() == [2] * n
    assert bool(got.state.t_mask.all())


def test_kset_decider_adoption():
    """Also carries round_tpu's final KSetState over through
    interop.kset_state_from_numpy: the same leaves as the port's run."""
    n, k = 4, 2
    ho0 = np.eye(n, dtype=bool)
    ho0[0, :] = True
    ho = np.stack([ho0, ho0] + [np.ones((n, n), dtype=bool)] * 4)
    init = [5, 3, 8, 1]
    got = _both(jkset.KSetAgreement(k), tkset.KSetAgreement(k),
                jconsensus_io(init), tconsensus_io(init), n, ho, 6)
    assert bool(got.state.decided.all())
    vals = set(got.state.decision.tolist())
    assert len(vals) <= k and vals <= set(init)

    want = jrun_instance(jkset.KSetAgreement(k), jconsensus_io(init), n,
                         jax.random.PRNGKey(0),
                         jscen.from_schedule(jnp.asarray(ho)), max_phases=6)
    carried = interop.kset_state_from_numpy(
        {f: np.asarray(getattr(want.state, f)) for f in
         ("t_vals", "t_mask", "decider", "decided", "decision")},
        device=CPU)
    for a, b in zip(tree_leaves(carried), tree_leaves(got.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_kset_at_most_k_decisions_under_crash():
    n, k, f, S = 6, 2, 1, 24
    init = [17, 3, 11, 8, 25, 6]
    rows = _both_simulated(jkset.KSetAgreement(k), tkset.KSetAgreement(k),
                           jconsensus_io(init), tconsensus_io(init), n,
                           jax.random.PRNGKey(5), jscen.crash(n, f), 8, S)
    for s, got in enumerate(rows):
        vals = set(got.state.decision[got.state.decided].tolist())
        assert len(vals) <= k, f"scenario {s}: {vals}"
        assert vals <= set(init), f"scenario {s}: decision outside V0"


def test_kset_es_full_network():
    n, t, k = 5, 2, 2
    init = [12, 5, 9, 31, 7]
    got = _both(jkset.KSetEarlyStopping(t, k), tkset.KSetEarlyStopping(t, k),
                jconsensus_io(init), tconsensus_io(init), n,
                np.ones((4, n, n), dtype=bool), 4)
    assert bool(got.state.decided.all())
    assert got.state.decision.tolist() == [5] * n
    assert got.decided_round.tolist() == [1] * n


def test_kset_es_horizon_decision():
    n, t, k, S = 6, 4, 2, 16
    init = [40, 10, 33, 21, 15, 28]
    rows = _both_simulated(jkset.KSetEarlyStopping(t, k),
                           tkset.KSetEarlyStopping(t, k),
                           jconsensus_io(init), tconsensus_io(init), n,
                           jax.random.PRNGKey(8), jscen.omission(n, 0.3),
                           t // k + 3, S)
    for got in rows:
        assert bool(got.state.decided.all())
        assert set(got.state.decision.tolist()) <= set(init)


# -- failure detector ------------------------------------------------------

def test_esfd_suspects_crashed_and_trusts_live():
    n, h, T = 5, 3, 12
    ho = np.ones((T, n, n), dtype=bool)
    ho[:, :, 4] = False  # 4 crashed from the start (nobody hears it)
    for t in range(T):
        np.fill_diagonal(ho[t], True)
    talgo = tfd.Esfd(hysteresis=h)
    got = _both(jfd.Esfd(hysteresis=h), talgo, {}, {}, n, ho, T)
    sus = talgo.suspected(got.state).numpy()
    for j in range(4):
        assert sus[j, 4], f"{j} should suspect 4"
        assert not sus[j, :4].any(), f"{j} wrongly suspects {np.where(sus[j])}"


def test_esfd_suspicion_gossip():
    n, h, T = 4, 3, 8
    ho = np.ones((T, n, n), dtype=bool)
    ho[:, :, 3] = False
    ho[:, 1, :3] = False
    for t in range(T):
        np.fill_diagonal(ho[t], True)
    ho[:, 1, 0] = True
    talgo = tfd.Esfd(hysteresis=h)
    got = _both(jfd.Esfd(hysteresis=h), talgo, {}, {}, n, ho, T)
    sus = talgo.suspected(got.state).numpy()
    assert sus[1, 3]  # adopted via gossip from 0
    assert sus[1, 2]  # 1 never hears 2 -> own counter trips too


# -- self-stabilizing mutex ------------------------------------------------

def test_mutex_stabilizes_to_one_token():
    n = 6
    init = [3, 3, 1, 4, 0, 2]
    got = _both(jmutex.SelfStabilizingMutualExclusion(),
                tmutex.SelfStabilizingMutualExclusion(), jmutex.mutex_io(init),
                tmutex.mutex_io(init), n, np.ones((1, n, n), dtype=bool),
                3 * n)
    assert int(got.state.has_token.sum()) == 1, got.state.has_token


def test_mutex_token_circulates():
    n = 4
    got = _both(jmutex.SelfStabilizingMutualExclusion(),
                tmutex.SelfStabilizingMutualExclusion(),
                jmutex.mutex_io([0] * n), tmutex.mutex_io([0] * n), n,
                np.ones((1, n, n), dtype=bool), 2 * n,
                record_fn=lambda s, d, r: s.has_token)
    rec = got.recorded.numpy()
    assert (rec.sum(axis=1) == 1).all()
    assert len(set(rec.argmax(axis=1).tolist())) == n


# -- game of life ----------------------------------------------------------

def test_cgol_blinker_oscillates():
    rows = cols = 5
    n = rows * cols
    grid = np.zeros((rows, cols), dtype=bool)
    grid[2, 1:4] = True  # horizontal blinker
    full = np.ones((1, n, n), dtype=bool)
    got2 = _both(jgol.ConwayGameOfLife(rows, cols),
                 tgol.ConwayGameOfLife(rows, cols), jgol.cgol_io(grid),
                 tgol.cgol_io(grid), n, full, 2)
    np.testing.assert_array_equal(got2.state.alive.numpy().reshape(rows, cols),
                                  grid)
    got1 = _both(jgol.ConwayGameOfLife(rows, cols),
                 tgol.ConwayGameOfLife(rows, cols), jgol.cgol_io(grid),
                 tgol.cgol_io(grid), n, full, 1)
    vertical = np.zeros((rows, cols), dtype=bool)
    vertical[1:4, 2] = True
    np.testing.assert_array_equal(got1.state.alive.numpy().reshape(rows, cols),
                                  vertical)


# -- theta model -----------------------------------------------------------

def test_theta_logical_clocks_advance_and_sync():
    n, f, theta = 4, 1, 1.0
    got = _both(jtheta.ThetaModel(f, theta), ttheta.ThetaModel(f, theta), {},
                {}, n, np.ones((1, n, n), dtype=bool), 40)
    rounds = got.state.round.numpy()
    assert (rounds > 0).all()
    assert rounds.max() - rounds.min() <= 1
    assert (got.state.heard.numpy() >= rounds.min() - 1).all()


@pytest.mark.parametrize("theta", [0.5, 1.1, 1.5, 2.0, 2.7])
def test_theta_next_round_at_matches_jax(theta):
    """The schedule over every logical round up to 10^5: known Θ truncates
    the float32 product 3Θ·(r+1); the triangular schedule wraps in int32
    as round_tpu's does."""
    r = np.arange(0, 100_001, dtype=np.int32)
    want = np.asarray(jax.jit(lambda x: jtheta._next_round_at(theta, x))(
        jnp.asarray(r)))
    got = ttheta._next_round_at(theta, torch.from_numpy(r))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- PBFT ------------------------------------------------------------------

def test_pbft_digest_matches_jax():
    """digest and cert_digest: uint32 arithmetic emulated in int64, bit for
    bit over the whole int32 range (wrap of req·31 + pv included)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.integers(-2**31, 2**31, 20_000, dtype=np.int64),
        np.array([0, 1, -1, 2**31 - 1, -2**31, 5, 6])]).astype(np.int32)
    pv = rng.integers(-2**31, 2**31, x.shape[0], dtype=np.int64).astype(
        np.int32)
    np.testing.assert_array_equal(tpbft.digest(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpbft.digest(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tpbft.cert_digest(torch.from_numpy(x), torch.from_numpy(pv)).numpy(),
        np.asarray(jpbft.cert_digest(jnp.asarray(x), jnp.asarray(pv))))
    assert int(tpbft.digest(torch.tensor(5))) != int(tpbft.digest(
        torch.tensor(6)))


def test_pbft_decides_coordinator_value():
    n = 7
    init = [42, 1, 2, 3, 4, 5, 6]
    got = _both(jpbft.PbftConsensus(), tpbft.PbftConsensus(),
                jconsensus_io(init), tconsensus_io(init), n,
                np.ones((3, n, n), dtype=bool), 1)
    assert bool(got.state.decided.all())
    assert bool((got.state.decision == 42).all())
    assert bool(got.done.all())


def test_pbft_null_decision_when_coordinator_silent():
    n = 4
    ho = np.ones((3, n, n), dtype=bool)
    ho[:, :, 0] = False
    for t in range(3):
        np.fill_diagonal(ho[t], True)
    got = _both(jpbft.PbftConsensus(), tpbft.PbftConsensus(),
                jconsensus_io([9] * n), tconsensus_io([9] * n), n, ho, 1)
    assert bool((got.state.decision[1:] == tpbft.DECIDE_NULL).all())


def test_pbft_byzantine_silence_tolerated():
    n, f, S = 7, 2, 16
    sampler = jscen.sync_k_filter(jscen.byzantine_silence(n, f), n - f)
    rows = _both_simulated(jpbft.PbftConsensus(), tpbft.PbftConsensus(),
                           jconsensus_io([13] * n), tconsensus_io([13] * n),
                           n, jax.random.PRNGKey(3), sampler, 1, S)
    decv = np.stack([g.state.decision.numpy() for g in rows])
    non_null = decv[decv != tpbft.DECIDE_NULL]
    assert (non_null == 13).all() and non_null.size > 0


def test_pbft_synchronized_wrapper_equivalent_on_full_network():
    n = 5
    init = [31, 0, 0, 0, 0]
    full = np.ones((3, n, n), dtype=bool)
    r1 = _both(jpbft.PbftConsensus(False), tpbft.PbftConsensus(False),
               jconsensus_io(init), tconsensus_io(init), n, full, 1)
    r2 = _both(jpbft.PbftConsensus(True), tpbft.PbftConsensus(True),
               jconsensus_io(init), tconsensus_io(init), n, full, 1)
    assert torch.equal(r1.state.decision, r2.state.decision)
    assert bool((r2.state.decision == 31).all())


def test_pbft_synchronized_wrapper_on_a_lossy_schedule():
    """The wrapper rebuilds each receiver's mailbox from the senders' dest
    rows: on a lossy schedule it equals round_tpu's, round for round."""
    n = 7
    rng = np.random.default_rng(4)
    ho = rng.random((3, n, n)) < 0.8
    for t in range(3):
        np.fill_diagonal(ho[t], True)
    init = [8, 2, 2, 2, 9, 2, 2]
    _both(jpbft.PbftConsensus(True), tpbft.PbftConsensus(True),
          jconsensus_io(init), tconsensus_io(init), n, ho, 1)


# -- PBFT view change ------------------------------------------------------

def test_pbft_view_change_decides_through_primary_failure():
    n, rounds = 4, 12
    ho = np.ones((rounds, n, n), dtype=bool)
    ho[:, :, 0] = False
    for r in range(rounds):
        np.fill_diagonal(ho[r], True)
    init = [9, 5, 6, 7]
    got = _both(jpbft.PbftViewChange(), tpbft.PbftViewChange(),
                jconsensus_io(init), tconsensus_io(init), n, ho, 2)
    assert bool(got.state.decided.all())
    assert bool((got.state.decision == 5).all()), got.state.decision
    assert bool((got.state.view == 1).all()), got.state.view


def test_pbft_view_change_prepared_value_survives():
    n, rounds = 4, 12
    ho = np.ones((rounds, n, n), dtype=bool)
    ho[2] = False
    ho[2, 3, :] = True
    for i in range(3):
        ho[2, i, i] = True
        ho[2, i, 3] = True
    init = [9, 5, 6, 7]
    got = _both(jpbft.PbftViewChange(), tpbft.PbftViewChange(),
                jconsensus_io(init), tconsensus_io(init), n, ho, 2)
    assert bool(got.state.decided.all())
    assert bool((got.state.decision == 9).all()), got.state.decision
