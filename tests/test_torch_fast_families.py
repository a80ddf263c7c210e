"""Port parity: the TPC, ERB and lattice engines and models on the CPU.

round_tpu's run_tpc_fast, run_erb_fast and run_lattice_fast (hash mode, the
Pallas exchange in interpret mode, as tests/test_fast.py runs them) and its
general engine over from_mix_row are held bit for bit (tolerance 0) against
the port's on the same FaultMix and initial state, carried over through
numpy and round_tpu_torch.interop.  The port's general engine on the same
replays is the second witness of each fused runner."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.engine import scenarios as jscen
from round_tpu.engine.executor import run_instance as jrun_instance
from round_tpu.models import erb as jerb
from round_tpu.models import lattice as jlattice
from round_tpu.models import tpc as jtpc
from round_tpu_torch import interop
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.engine.executor import run_instance as trun_instance
from round_tpu_torch.models import erb as terb
from round_tpu_torch.models import lattice as tlattice
from round_tpu_torch.models import tpc as ttpc

N, S = 12, 10
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")
FIELDS = {
    "tpc": ("coord", "vote", "decision", "decided"),
    "erb": ("x_val", "x_def", "delivered", "delivery"),
    "lattice": ("active", "proposed", "decided", "decision"),
}
FROM_NUMPY = {"tpc": interop.tpc_state_from_numpy,
              "erb": interop.erb_state_from_numpy,
              "lattice": interop.lattice_state_from_numpy}


def _port_mix(mix):
    return interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}, device="cpu")


def _port_state(family, jstate):
    return FROM_NUMPY[family](
        {k: np.asarray(getattr(jstate, k)) for k in FIELDS[family]},
        device="cpu")


def _same_tree(family, got, want, rows=slice(None)):
    """(state, done, decided_round) of the port against round_tpu's."""
    for name in FIELDS[family]:
        g, w = getattr(got[0], name).numpy(), np.asarray(getattr(want[0], name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g[rows], w[rows], err_msg=name)
    np.testing.assert_array_equal(got[1].numpy()[rows],
                                  np.asarray(want[1])[rows])
    np.testing.assert_array_equal(got[2].numpy()[rows],
                                  np.asarray(want[2])[rows])


def _tpc_case(seed):
    key = jax.random.PRNGKey(seed)
    mix = jfast.standard_mix(key, S, N, p_drop=0.25, f=3, crash_round=0)
    votes = jax.random.bernoulli(jax.random.fold_in(key, 2), 0.8, (N,))
    state0 = jtpc.TpcState(
        coord=jnp.zeros((S, N), jnp.int32),
        vote=jnp.broadcast_to(votes, (S, N)),
        decision=jnp.full((S, N), -1, jnp.int32),
        decided=jnp.zeros((S, N), bool),
    )
    return key, mix, votes, state0


def _erb_case(seed):
    key = jax.random.PRNGKey(seed)
    mix = jfast.standard_mix(key, S, N, p_drop=0.3, f=3, crash_round=0)
    io = jerb.broadcast_io(0, 5, N)
    return key, mix, io, jerb.ErbState.fresh(io, S, N)


def _lattice_case(seed, m=10):
    key = jax.random.PRNGKey(seed)
    mix = jfast.standard_mix(key, S, N, p_drop=0.2)
    sets = [[i % m, (3 * i + 1) % m] for i in range(N)]
    io = jlattice.lattice_io(sets, m)
    init = jnp.asarray(io["initial_value"], bool)
    state0 = jlattice.LatticeState(
        active=jnp.ones((S, N), bool),
        proposed=jnp.broadcast_to(init, (S, N, m)),
        decided=jnp.zeros((S, N), bool),
        decision=jnp.zeros((S, N, m), bool),
    )
    return key, mix, sets, io, state0


@pytest.mark.parametrize("seed", [31, 4])
def test_run_tpc_fast_matches_jax(seed):
    """Including the coordinator-crash path: some live lane decides None
    (-1) in both packages."""
    key, mix, votes, state0 = _tpc_case(seed)
    want = jfast.run_tpc_fast(state0, mix, max_rounds=3, mode="hash",
                              interpret=True)
    got = tfast.run_tpc_fast(_port_state("tpc", state0), _port_mix(mix),
                             max_rounds=3, mode="hash")
    _same_tree("tpc", got, want)
    d = got[0].decision.numpy()
    live = ~np.asarray(mix.crashed)
    assert (d[live] == -1).any() and (d[live] >= 0).any()


@pytest.mark.parametrize("seed", [41, 6])
def test_run_erb_fast_matches_jax(seed):
    key, mix, io, state0 = _erb_case(seed)
    want = jfast.run_erb_fast(state0, mix, max_rounds=14, n_values=8,
                              mode="hash", interpret=True)
    got = tfast.run_erb_fast(_port_state("erb", state0), _port_mix(mix),
                             max_rounds=14, n_values=8, mode="hash")
    _same_tree("erb", got, want)
    assert bool(got[0].delivered.any())
    assert not bool(got[0].delivered.all())  # a crashed origin starved some


@pytest.mark.parametrize("seed", [21, 8])
def test_run_lattice_fast_matches_jax(seed):
    key, mix, sets, io, state0 = _lattice_case(seed)
    want = jfast.run_lattice_fast(state0, mix, 8)
    got = tfast.run_lattice_fast(_port_state("lattice", state0),
                                 _port_mix(mix), 8)
    _same_tree("lattice", got, want)
    assert bool(got[0].decided.any())


def test_lattice_counts_and_mix_ho_match_jax():
    key, mix, sets, io, state0 = _lattice_case(2)
    tmix = _port_mix(mix)
    rng = np.random.default_rng(0)
    P = rng.random((S, N, 10)) < 0.4
    P_recv = P[:, 3:7]
    for r in (0, 3, 6):
        ho = jfast.mix_ho(mix, r)
        tho = tfast.mix_ho(tmix, r)
        np.testing.assert_array_equal(tho.numpy(), np.asarray(ho))
        want = jfast.lattice_counts(ho[:, 3:7], jnp.asarray(P_recv),
                                    jnp.asarray(P))
        got = tfast.lattice_counts(tho[:, 3:7], torch.as_tensor(P_recv),
                                   torch.as_tensor(P))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_subtract_self_delivery_matches_jax():
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 5, (S, 4, N)).astype(np.int32)
    payload = rng.integers(0, 4, (S, N)).astype(np.int32)
    excl = rng.random((S, N)) < 0.5
    want = jfast.subtract_self_delivery(
        jnp.asarray(counts), jnp.asarray(payload), jnp.asarray(excl), 4)
    got = tfast.subtract_self_delivery(
        torch.as_tensor(counts), torch.as_tensor(payload),
        torch.as_tensor(excl), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _general_rows(family, jalgo, talgo, jio, tio, mix, tmix, key, phases,
                  fused_out):
    """Every scenario row through both general engines on from_mix_row
    replays: the port's equals round_tpu's, and the port's fused runner
    equals both."""
    for s in range(S):
        want = jrun_instance(jalgo, jio, N, jax.random.fold_in(key, 99 + s),
                             jscen.from_mix_row(mix, s), max_phases=phases)
        got = trun_instance(talgo, tio, N, (s, 99),
                            tscen.from_mix_row(tmix, s), phases, device="cpu")
        for name in FIELDS[family]:
            g = getattr(got.state, name).numpy()
            np.testing.assert_array_equal(
                g, np.asarray(getattr(want.state, name)), err_msg=name)
            if name != "coord":
                np.testing.assert_array_equal(
                    getattr(fused_out[0], name)[s].numpy(), g, err_msg=name)
        np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
        np.testing.assert_array_equal(got.decided_round.numpy(),
                                      np.asarray(want.decided_round))
        np.testing.assert_array_equal(fused_out[2][s].numpy(),
                                      got.decided_round.numpy())


def test_tpc_model_matches_jax_and_the_fused_runner():
    key, mix, votes, state0 = _tpc_case(31)
    tmix = _port_mix(mix)
    fused_out = tfast.run_tpc_fast(_port_state("tpc", state0), tmix, 3,
                                   mode="hash")
    tio = ttpc.tpc_io(0, np.array(votes))
    jio = jtpc.tpc_io(0, votes)
    for k in ("coord", "can_commit"):
        np.testing.assert_array_equal(tio[k].numpy(), np.asarray(jio[k]))
    _general_rows("tpc", jtpc.TwoPhaseCommit(), ttpc.TwoPhaseCommit(), jio,
                  tio, mix, tmix, key, 1, fused_out)


def test_erb_model_matches_jax_and_the_fused_runner():
    key, mix, io, state0 = _erb_case(41)
    tmix = _port_mix(mix)
    fused_out = tfast.run_erb_fast(_port_state("erb", state0), tmix, 14, 8,
                                   mode="hash")
    tio = terb.broadcast_io(0, 5, N)
    for k in ("value", "is_origin"):
        np.testing.assert_array_equal(tio[k].numpy(), np.asarray(io[k]))
    fresh = terb.ErbState.fresh(tio, S, N)
    for name in FIELDS["erb"]:
        np.testing.assert_array_equal(getattr(fresh, name).numpy(),
                                      np.asarray(getattr(state0, name)))
    assert terb.GIVE_UP_ROUND == jerb.GIVE_UP_ROUND
    _general_rows("erb", jerb.EagerReliableBroadcast(),
                  terb.EagerReliableBroadcast(), io, tio, mix, tmix, key, 14,
                  fused_out)


def test_lattice_model_matches_jax_and_the_fused_runner():
    key, mix, sets, io, state0 = _lattice_case(21)
    tmix = _port_mix(mix)
    fused_out = tfast.run_lattice_fast(_port_state("lattice", state0), tmix, 8)
    tio = tlattice.lattice_io(sets, 10)
    np.testing.assert_array_equal(tio["initial_value"].numpy(),
                                  np.asarray(io["initial_value"]))
    fresh = tlattice.LatticeState.fresh(tio["initial_value"], S, N)
    for name in FIELDS["lattice"]:
        np.testing.assert_array_equal(getattr(fresh, name).numpy(),
                                      np.asarray(getattr(state0, name)))
    _general_rows("lattice", jlattice.LatticeAgreement(10),
                  tlattice.LatticeAgreement(10), io, tio, mix, tmix, key, 8,
                  fused_out)
    # decided sets form a chain under subset inclusion
    dec, got = fused_out[0].decision.numpy(), fused_out[0].decided.numpy()
    for s in range(S):
        ds = dec[s][got[s]]
        for a in range(len(ds)):
            for b in range(a + 1, len(ds)):
                assert (~ds[a] | ds[b]).all() or (~ds[b] | ds[a]).all()


def test_tpc_fresh_state_and_default_mode():
    """TpcState.fresh builds round_tpu's undecided state; the guarded
    runners default to hash links, as round_tpu's do."""
    import inspect

    key, mix, votes, state0 = _tpc_case(31)
    fresh = ttpc.TpcState.fresh(0, torch.as_tensor(np.array(votes)), S, N)
    for name in FIELDS["tpc"]:
        g = getattr(fresh, name).numpy()
        assert g.dtype == np.asarray(getattr(state0, name)).dtype
        np.testing.assert_array_equal(g, np.asarray(getattr(state0, name)))
    for fn in (tfast.run_tpc_fast, tfast.run_erb_fast):
        assert inspect.signature(fn).parameters["mode"].default == "hash"
