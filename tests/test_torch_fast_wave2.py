"""Port parity: the rest of the fused engines (KSet on K2, ◇S, Θ, PBFT with
and without view change, mutex, Game of Life) on the CPU.

Mirrors tests/test_fast.py's parity tests of those engines at their sizes.
round_tpu's fused runners (hash links; run_hist's Pallas exchange in
interpret mode, as tests/test_fast.py runs it) and the port's are fed the
same FaultMix and initial state, carried over through numpy and
round_tpu_torch.interop, and held bit for bit (tolerance 0: every output is
an integer or a bool).  The port's general engine replays every scenario
row (scenarios.from_mix_row) as the second witness of each fused runner."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.models import failure_detector as jfd
from round_tpu.models import gameoflife as jgol
from round_tpu.models import kset as jkset
from round_tpu.models import mutex as jmutex
from round_tpu.models import pbft as jpbft
from round_tpu.models import theta as jtheta
from round_tpu_torch import interop
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.engine.executor import run_instance as trun_instance
from round_tpu_torch.models import failure_detector as tfd
from round_tpu_torch.models import gameoflife as tgol
from round_tpu_torch.models import kset as tkset
from round_tpu_torch.models import mutex as tmutex
from round_tpu_torch.models import pbft as tpbft
from round_tpu_torch.models import theta as ttheta
from round_tpu_torch.parallel import mesh as tmesh
from round_tpu_torch.utils.tree import tree_leaves

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")
VC_FIELDS = ("x", "dig", "valid", "prepared", "decided", "decision", "view",
             "next_view", "vc_active", "prep_req", "prep_view", "vc_heard",
             "vc_req", "vc_pv", "sel_req", "nv_ok")
FIELDS = {
    "kset": ("est", "can_decide", "last_nb", "decided", "decision"),
    "esfd": ("last_seen",),
    "theta": ("round", "next_round_at", "heard"),
    "pbft": ("x", "dig", "valid", "prepared", "decided", "decision"),
    "pbft_vc": VC_FIELDS,
    "mutex": ("x", "has_token"),
    "gol": ("alive",),
}
FROM_NUMPY = {
    "kset": interop.kset_es_state_from_numpy,
    "esfd": interop.esfd_state_from_numpy,
    "theta": interop.theta_state_from_numpy,
    "pbft": interop.bcp_state_from_numpy,
    "pbft_vc": interop.pbft_vc_state_from_numpy,
    "mutex": interop.mutex_state_from_numpy,
    "gol": interop.cgol_state_from_numpy,
}


def _port_mix(mix):
    return interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}, device=CPU)


def _port_state(family, jstate):
    return FROM_NUMPY[family](
        {k: np.asarray(getattr(jstate, k)) for k in FIELDS[family]},
        device=CPU)


def _same_run(family, got, want):
    """(state, done, decided_round) of the port against round_tpu's."""
    for name in FIELDS[family]:
        g = getattr(got[0], name).numpy()
        w = np.asarray(getattr(want[0], name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _general_rows(family, algo, io, tmix, fused_out, phases, S, n):
    """Every scenario row through the port's general engine on its
    from_mix_row replay equals the port's fused runner on that row."""
    for s in range(S):
        res = trun_instance(algo, io, n, (s, 99), tscen.from_mix_row(tmix, s),
                            phases, device=CPU)
        for name in FIELDS[family]:
            np.testing.assert_array_equal(
                getattr(fused_out[0], name)[s].numpy(),
                getattr(res.state, name).numpy(),
                err_msg=f"scenario {s}, field {name}")
        np.testing.assert_array_equal(fused_out[2][s].numpy(),
                                      res.decided_round.numpy())


def _kset_case():
    n, S, V, t, kk = 16, 8, 8, 3, 2
    key = jax.random.PRNGKey(9)
    mix = jfast.fault_free(key, S, n)
    crashed = jax.vmap(
        lambda k: jax.random.permutation(k, jnp.arange(n)) < t
    )(jax.random.split(jax.random.fold_in(key, 0xCC), S))
    mix = mix.replace(crashed=crashed)
    init = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0, V,
                              dtype=jnp.int32)
    state0 = jkset.KSetESState(
        est=jnp.broadcast_to(init, (S, n)).astype(jnp.int32),
        can_decide=jnp.zeros((S, n), bool),
        last_nb=jnp.full((S, n), n, jnp.int32),
        decided=jnp.zeros((S, n), bool),
        decision=jnp.full((S, n), -1, jnp.int32),
    )
    return n, S, V, t, kk, mix, init, state0


def test_kset_early_stopping_hist_parity():
    """KSetEarlyStopping through run_hist (K2's plain version here, the
    doubled domain V = 2·n_values) equals round_tpu's run_hist and the
    port's general engine on crash mixes; k-set agreement holds on the live
    lanes; the proc-sharded twin on a 2 × 4 CPU mesh equals the single
    device run."""
    n, S, V, t, kk, mix, init, state0 = _kset_case()
    rounds = 6
    jrnd = jfast.KSetESHist(n_values=V, t=t, k=kk)
    want = jfast.run_hist(jrnd, state0, lambda s: s.decided, mix,
                          max_rounds=rounds, mode="hash", interpret=True)
    trnd = tfast.KSetESHist(n_values=V, t=t, k=kk)
    assert trnd.num_values == 2 * V
    tmix = _port_mix(mix)
    tstate0 = _port_state("kset", state0)
    fresh = tkset.KSetESState.fresh(torch.tensor(np.asarray(init)), S, n)
    for a, b in zip(tree_leaves(fresh), tree_leaves(tstate0)):
        assert torch.equal(a, b)
    got = tfast.run_hist(trnd, tstate0, lambda s: s.decided, tmix,
                         max_rounds=rounds, mode="hash")
    _same_run("kset", got, want)

    io = {"initial_value": torch.tensor(np.asarray(init))}
    _general_rows("kset", tkset.KSetEarlyStopping(t=t, k=kk), io, tmix, got,
                  rounds, S, n)
    assert bool(got[0].decided.all())
    dec = got[0].decision.numpy()
    live = ~np.asarray(mix.crashed)
    for s in range(S):
        assert len(set(dec[s][live[s]].tolist())) <= kk

    mesh = tmesh.make_mesh(8, proc_shards=4, devices=[CPU] * 8)
    sharded = tmesh.run_hist_proc_sharded(trnd, tstate0, tmix, rounds, mesh)
    for a, b in zip(tree_leaves(sharded), tree_leaves(got)):
        assert torch.equal(a, b)


def test_esfd_fast_parity_and_detection():
    n, S, h, rounds = 12, 8, 3, 12
    key = jax.random.PRNGKey(71)
    mix = jfast.standard_mix(key, S, n, p_drop=0.15, f=3, crash_round=0)
    state0 = jfd.EsfdState(last_seen=jnp.zeros((S, n, n), jnp.int32))
    want = jfast.run_esfd_fast(state0, mix, rounds, hysteresis=h)
    tmix = _port_mix(mix)
    got = tfast.run_esfd_fast(_port_state("esfd", state0), tmix, rounds,
                              hysteresis=h)
    _same_run("esfd", got, want)
    _general_rows("esfd", tfd.Esfd(hysteresis=h), {}, tmix, got, rounds, S,
                  n)

    sus = got[0].last_seen.numpy() > h
    crashed = np.asarray(mix.crashed)
    hit = False
    for s in range(S):
        if crashed[s].any():
            live = ~crashed[s]
            assert sus[s][np.ix_(live, crashed[s])].all(), s
            hit = True
    assert hit


@pytest.mark.parametrize("theta", [2.0, 0.5])
def test_theta_fast_parity(theta):
    """Both the known-Θ and the triangular schedules."""
    n, S, rounds = 12, 8, 20
    key = jax.random.PRNGKey(81)
    mix = jfast.standard_mix(key, S, n, p_drop=0.2, f=3, crash_round=2)
    r0 = jnp.zeros((S, n), jnp.int32)
    state0 = jtheta.ThetaState(
        round=r0,
        next_round_at=jnp.broadcast_to(
            jnp.asarray(jtheta._next_round_at(theta,
                                              jnp.asarray(0, jnp.int32)),
                        jnp.int32), (S, n)),
        heard=jnp.full((S, n, n), -1, jnp.int32),
    )
    want = jfast.run_theta_fast(state0, mix, rounds, 2, theta)
    tmix = _port_mix(mix)
    tstate0 = _port_state("theta", state0)
    fresh = ttheta.ThetaState.fresh(theta, S, n, device=CPU)
    for a, b in zip(tree_leaves(fresh), tree_leaves(tstate0)):
        assert torch.equal(a, b)
    got = tfast.run_theta_fast(tstate0, tmix, rounds, 2, theta)
    _same_run("theta", got, want)
    _general_rows("theta", ttheta.ThetaModel(f=2, theta=theta), {}, tmix,
                  got, rounds, S, n)
    assert int(got[0].round.max()) >= 1


def test_pbft_fast_parity():
    """Including coordinator-crash scenarios aborting to null and
    full-quorum scenarios committing the request."""
    n, S, rounds = 12, 10, 3
    key = jax.random.PRNGKey(91)
    mix = jfast.standard_mix(key, S, n, p_drop=0.2, f=3, crash_round=0)
    x0 = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0, 1000,
                            dtype=jnp.int32)
    state0 = jpbft.BcpState(
        x=jnp.broadcast_to(x0, (S, n)),
        dig=jnp.broadcast_to(jpbft.digest(x0), (S, n)),
        valid=jnp.ones((S, n), bool),
        prepared=jnp.zeros((S, n), bool),
        decided=jnp.zeros((S, n), bool),
        decision=jnp.full((S, n), -1, jnp.int32),
    )
    want = jfast.run_pbft_fast(state0, mix, max_rounds=rounds)
    tmix = _port_mix(mix)
    tstate0 = _port_state("pbft", state0)
    fresh = tpbft.BcpState.fresh(torch.tensor(np.asarray(x0)), S, n)
    for a, b in zip(tree_leaves(fresh), tree_leaves(tstate0)):
        assert torch.equal(a, b)
    got = tfast.run_pbft_fast(tstate0, tmix, max_rounds=rounds)
    _same_run("pbft", got, want)
    io = {"initial_value": torch.tensor(np.asarray(x0))}
    _general_rows("pbft", tpbft.PbftConsensus(), io, tmix, got, 1, S, n)

    d = got[0].decision.numpy()
    saw_commit = saw_null = False
    for s in range(S):
        live = ~np.asarray(mix.crashed[s])
        saw_commit |= bool((d[s][live] >= 0).any())
        saw_null |= bool((d[s][live] == -1).any())
        pos = d[s][live][d[s][live] >= 0]
        assert len(set(pos.tolist())) <= 1, s
    assert saw_commit and saw_null


def test_mutex_fast_parity_and_stabilization():
    n, S, rounds = 10, 8, 12
    key = jax.random.PRNGKey(101)
    mix = jfast.standard_mix(key, S, n, p_drop=0.2, f=2, crash_round=3)
    init = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0, n + 1,
                              dtype=jnp.int32)
    state0 = jmutex.MutexState(x=jnp.broadcast_to(init, (S, n)),
                               has_token=jnp.zeros((S, n), bool))
    want = jfast.run_mutex_fast(state0, mix, rounds)
    tmix = _port_mix(mix)
    tinit = torch.tensor(np.asarray(init))
    tstate0 = tmutex.MutexState.fresh(tinit, S, n)
    for a, b in zip(tree_leaves(tstate0),
                    tree_leaves(_port_state("mutex", state0))):
        assert torch.equal(a, b)
    got = tfast.run_mutex_fast(tstate0, tmix, rounds)
    _same_run("mutex", got, want)
    _general_rows("mutex", tmutex.SelfStabilizingMutualExclusion(),
                  tmutex.mutex_io(tinit), tmix, got, rounds, S, n)

    gen = torch.Generator().manual_seed(7)
    clean = tfast.fault_free(gen, 1, n, device=CPU)
    st2, _d, _r = tfast.run_mutex_fast(tmutex.MutexState.fresh(tinit, 1, n),
                                       clean, 3 * n)
    assert int(st2.has_token.sum()) == 1


def test_gol_fast_parity_and_glider():
    rows = cols = 5
    n, S, rounds = rows * cols, 6, 8
    key = jax.random.PRNGKey(111)
    mix = jfast.standard_mix(key, S, n, p_drop=0.15, f=4, crash_round=2)
    grid = np.zeros((rows, cols), dtype=bool)
    for r_, c_ in ((0, 1), (1, 2), (2, 0), (2, 1), (2, 2)):  # glider
        grid[r_, c_] = True
    nb = tgol.torus_neighbours(rows, cols)
    np.testing.assert_array_equal(nb, jgol.torus_neighbours(rows, cols))
    jio = jgol.cgol_io(grid)
    state0 = jgol.CgolState(
        alive=jnp.broadcast_to(jnp.asarray(jio["alive"], bool), (S, n)))
    want = jfast.run_gol_fast(state0, mix, nb, rounds)
    tmix = _port_mix(mix)
    got = tfast.run_gol_fast(_port_state("gol", state0), tmix, nb, rounds)
    _same_run("gol", got, want)
    tio = tgol.cgol_io(grid)
    np.testing.assert_array_equal(tio["alive"].numpy(),
                                  np.asarray(jio["alive"]))
    _general_rows("gol", tgol.ConwayGameOfLife(rows, cols), tio, tmix, got,
                  rounds, S, n)

    # clean torus: the glider translates by (1, 1) after 4 generations
    clean = tfast.fault_free(torch.Generator().manual_seed(7), 1, n,
                             device=CPU)
    st = tgol.CgolState(alive=tio["alive"][None])
    st2, _d2, _r2 = tfast.run_gol_fast(st, clean, nb, 4)
    want_grid = np.roll(np.roll(grid, 1, axis=0), 1, axis=1)
    np.testing.assert_array_equal(st2.alive[0].numpy().reshape(rows, cols),
                                  want_grid)


def test_pbft_view_change_fast_parity():
    """Two 6-round phases of FaultMix families, including a forced
    primary crash at round 0 on clean links (scenario 0): some lane
    decides THROUGH a view change."""
    n, S, phases = 8, 8, 2
    rounds = 6 * phases
    key = jax.random.PRNGKey(17)
    mix = jfast.standard_mix(key, S, n, p_drop=0.15, f=2, crash_round=0)
    mix = mix.replace(
        crashed=mix.crashed.at[0].set(False).at[0, 0].set(True),
        crash_round=mix.crash_round.at[0].set(0),
        p8=mix.p8.at[0].set(0),
        heal_round=mix.heal_round.at[0].set(0),
    )
    x0 = jax.random.randint(jax.random.fold_in(key, 1), (n,), 0, 1000,
                            dtype=jnp.int32)
    state0 = jpbft.PbftVcState.fresh(x0, S, n)
    want = jfast.run_pbft_vc_fast(state0, mix, max_rounds=rounds)
    tmix = _port_mix(mix)
    tx0 = torch.tensor(np.asarray(x0))
    tstate0 = tpbft.PbftVcState.fresh(tx0, S, n)
    for name in VC_FIELDS:
        np.testing.assert_array_equal(getattr(tstate0, name).numpy(),
                                      np.asarray(getattr(state0, name)),
                                      err_msg=name)
    got = tfast.run_pbft_vc_fast(tstate0, tmix, max_rounds=rounds)
    _same_run("pbft_vc", got, want)
    _general_rows("pbft_vc", tpbft.PbftViewChange(),
                  {"initial_value": tx0}, tmix, got, phases, S, n)

    d, v = got[0].decision.numpy(), got[0].view.numpy()
    live = ~np.asarray(mix.crashed)
    for s in range(S):
        pos = d[s][live[s]][d[s][live[s]] >= 0]
        assert len(set(pos.tolist())) <= 1, s
    assert ((d >= 0) & (v > 0) & live).any(), \
        "no scenario decided through a view change"

