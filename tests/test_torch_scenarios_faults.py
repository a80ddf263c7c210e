"""Port parity: the fault samplers crash_at, quorum_omission, partition,
coordinator_down and byzantine_silence (round_tpu_torch/engine/scenarios.py).

round_tpu's property tests (tests/test_scenarios.py: halves stable then
healed, self-delivery, the quorum's in-degree, the crash round) run on the
port's samplers.  The key-free parts are bit for bit against round_tpu:
coordinator_down without omissions, crash_at's round structure and
partition's split given the same crash set or sides, and the healed
network.  The keyed draws (hash in the port, threefry in round_tpu) are
held against round_tpu's empirical rates over the same number of draws,
within 4 standard deviations of the difference of the two means."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import scenarios as jscen
from round_tpu_torch.engine import scenarios as tscen

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

CPU = torch.device("cpu")
KEYS = 96


def _trace(sampler, rounds, key=(3, 5)):
    return torch.stack([sampler(key, r) for r in range(rounds)]).numpy()


def _port_draws(sampler, rounds):
    """[KEYS, T, n, n] masks over keys (s, 0x51) in the port."""
    return np.stack([_trace(sampler, rounds, (s, 0x51)) for s in range(KEYS)])


def _jax_draws(sampler, rounds):
    """[KEYS, T, n, n] masks over KEYS threefry keys in round_tpu."""
    keys = jax.random.split(jax.random.PRNGKey(0), KEYS)
    rs = jnp.arange(rounds, dtype=jnp.int32)
    f = jax.jit(jax.vmap(lambda k: jax.vmap(lambda r: sampler(k, r))(rs)))
    return np.asarray(f(keys))


def _off_diag_rate(draws):
    """Per (key, round) fraction of heard links off the diagonal."""
    n = draws.shape[-1]
    off = ~np.eye(n, dtype=bool)
    return draws[..., off].mean(axis=-1).reshape(-1)


def _assert_same_rate(a, b):
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    se = max(se, 1e-12)
    assert abs(a.mean() - b.mean()) <= 4 * se, (a.mean(), b.mean(), se)


# -- round_tpu's property tests (tests/test_scenarios.py:123-165) ----------

def test_partition_halves_stable_then_heal():
    n = 8
    trace = _trace(tscen.partition(n, round_heal=3, device=CPU), 6)
    np.testing.assert_array_equal(trace[1], trace[0])
    np.testing.assert_array_equal(trace[2], trace[0])
    assert trace[3].all() and trace[5].all()  # healed: full connectivity
    assert not trace[0].all()  # split before


@pytest.mark.parametrize("name", ["crash", "omission", "partition",
                                  "byzantine_silence", "crash_at",
                                  "quorum_omission", "coordinator_down"])
def test_self_delivery_always_on(name):
    n = 8
    sampler = {
        "crash": lambda: tscen.crash(n, 3, device=CPU),
        "omission": lambda: tscen.omission(n, 0.9, device=CPU),
        "partition": lambda: tscen.partition(n, 3, device=CPU),
        "byzantine_silence": lambda: tscen.byzantine_silence(n, 2,
                                                             device=CPU),
        "crash_at": lambda: tscen.crash_at(n, 3, 1, device=CPU),
        "quorum_omission": lambda: tscen.quorum_omission(
            n, 0.9, lambda n: 2, device=CPU),
        "coordinator_down": lambda: tscen.coordinator_down(n, 2, 0.5,
                                                           device=CPU),
    }[name]()
    for key in ((0, 0), (1, 2), (7, 0xDEADBEEF)):
        trace = _trace(sampler, 6, key)
        for t in range(trace.shape[0]):
            assert np.diag(trace[t]).all(), "a process always hears itself"


def test_quorum_omission_min_indegree():
    n = 9
    q = 2 * n // 3 + 1
    sampler = tscen.quorum_omission(n, 0.8, quorum=lambda n: 2 * n // 3 + 1,
                                    device=CPU)
    for key in ((0, 0), (5, 9), (123, 4)):
        trace = _trace(sampler, 4, key)
        assert (trace.sum(axis=2) >= q).all()
        assert not trace.all()  # still lossy


def test_crash_at_round():
    n = 6
    trace = _trace(tscen.crash_at(n, f=2, crash_round=2, device=CPU), 5)
    # before crash_round: everyone heard from everyone
    assert trace[0].all() and trace[1].all()
    # after: exactly the same 2 senders silent in every later round
    silent2 = ~trace[2] & ~np.eye(n, dtype=bool)
    assert (silent2.any(axis=0).sum()) == 2
    np.testing.assert_array_equal(trace[3], trace[2])
    np.testing.assert_array_equal(trace[4], trace[2])


# -- the key-free parts, bit for bit ---------------------------------------

@pytest.mark.parametrize("n,rpp", [(5, 1), (8, 4), (13, 3), (16, 2)])
def test_coordinator_down_without_omissions_matches_jax(n, rpp):
    got = _trace(tscen.coordinator_down(n, rpp, device=CPU), 3 * n * rpp)
    jsamp = jscen.coordinator_down(n, rpp)
    want = np.stack([np.asarray(jsamp(jax.random.PRNGKey(0), r))
                     for r in range(3 * n * rpp)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,f,crash_round", [(6, 2, 2), (16, 5, 0),
                                             (11, 3, 4)])
def test_crash_at_structure_matches_jax(n, f, crash_round):
    """Given the crash set the port drew, every round's mask is
    round_tpu's crash_at formula over that set."""
    T = crash_round + 3
    for key in ((0, 1), (9, 9)):
        got = _trace(tscen.crash_at(n, f, crash_round, device=CPU), T, key)
        crashed = tscen._hash_crash_set(key, n, f, CPU).numpy()
        assert crashed.sum() == f
        for r in range(T):
            dead = jnp.asarray(crashed)[None, :] & (r >= crash_round)
            want = jscen._with_self(jnp.ones((n, n), dtype=bool) & ~dead)
            np.testing.assert_array_equal(got[r], np.asarray(want))
        # the same set as crash() draws for the key
        np.testing.assert_array_equal(
            got[T - 1], _trace(tscen.crash(n, f, device=CPU), 1, key)[0])


def test_partition_structure_and_heal_match_jax():
    n, heal = 12, 3
    jsamp = jscen.partition(n, heal)
    for key in ((0, 0), (4, 77), (1000, 3)):
        got = _trace(tscen.partition(n, heal, device=CPU), heal + 3, key)
        side = got[0][0]  # lane 0's row: its own side, as a mask
        same = side[:, None] == side[None, :]
        for r in range(heal):
            np.testing.assert_array_equal(
                got[r], np.asarray(jscen._with_self(jnp.asarray(same))))
        for r in range(heal, heal + 3):  # healed: key-free
            np.testing.assert_array_equal(
                got[r], np.asarray(jsamp(jax.random.PRNGKey(key[0]), r)))


# -- the keyed draws, by statistics ----------------------------------------

def test_byzantine_silence_rate_matches_jax():
    n, f, T = 16, 4, 3
    got = _port_draws(tscen.byzantine_silence(n, f, device=CPU), T)
    want = _jax_draws(jscen.byzantine_silence(n, f), T)
    _assert_same_rate(_off_diag_rate(got), _off_diag_rate(want))
    # exactly f silent-capable senders per scenario, constant over rounds
    for draws in (got, want):
        silent = (~draws & ~np.eye(n, dtype=bool)).any(axis=(1, 2))
        assert (silent.sum(axis=1) <= f).all()
        assert silent.sum(axis=1).mean() > f - 0.5


def test_quorum_omission_rate_matches_jax():
    n, T = 16, 3
    q = lambda n: n // 2 + 1  # noqa: E731
    got = _port_draws(tscen.quorum_omission(n, 0.75, q, device=CPU), T)
    want = _jax_draws(jscen.quorum_omission(n, 0.75, q), T)
    _assert_same_rate(_off_diag_rate(got), _off_diag_rate(want))
    for draws in (got, want):
        assert (draws.sum(axis=-1) >= q(n)).all()


def test_partition_rate_matches_jax():
    n, T = 16, 2
    got = _port_draws(tscen.partition(n, 5, device=CPU), T)[:, 0]
    want = _jax_draws(jscen.partition(n, 5), T)[:, 0]
    _assert_same_rate(_off_diag_rate(got[:, None]),
                      _off_diag_rate(want[:, None]))


def test_coordinator_down_with_omissions_rate_matches_jax():
    n, T = 16, 4
    got = _port_draws(tscen.coordinator_down(n, 2, 0.25, device=CPU), T)
    want = _jax_draws(jscen.coordinator_down(n, 2, 0.25), T)
    _assert_same_rate(_off_diag_rate(got), _off_diag_rate(want))
    for draws in (got, want):  # the phase's coordinator is never heard
        for r in range(T):
            coord = (r // 2) % n
            col = draws[:, r, :, coord]
            assert not np.delete(col, coord, axis=1).any()


def test_crash_at_counts_match_jax():
    n, f, T = 16, 5, 3
    got = _port_draws(tscen.crash_at(n, f, 1, device=CPU), T)
    want = _jax_draws(jscen.crash_at(n, f, 1), T)
    for draws in (got, want):
        assert draws[:, 0].all()
        silent = (~draws[:, 1] & ~np.eye(n, dtype=bool)).any(axis=1)
        assert (silent.sum(axis=1) == f).all()
    # every lane crashes about equally often: the hash ranks are uniform
    lanes = (~got[:, 2] & ~np.eye(n, dtype=bool)).any(axis=1).mean(axis=0)
    jl = (~want[:, 2] & ~np.eye(n, dtype=bool)).any(axis=1).mean(axis=0)
    _assert_same_rate(lanes, jl)
