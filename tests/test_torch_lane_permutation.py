"""Lane-permutation metamorphic tests of the port's fused KSet and ESFD
engines (mirrors tests/test_lane_permutation.py's KSet and ESFD cases).

Relabeling processes is a symmetry of these protocols: running a permuted
world (initial state, crash sets and partition sides gathered by the same
lane permutation) must give exactly the permuted result.  The iid-omission
hash samples absolute (src, dst) indices and the rotating victim is picked
by lane index, so those families are off (p8 = 0, rotate_down = 0).  Each
run is also held bit for bit against round_tpu's on the same world."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.models.failure_detector import EsfdState as JEsfdState
from round_tpu.models.kset import KSetESState as JKSetESState
from round_tpu_torch import interop
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.models.failure_detector import EsfdState
from round_tpu_torch.models.kset import KSetESState
from round_tpu_torch.utils.tree import tree_leaves, tree_map

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

N, S = 12, 6
PERMS = [
    np.roll(np.arange(N), 5),
    np.random.default_rng(7).permutation(N),
]
CPU = torch.device("cpu")


def _mix():
    """Crash + partition families only: scenario 0 fault-free, 1-2 crash
    sets, 3-4 partitions, 5 both (tests/test_lane_permutation.py::_mix)."""
    mix = jfast.fault_free(jax.random.PRNGKey(3), S, N)
    rng = np.random.default_rng(3)
    crashed = np.zeros((S, N), bool)
    crashed[1, rng.choice(N, 3, replace=False)] = True
    crashed[2, rng.choice(N, 2, replace=False)] = True
    crashed[5, rng.choice(N, 2, replace=False)] = True
    side = np.zeros((S, N), np.int32)
    side[3] = rng.integers(0, 2, N)
    side[4] = rng.integers(0, 2, N)
    side[5] = rng.integers(0, 2, N)
    mix = mix.replace(
        crashed=jnp.asarray(crashed),
        crash_round=jnp.asarray([0, 0, 1, 0, 0, 1], jnp.int32),
        side=jnp.asarray(side),
        heal_round=jnp.asarray([0, 0, 0, 3, 2, 2], jnp.int32),
    )
    fields = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")
    return mix, interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in fields}, device=CPU)


def _permute_mix(mix, p):
    return mix.replace(crashed=mix.crashed[:, p], side=mix.side[:, p])


def _permute(state, p):
    """Gather every per-lane axis: [S, n] leaves on axis 1, [S, n, n]
    leaves (per-receiver-per-sender matrices) on both."""
    p = torch.as_tensor(p)

    def go(leaf):
        if leaf.dim() >= 2 and leaf.shape[1] == N:
            leaf = leaf[:, p]
        if leaf.dim() >= 3 and leaf.shape[2] == N:
            leaf = leaf[:, :, p]
        return leaf

    return tree_map(go, state)


def _assert_equivariant(got_perm, want, p, msg):
    for i, (g, w) in enumerate(zip(tree_leaves(got_perm),
                                   tree_leaves(_permute(want, p)))):
        assert torch.equal(g, w), f"{msg} leaf {i}"


def _same_as_jax(got, want):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("p", PERMS, ids=["roll", "random"])
def test_kset_floodmin_style_hist_equivariant(p):
    jmix, tmix = _mix()
    init = np.asarray(jax.random.randint(
        jax.random.PRNGKey(11), (N,), 0, 8, dtype=jnp.int32))
    rnd = tfast.KSetESHist(n_values=8, t=2, k=2)

    def run(iv, m):
        return tfast.run_hist(rnd, KSetESState.fresh(torch.tensor(iv), S, N),
                              lambda s: s.decided, m, max_rounds=6,
                              mode="hash")

    got = run(init, tmix)
    got_p = run(init[p], _permute_mix(tmix, torch.as_tensor(p)))
    assert bool(got[0].decided.any(dim=1).all())
    _assert_equivariant(got_p[0], got[0], p, "kset state")
    np.testing.assert_array_equal(got_p[2].numpy(), got[2].numpy()[:, p])

    jstate0 = JKSetESState(
        est=jnp.broadcast_to(jnp.asarray(init), (S, N)),
        can_decide=jnp.zeros((S, N), bool),
        last_nb=jnp.full((S, N), N, jnp.int32),
        decided=jnp.zeros((S, N), bool),
        decision=jnp.full((S, N), -1, jnp.int32),
    )
    want = jfast.run_hist(jfast.KSetESHist(n_values=8, t=2, k=2), jstate0,
                          lambda s: s.decided, jmix, max_rounds=6,
                          mode="hash", interpret=True)
    _same_as_jax(got, want)


@pytest.mark.parametrize("p", PERMS, ids=["roll", "random"])
def test_esfd_matrix_state_equivariant(p):
    """ESFD's last_seen is [S, receiver, sender]: both lane axes gather,
    the matrix-state case of the symmetry."""
    jmix, tmix = _mix()

    def run(m):
        st = EsfdState(last_seen=torch.zeros((S, N, N), dtype=torch.int32))
        return tfast.run_esfd_fast(st, m, 8, hysteresis=3)

    got = run(tmix)
    got_p = run(_permute_mix(tmix, torch.as_tensor(p)))
    _assert_equivariant(got_p[0], got[0], p, "esfd last_seen")
    assert bool((got[0].last_seen > 3).any())  # something is suspected

    want = jfast.run_esfd_fast(
        JEsfdState(last_seen=jnp.zeros((S, N, N), jnp.int32)), jmix, 8,
        hysteresis=3)
    _same_as_jax(got, want)
