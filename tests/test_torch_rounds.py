"""Port parity: the round DSL beyond OTR (FoldRound, unicast, silence, exit)
and the pytree helpers, run through both general engines on the same hash
fault schedule (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.core import algorithm as jalgorithm
from round_tpu.core import rounds as jrounds
from round_tpu.engine import scenarios as jscen
from round_tpu.engine.executor import run_instance as jrun_instance
from round_tpu.utils import tree as jtree
from round_tpu_torch.core import algorithm as talgorithm
from round_tpu_torch.core import rounds as trounds
from round_tpu_torch.engine import executor as texecutor
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.utils import tree as ttree

N = 12


def _rounds(R, xp, maximum):
    """The same three rounds for either package: R is the rounds module,
    xp the array namespace, maximum its elementwise max."""

    class MaxFold(R.FoldRound):
        # running max over the mailbox as a monoid, plus the message count
        def send(self, ctx, s):
            return R.broadcast(ctx, s["x"])

        def zero(self, ctx, s):
            return -1

        def lift(self, ctx, s, sender, payload):
            return payload

        def combine(self, a, b):
            return maximum(a, b)

        def post(self, ctx, s, m, count, did_timeout):
            return {"x": maximum(s["x"], m), "heard": s["heard"] + count,
                    "timeouts": s["timeouts"] + did_timeout}

    class ToCoordinator(R.Round):
        # everyone tells the round's coordinator; it adopts the max it hears
        def send(self, ctx, s):
            return R.unicast(ctx, ctx.r % ctx.n, s["x"])

        def update(self, ctx, s, mbox):
            best = mbox.masked_max()
            x = xp.where(mbox.size() > 0, maximum(s["x"], best), s["x"])
            ctx.exit_at_end_of_round(s["heard"] > 40)
            return {**s, "x": x}

    class Quiet(R.Round):
        def send(self, ctx, s):
            return R.silence(ctx, s["x"])

        def update(self, ctx, s, mbox):
            return {**s, "heard": s["heard"] + mbox.size()}

    return MaxFold(), ToCoordinator(), Quiet()


class JAlgo(jalgorithm.Algorithm):
    def __init__(self):
        self.rounds = _rounds(jrounds, jnp, jnp.maximum)

    def make_init_state(self, ctx, io):
        return {"x": io["v"], "heard": jnp.int32(0), "timeouts": jnp.int32(0)}


class TAlgo(talgorithm.Algorithm):
    def __init__(self):
        self.rounds = _rounds(trounds, torch, torch.maximum)

    def make_init_state(self, ctx, io):
        zero = torch.zeros_like(io["v"])
        return {"x": io["v"], "heard": zero, "timeouts": zero}


@pytest.mark.parametrize("seed,p", [(0, 0.3), (5, 0.6)])
def test_fold_unicast_silence_match_jax(seed, p):
    key = jax.random.PRNGKey(seed)
    # round_tpu's run_phases hands its sampler the first half of a key
    # split; the port hands its sampler the key it is given
    ho_key = jax.random.split(key)[0]
    salts = tuple(int(s) for s in jscen._key_salt(ho_key))
    v = jax.random.randint(jax.random.fold_in(key, 1), (N,), 0, 50,
                           dtype=jnp.int32)
    want = jrun_instance(JAlgo(), {"v": v}, N, key, jscen.omission(N, p),
                         max_phases=4)
    got = texecutor.run_instance(
        TAlgo(), {"v": torch.as_tensor(np.array(v))}, N, salts,
        tscen.omission(N, p, device="cpu"), 4, device="cpu")
    for k in ("x", "heard", "timeouts"):
        np.testing.assert_array_equal(got.state[k].numpy(),
                                      np.asarray(want.state[k]), err_msg=k)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_array_equal(got.decided_round.numpy(),
                                  np.asarray(want.decided_round))


def test_tree_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = {"x": rng.integers(0, 9, (4, 3)), "y": rng.integers(0, 9, (4,))}
    b = {"x": rng.integers(0, 9, (4, 3)), "y": rng.integers(0, 9, (4,))}
    cond = rng.random(4) < 0.5
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    ta = {k: torch.as_tensor(v) for k, v in a.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    want = jtree.tree_where(jnp.asarray(cond), ja, jb)
    got = ttree.tree_where(torch.as_tensor(cond), ta, tb)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for idx in (0, 3):
        want = jtree.tree_select_lane(ja, idx)
        got = ttree.tree_select_lane(ta, idx)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    stacked = ttree.tree_stack([ta, tb])
    assert stacked["x"].shape == (2, 4, 3)


def test_struct_dataclass_is_a_pytree():
    @ttree.struct
    class Pair:
        a: torch.Tensor
        b: torch.Tensor

    p = Pair(a=torch.zeros(3), b=torch.ones(3))
    q = p.replace(b=torch.full((3,), 2.0))
    assert torch.equal(p.b, torch.ones(3)) and torch.equal(q.b,
                                                           torch.full((3,), 2.0))
    leaves = ttree.tree_leaves(q)
    assert len(leaves) == 2
    doubled = ttree.tree_map(lambda t: t * 2, q)
    assert isinstance(doubled, Pair) and torch.equal(doubled.b,
                                                     torch.full((3,), 4.0))
    with pytest.raises(AttributeError):
        p.a = torch.ones(3)  # frozen
