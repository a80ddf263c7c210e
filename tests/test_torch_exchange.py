"""Port parity: the exchange, the mailbox and K2's plain version.

K2 (`hist_exchange`, float32, and the engines' int32 route
`hist_exchange_counts`) on CPU tensors runs its plain PyTorch version; it
is held bit for bit (tolerance 0: exact integer counts) against round_tpu's
Pallas kernel in interpret mode and against its dense oracle, over the p8
set of tests/test_fast.py, with and without `side` and `rowmask`, with
blacked-out scenarios and inactive lanes."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from round_tpu.ops import fused as jfused
from round_tpu.ops.mailbox import Mailbox as JMailbox
from round_tpu_torch.ops import exchange as texchange
from round_tpu_torch.ops import fused as tfused
from round_tpu_torch.ops.mailbox import Mailbox as TMailbox

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

# round_tpu.ops re-exports a function named `exchange` over the module
jexchange = importlib.import_module("round_tpu.ops.exchange")

V = 8
N = 16
S = 12


def _rand_inputs(key, S, n):
    ks = jax.random.split(key, 8)
    return dict(
        vals=jax.random.randint(ks[0], (S, n), 0, V, dtype=jnp.int32),
        active=jax.random.bernoulli(ks[1], 0.9, (S, n)),
        colmask=jax.random.bernoulli(ks[2], 0.8, (S, n)),
        rowmask=jax.random.bernoulli(ks[3], 0.9, (S, n)),
        side=jax.random.randint(ks[4], (S, n), 0, 2, dtype=jnp.int32),
        salt0=jax.random.bits(ks[5], (S,), jnp.uint32).astype(jnp.int32),
        salt1r=jax.random.bits(ks[6], (S,), jnp.uint32).astype(jnp.int32),
        p8=jnp.asarray(
            [0, 13, 64, 128, 255, 256, 1, 0, 13, 64, 13, 13], dtype=jnp.int32
        )[:S],
    )


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


@pytest.mark.parametrize("with_side", [True, False])
@pytest.mark.parametrize("with_rowmask", [True, False])
def test_hist_exchange_plain_matches_jax(with_side, with_rowmask):
    inp = _rand_inputs(jax.random.PRNGKey(0), S, N)
    if not with_side:
        inp["side"] = None
    if not with_rowmask:
        inp["rowmask"] = None
    want_kernel = np.asarray(jfused.hist_exchange(
        num_values=V, mode="hash", interpret=True, **inp))
    want_oracle = np.asarray(jfused.hist_exchange_reference(
        num_values=V, **inp))
    tin = {k: _t(v) for k, v in inp.items()}
    got = tfused.hist_exchange(num_values=V, mode="hash", **tin)
    assert got.dtype == torch.float32 and got.shape == (S, V, N)
    np.testing.assert_array_equal(got.numpy(), want_kernel)
    np.testing.assert_array_equal(got.numpy(), want_oracle)
    np.testing.assert_array_equal(
        tfused.hist_exchange_reference(num_values=V, **tin).numpy(),
        want_oracle)


def _counts_case(case):
    """The inputs of one case of the int32 route: `_rand_inputs` with the
    case's side, rowmask, p8 and active lanes."""
    inp = _rand_inputs(jax.random.PRNGKey(4), S, N)
    if case in ("plain", "rowmask", "inactive"):
        inp["side"] = None
    if case in ("plain", "side"):
        inp["rowmask"] = None
    if case == "blackout":
        # every other scenario blacked out; its lanes still hear themselves
        inp["p8"] = jnp.where(jnp.arange(S) % 2 == 0, 256, inp["p8"])
    if case == "inactive":
        # half the lanes inactive, scenario 3 wholly
        act = jax.random.bernoulli(jax.random.PRNGKey(5), 0.5, (S, N))
        inp["active"] = act.at[3].set(False)
    return inp


@pytest.mark.parametrize("case", ["plain", "side", "rowmask", "side_rowmask",
                                  "blackout", "inactive"])
def test_hist_exchange_counts_matches_jax(case):
    """The engines' int32 route equals round_tpu's hist_exchange cast to
    int32, and the float32 route cast the same way, in both streams."""
    inp = _counts_case(case)
    want = np.asarray(jfused.hist_exchange(
        num_values=V, mode="hash", interpret=True, **inp)).astype(np.int32)
    tin = {k: _t(v) for k, v in inp.items()}
    got = tfused.hist_exchange_counts(num_values=V, mode="hash", **tin)
    assert got.dtype == torch.int32 and got.shape == (S, V, N)
    np.testing.assert_array_equal(got.numpy(), want)
    for mode in ("hash", "hw"):
        f32 = tfused.hist_exchange(num_values=V, mode=mode, **tin)
        assert f32.dtype == torch.float32
        assert torch.equal(
            tfused.hist_exchange_counts(num_values=V, mode=mode, **tin),
            f32.to(torch.int32))


def test_hist_exchange_knobs():
    tin = {k: _t(v) for k, v in
           _rand_inputs(jax.random.PRNGKey(1), 4, 8).items()}
    a = tfused.hist_exchange(num_values=V, dot="i8", **tin)
    b = tfused.hist_exchange(num_values=V, dot="bf16", **tin)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tfused.hist_exchange(num_values=V, dot="f64", **tin)
    with pytest.raises(ValueError, match="unknown mode"):
        tfused.hist_exchange(num_values=V, mode="tpu", **tin)
    # hw mode is the default: counts as exact integers with hash mode's
    # marginals (same senders, at most n per receiver, p8=0 rows equal)
    hw = tfused.hist_exchange(num_values=V, **tin)
    assert torch.equal(hw, tfused.hist_exchange(num_values=V, mode="hw",
                                                **tin))
    assert hw.shape == a.shape and torch.equal(hw, hw.round())
    assert bool((hw.sum(1) <= 8).all())
    free = tin["p8"] == 0
    assert torch.equal(hw[free], a[free])


def test_exchange_ops_match_jax():
    ks = jax.random.split(jax.random.PRNGKey(2), 4)
    ho = jax.random.bernoulli(ks[0], 0.7, (N, N))
    dest = jax.random.bernoulli(ks[1], 0.6, (N, N))
    active = jax.random.bernoulli(ks[2], 0.8, (N,))
    payload = jax.random.randint(ks[3], (N,), 0, V, dtype=jnp.int32)
    for act in (None, active):
        want = np.asarray(jexchange.deliver_mask(ho, dest, act))
        got = texchange.deliver_mask(_t(ho), _t(dest), _t(act))
        np.testing.assert_array_equal(got.numpy(), want)
        _, got2 = texchange.exchange(_t(payload), _t(dest), _t(ho), _t(act))
        np.testing.assert_array_equal(got2.numpy(), want)
    code = jexchange.hist_pack(payload, active)
    np.testing.assert_array_equal(
        texchange.hist_pack(_t(payload), _t(active)).numpy(),
        np.asarray(code))
    np.testing.assert_array_equal(
        texchange.hist_code_counts(_t(code), _t(ho), V).numpy(),
        np.asarray(jexchange.hist_code_counts(code, ho, V)))


def _mailbox_ops(mb, vals, key):
    """Every Mailbox op, as a dict of arrays (the same calls on both)."""
    return {
        "size": mb.size(),
        "count": mb.count(lambda v: v >= 3),
        "exists": mb.exists(lambda v: v == 5),
        "forall": mb.forall(lambda v: v < 7),
        "contains": mb.contains(4),
        "get": mb.get(2),
        "get_or": mb.get_or(4, vals[0] * 0 - 1),
        "arg_best": mb.arg_best(key),
        "best_by": mb.best_by(key),
        "any_value": mb.any_value(),
        "fold_min": mb.fold_min(100),
        "masked_min": mb.masked_min(),
        "masked_max": mb.masked_max(),
        "masked_sum": mb.masked_sum(),
        "hist": mb.value_histogram(V),
        "mmor": mb.min_most_often_received(),
        "mmor_v": mb.min_most_often_received(num_values=V),
        "sorted": mb.sorted_values()[0],
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mailbox_ops_match_jax(seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    vals = jax.random.randint(ks[0], (N,), 0, V, dtype=jnp.int32)
    key = jax.random.randint(ks[1], (N,), 0, 4, dtype=jnp.int32)
    for mask in (jax.random.bernoulli(ks[2], 0.6, (N,)),
                 jnp.zeros((N,), bool)):
        want = _mailbox_ops(JMailbox(vals, mask), vals, key)
        got = _mailbox_ops(TMailbox(_t(vals), _t(mask)), _t(vals), _t(key))
        for name in want:
            if not bool(np.asarray(mask).any()) and name in ("mmor", "mmor_v"):
                continue  # undefined on an empty mailbox (quorum-guarded)
            np.testing.assert_array_equal(
                np.asarray(got[name]), np.asarray(want[name]), err_msg=name)


def test_mailbox_under_vmap_matches_jax():
    """The engine batches per-lane code with torch.func.vmap: each receiver
    reads its own row of the delivery mask."""
    ks = jax.random.split(jax.random.PRNGKey(3), 2)
    vals = jax.random.randint(ks[0], (N,), 0, V, dtype=jnp.int32)
    deliver = jax.random.bernoulli(ks[1], 0.7, (N, N))

    def jone(row):
        mb = JMailbox(vals, row)
        return (mb.size(), mb.value_histogram(V), mb.best_by(vals),
                mb.any_value())

    tvals = _t(vals)

    def tone(row):
        mb = TMailbox(tvals, row)
        return (mb.size(), mb.value_histogram(V), mb.best_by(tvals),
                mb.any_value())

    want = jax.vmap(jone)(deliver)
    got = vmap(tone)(_t(deliver))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
