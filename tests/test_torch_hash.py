"""Port parity: the hash stream, HO samplers and core helpers.

The same inputs go through round_tpu (JAX, CPU) and round_tpu_torch (CPU)
and must agree bit for bit (tolerance 0: every quantity is an integer or a
bool)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.core.progress import Progress as JProgress
from round_tpu.core.time import Time as JTime
from round_tpu.engine import scenarios as jscen
from round_tpu.ops import fused as jfused
# round_tpu.ops re-exports a function named `exchange` over the module
jexchange = importlib.import_module("round_tpu.ops.exchange")

from round_tpu_torch.core.progress import Progress as TProgress
from round_tpu_torch.core.time import Instance as TInstance, Time as TTime
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.ops import exchange as texchange
from round_tpu_torch.ops import fused as tfused

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

GRID = [0, 1, 2, 3, 255, 256, 0xFFFF, 2**31 - 1, 2**31, 2**31 + 1,
        0x9E3779B9, 0xDEADBEEF, 2**32 - 2, 2**32 - 1]


def _t(a):
    return torch.as_tensor(np.array(a))


def test_fmix32_matches_host_and_jax_on_grid():
    rng = np.random.default_rng(0)
    zs = np.array(GRID + list(rng.integers(0, 2**32, 200)), dtype=np.uint64)
    want_jax = np.asarray(jfused._fmix32(jnp.asarray(zs.astype(np.uint32))))
    got = tfused._fmix32(torch.as_tensor(zs.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want_jax.astype(np.int64))
    for z, w in zip(zs, got):
        assert jscen.mix32_host(int(z)) == int(w)
        assert tscen.mix32_host(int(z)) == int(w)


def test_int32_bit_patterns_round_trip():
    vals = np.array(GRID, dtype=np.uint64)
    as_i32 = tfused._i32(torch.as_tensor(vals.astype(np.int64)))
    np.testing.assert_array_equal(
        as_i32.numpy(), vals.astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(tfused._u32(as_i32).numpy(), vals)


@pytest.mark.parametrize("seed,r,n,p", [(0, 0, 8, 0.25), (3, 7, 13, 0.1),
                                        (11, 2**20, 16, 0.9)])
def test_link_bernoulli_matches_jax(seed, r, n, p):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jscen.link_bernoulli(key, r, n, p))
    salts = tuple(int(s) for s in jscen._key_salt(key))
    got = tscen.link_bernoulli(salts, r, n, p, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _ho_inputs(seed, S, n):
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    return dict(
        colmask=jax.random.bernoulli(ks[0], 0.8, (S, n)),
        side=jax.random.randint(ks[1], (S, n), 0, 2, dtype=jnp.int32),
        salt0=jax.random.bits(ks[2], (S,), jnp.uint32).astype(jnp.int32),
        salt1r=jax.random.bits(ks[3], (S,), jnp.uint32).astype(jnp.int32),
        p8=jnp.asarray([0, 1, 13, 64, 128, 255, 256, 40][:S], jnp.int32),
    )


@pytest.mark.parametrize("jg", [None, [0, 5, 15], [3]])
def test_ho_block_matches_jax(jg):
    inp = _ho_inputs(1, 8, 16)
    want = np.asarray(jexchange.ho_block(
        **inp, jg=None if jg is None else jnp.asarray(jg, jnp.int32)))
    got = texchange.ho_block(
        **{k: _t(v) for k, v in inp.items()},
        jg=None if jg is None else torch.tensor(jg)).numpy()
    np.testing.assert_array_equal(got, want)


def test_ho_link_mask_matches_jax():
    inp = _ho_inputs(2, 8, 12)
    want = np.asarray(jfused.ho_link_mask(**inp))
    got = tfused.ho_link_mask(**{k: _t(v) for k, v in inp.items()}).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash_coin_matches_jax():
    ks = jax.random.split(jax.random.PRNGKey(4), 2)
    s0 = jax.random.bits(ks[0], (6,), jnp.uint32).astype(jnp.int32)
    s1 = jax.random.bits(ks[1], (6,), jnp.uint32).astype(jnp.int32)
    lane = jnp.arange(20, dtype=jnp.int32)
    for r in (0, 1, 9, 2**31 - 1):
        want = np.asarray(jfused.hash_coin(s0[:, None], s1[:, None], r,
                                           lane[None, :]))
        got = tfused.hash_coin(_t(s0)[:, None], _t(s1)[:, None], r,
                               torch.arange(20)[None, :]).numpy()
        np.testing.assert_array_equal(got, want)


def test_samplers_match_jax():
    n, key = 10, jax.random.PRNGKey(5)
    salts = tuple(int(s) for s in jscen._key_salt(key))
    for r in (0, 3):
        np.testing.assert_array_equal(
            tscen.full(n, device="cpu")(salts, r).numpy(),
            np.asarray(jscen.full(n)(key, r)))
        np.testing.assert_array_equal(
            tscen.omission(n, 0.3, device="cpu")(salts, r).numpy(),
            np.asarray(jscen.omission(n, 0.3)(key, r)))
    sched = jax.random.bernoulli(jax.random.PRNGKey(6), 0.5, (3, n, n))
    jsamp = jscen.sync_k_filter(jscen.from_schedule(sched), 7)
    tsamp = tscen.sync_k_filter(tscen.from_schedule(_t(sched)), 7)
    for r in (0, 1, 2, 5):
        np.testing.assert_array_equal(tsamp(salts, r).numpy(),
                                      np.asarray(jsamp(key, r)))


def test_crash_sampler_structure():
    """The port's crash set comes from the link hash (round_tpu draws it
    with threefry): exactly f silent senders, constant across rounds."""
    n, f = 12, 3
    samp = tscen.crash(n, f, device="cpu")
    ho0, ho5 = samp((7, 9), 0), samp((7, 9), 5)
    assert torch.equal(ho0, ho5)
    silent = (~ho0).any(dim=0)
    assert int(silent.sum()) == f
    assert bool(torch.diagonal(ho0).all())


def test_time_and_progress_match_jax():
    pairs = [(0, 1), (2**31 - 1, -2**31), (5, 5), (-3, 7)]
    for a, b in pairs:
        for op in ("lt", "leq", "gt", "geq", "max", "min", "add", "diff"):
            want = np.asarray(getattr(JTime, op)(a, b))
            got = getattr(TTime, op)(a, b).numpy()
            np.testing.assert_array_equal(got, want)
    assert bool(TInstance.lt(2**15 - 1, -2**15))
    for p in (JProgress.timeout(10), JProgress.sync(3),
              JProgress.strict_timeout(7), JProgress.WAIT_MESSAGE):
        q = TProgress(p.value)
        assert repr(q) == repr(p)
        assert q.lub(TProgress.timeout(20)).value == p.lub(
            JProgress.timeout(20)).value
        assert q.glb(TProgress.GO_AHEAD).value == p.glb(
            JProgress.GO_AHEAD).value
