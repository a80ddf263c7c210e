"""Port parity: the ladder's models through the general engine, and their
histogram rounds through the per-round fused engine.

FloodMin, Ben-Or (with the hash coin, ``coin_salt``) and LastVoting run
under round_tpu_torch's run_instance over ``scenarios.from_mix_row`` of a
hash-mode FaultMix, and must equal round_tpu's run_instance on the same
rows (carried over through numpy) on every state field, ``done`` and
``decided_round`` (tolerance 0).  FloodMinHist and BenOrHist under the
port's run_hist (K2's plain version on the CPU) equal round_tpu's
run_hist in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.engine import scenarios as jscen
from round_tpu.engine.executor import run_instance as jrun_instance
from round_tpu.models.benor import BenOr as JBenOr, BenOrState as JBenOrState
from round_tpu.models.common import consensus_io as jconsensus_io
from round_tpu.models.floodmin import (
    FloodMin as JFloodMin, FloodMinState as JFloodMinState,
)
from round_tpu.models.lastvoting import LastVoting as JLastVoting
from round_tpu_torch import interop
from round_tpu_torch.engine import executor as texecutor
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.engine import scenarios as tscen
from round_tpu_torch.models.benor import BenOr as TBenOr, BenOrState
from round_tpu_torch.models.common import consensus_io as tconsensus_io
from round_tpu_torch.models.floodmin import FloodMin as TFloodMin
from round_tpu_torch.models.floodmin import FloodMinState
from round_tpu_torch.models.lastvoting import LastVoting as TLastVoting

N = 10
S = 8
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")


def _mix(seed):
    key = jax.random.PRNGKey(seed)
    mix = jfast.standard_mix(key, S, N, p_drop=0.2, f=3, crash_round=1,
                             heal_round=6)
    tmix = interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}, device="cpu")
    return key, mix, tmix


def _assert_run(got, want, fields):
    for name in fields:
        np.testing.assert_array_equal(getattr(got.state, name).numpy(),
                                      np.asarray(getattr(want.state, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    np.testing.assert_array_equal(got.decided_round.numpy(),
                                  np.asarray(want.decided_round))


def _floodmin(mix, s, init):
    return JFloodMin(2), TFloodMin(2), ("x", "decided", "decision"), 5


def _benor(mix, s, init):
    salts = (int(mix.salt0[s]), int(mix.salt1[s]))
    return (JBenOr(coin_salt=salts), TBenOr(coin_salt=salts),
            ("x", "can_decide", "vote", "decided", "decision"), 6)


def _lastvoting(mix, s, init):
    return (JLastVoting(), TLastVoting(),
            ("x", "ts", "ready", "commit", "vote", "decided", "decision"), 4)


@pytest.mark.parametrize("model,seed,values", [
    (_floodmin, 4, 50), (_benor, 5, 2), (_benor, 8, 2),
    (_lastvoting, 6, 30), (_lastvoting, 13, 30),
])
def test_run_instance_matches_jax_on_mix_rows(model, seed, values):
    key, mix, tmix = _mix(seed)
    init = jax.random.randint(jax.random.fold_in(key, 1), (N,), 0, values,
                              dtype=jnp.int32)
    tinit = torch.as_tensor(np.array(init))
    decided_any = False
    for s in range(4):  # one row of each fault family
        jalgo, talgo, fields, phases = model(mix, s, init)
        want = jrun_instance(jalgo, jconsensus_io(init), N,
                             jax.random.PRNGKey(s), jscen.from_mix_row(mix, s),
                             max_phases=phases)
        got = texecutor.run_instance(talgo, tconsensus_io(tinit), N, (s, 0),
                                     tscen.from_mix_row(tmix, s), phases,
                                     device="cpu")
        _assert_run(got, want, fields)
        decided_any |= bool(got.state.decided.any())
    assert decided_any


def test_floodmin_run_hist_matches_jax():
    key, mix, tmix = _mix(21)
    V = 40
    init = jax.random.randint(key, (N,), 0, V, dtype=jnp.int32)
    st0 = JFloodMinState(x=jnp.broadcast_to(init, (S, N)),
                         decided=jnp.zeros((S, N), bool),
                         decision=jnp.full((S, N), -1, jnp.int32))
    want = jfast.run_hist(jfast.FloodMinHist(V, 2), st0, lambda s: s.decided,
                          mix, 5, mode="hash", interpret=True)
    got = tfast.run_hist(tfast.FloodMinHist(V, 2),
                         FloodMinState.fresh(torch.as_tensor(np.array(init)),
                                             S, N),
                         lambda s: s.decided, tmix, 5, mode="hash")
    for name in ("x", "decided", "decision"):
        np.testing.assert_array_equal(getattr(got[0], name).numpy(),
                                      np.asarray(getattr(want[0], name)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_benor_run_hist_matches_jax():
    key, mix, tmix = _mix(22)
    bits = jax.random.bernoulli(key, 0.5, (N,))
    st0 = JBenOrState(x=jnp.broadcast_to(bits, (S, N)),
                      can_decide=jnp.zeros((S, N), bool),
                      vote=jnp.full((S, N), -1, jnp.int32),
                      decided=jnp.zeros((S, N), bool),
                      decision=jnp.zeros((S, N), bool))
    want = jfast.run_hist(jfast.BenOrHist(), st0, lambda s: s.decided, mix,
                          8, mode="hash", interpret=True)
    got = tfast.run_hist(tfast.BenOrHist(),
                         BenOrState.fresh(torch.as_tensor(np.array(bits)),
                                          S, N),
                         lambda s: s.decided, tmix, 8, mode="hash")
    for name in ("x", "can_decide", "vote", "decided", "decision"):
        np.testing.assert_array_equal(getattr(got[0], name).numpy(),
                                      np.asarray(getattr(want[0], name)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_benor_without_coin_salt_flips_its_own_coin():
    """Without coin_salt the coin is bit 0 of the per-lane hash word: a
    fair coin of the port's own, deterministic per key."""
    n = 6
    io = tconsensus_io(torch.tensor([0, 1] * (n // 2)))
    samp = tscen.full(n, device="cpu")
    a = texecutor.run_instance(TBenOr(), io, n, (3, 4), samp, 5, device="cpu")
    b = texecutor.run_instance(TBenOr(), io, n, (3, 4), samp, 5, device="cpu")
    assert torch.equal(a.state.x, b.state.x)
    assert bool(a.state.decided.all())
    assert len(set(a.state.decision.tolist())) == 1
