"""Port parity: the plain versions of K1 (the whole-run histogram loop,
OTR, FloodMin and Ben-Or instances) and K3 (the whole LastVoting run).

On CPU tensors `otr_loop`, `run_floodmin_loop`, `run_benor_loop` and
`lv_loop` run their plain PyTorch versions; each is held bit for bit
(tolerance 0) against round_tpu's Pallas kernel in interpret mode
(`_loop_kernel`, `_lv_kernel`) on every output, over four cases: the
standard mix, scenario padding with the p8=256 blackout row
(tests/test_fast.py:183-209), drop plus a live partition
(tests/test_fast.py:487), and the rotating suppressed process with crashes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.models.benor import BenOrState as JBenOrState
from round_tpu.models.floodmin import FloodMinState as JFloodMinState
from round_tpu.ops import fused as jfused
from round_tpu_torch import interop
from round_tpu_torch.engine import fast as tfast
from round_tpu_torch.models.benor import BenOrState
from round_tpu_torch.models.floodmin import FloodMinState
from round_tpu_torch.ops import fused as tfused

# tiny tensors on the CPU: more intra-op threads only spin, taking the
# cores that the socket tests' event loops need under pytest-xdist
torch.set_num_threads(1)

V = 8
N = 16
S = 12
MIX_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
              "p8", "salt0", "salt1")
# the argument order of otr_loop after x0
LOOP_ARGS = ("crashed", "side", "crash_round", "heal_round", "rotate_down",
             "p8", "salt0", "salt1")


def _standard():
    key = jax.random.PRNGKey(3)
    mix = jfast.standard_mix(key, S, N, p_drop=0.15, f=3, crash_round=1)
    return mix, jax.random.fold_in(key, 5), 6


def _padding_blackout():
    key = jax.random.PRNGKey(11)
    mix = jfast.fault_free(key, 5, N).replace(
        p8=jnp.asarray([0, 64, 255, 256, 13], dtype=jnp.int32))
    return mix, jax.random.fold_in(key, 1), 5


def _drop_partition():
    key = jax.random.PRNGKey(31)
    S_ = 6
    side = (jnp.arange(N) % 2).astype(jnp.int32)
    mix = jfast.fault_free(key, S_, N).replace(
        side=jnp.broadcast_to(side, (S_, N)),
        heal_round=jnp.asarray([3, 3, 0, 3, 2, 6], jnp.int32),
        p8=jnp.asarray([64, 0, 64, 13, 128, 0], jnp.int32),
    )
    return mix, jax.random.fold_in(key, 2), 6


def _rotating():
    key = jax.random.PRNGKey(17)
    S_ = 4
    mix = jfast.fault_free(key, S_, N).replace(
        rotate_down=jnp.asarray([1, 2, 3, 0], jnp.int32),
        crashed=jnp.zeros((S_, N), bool).at[:, :4].set(True),
        crash_round=jnp.asarray([0, 2, 9, 1], jnp.int32),
        p8=jnp.asarray([13, 0, 64, 256], jnp.int32),
    )
    return mix, jax.random.fold_in(key, 3), 7


CASES = [_standard, _padding_blackout, _drop_partition, _rotating]


def _port_mix(mix):
    return interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}, device="cpu")


def _assert_fields(tstate, jstate, names):
    for name in names:
        np.testing.assert_array_equal(getattr(tstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_otr_loop_plain_matches_jax_kernel(case):
    mix, init_key, rounds = case()
    S_ = mix.crashed.shape[0]
    x0 = jnp.broadcast_to(
        jax.random.randint(init_key, (N,), 0, V, dtype=jnp.int32), (S_, N))
    jargs = [x0] + [getattr(mix, k) for k in LOOP_ARGS]
    want = jfused.otr_loop(*jargs, num_values=V, rounds=rounds,
                           mode="hash", sb=4, interpret=True)
    tmix = interop.fault_mix_from_numpy(
        {k: np.asarray(getattr(mix, k)) for k in MIX_FIELDS}, device="cpu")
    got = tfused.otr_loop(
        torch.as_tensor(np.array(x0)),
        *[getattr(tmix, k) for k in LOOP_ARGS],
        num_values=V, rounds=rounds, mode="hash")
    names = ("x", "decided", "decision", "after", "done", "decided_round")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[1].dtype == torch.bool and got[4].dtype == torch.bool


def test_otr_loop_knobs():
    """mode='hw' is the default and runs (a p8=0 run draws nothing, so it
    equals hash mode); an unknown mode is refused; `dot` is validated and
    both values give the same bits."""
    x0 = torch.zeros((2, 4), dtype=torch.int32)
    z = torch.zeros((2,), dtype=torch.int32)
    args = (x0, x0 != 0, x0, z, z, z, z, z, z)
    hw = tfused.otr_loop(*args, num_values=4, rounds=2)
    for u, v in zip(hw, tfused.otr_loop(*args, num_values=4, rounds=2,
                                        mode="hash")):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="unknown mode"):
        tfused.otr_loop(*args, num_values=4, rounds=2, mode="tpu")
    with pytest.raises(ValueError):
        tfused.otr_loop(*args, num_values=4, rounds=2, dot="int4")
    a = tfused.otr_loop(*args, num_values=4, rounds=2, dot="i8")
    b = tfused.otr_loop(*args, num_values=4, rounds=2, dot="bf16")
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("case", CASES)
def test_floodmin_loop_plain_matches_jax_kernel(case):
    """run_floodmin_loop on the CPU against round_tpu's FloodMinLoop
    instance of `_loop_kernel`; V=40 so the values spread over more than
    a byte of histogram rows."""
    mix, init_key, rounds = case()
    S_, Vf, f = mix.crashed.shape[0], 40, 2
    init = jax.random.randint(init_key, (N,), 0, Vf, dtype=jnp.int32)
    st0 = JFloodMinState(x=jnp.broadcast_to(init, (S_, N)),
                         decided=jnp.zeros((S_, N), bool),
                         decision=jnp.full((S_, N), -1, jnp.int32))
    want = jfast.run_floodmin_loop(jfast.FloodMinHist(Vf, f), st0, mix,
                                   rounds, mode="hash", sb=4, interpret=True)
    tst0 = interop.floodmin_state_from_numpy(
        {k: np.asarray(getattr(st0, k)) for k in ("x", "decided", "decision")},
        device="cpu")
    got = tfast.run_floodmin_loop(tfast.FloodMinHist(Vf, f), tst0,
                                  _port_mix(mix), rounds, mode="hash")
    _assert_fields(got[0], want[0], ("x", "decided", "decision"))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("case", CASES)
def test_benor_loop_plain_matches_jax_kernel(case):
    """run_benor_loop on the CPU against round_tpu's BenOrLoop instance of
    `_loop_kernel`: both subrounds and the hash coin, 12 rounds."""
    mix, init_key, _rounds = case()
    S_ = mix.crashed.shape[0]
    bits = jax.random.bernoulli(init_key, 0.5, (N,))
    st0 = JBenOrState(x=jnp.broadcast_to(bits, (S_, N)),
                      can_decide=jnp.zeros((S_, N), bool),
                      vote=jnp.full((S_, N), -1, jnp.int32),
                      decided=jnp.zeros((S_, N), bool),
                      decision=jnp.zeros((S_, N), bool))
    want = jfast.run_benor_loop(jfast.BenOrHist(), st0, mix, 12, mode="hash",
                                sb=4, interpret=True)
    tst0 = interop.benor_state_from_numpy(
        {k: np.asarray(getattr(st0, k)) for k in
         ("x", "can_decide", "vote", "decided", "decision")}, device="cpu")
    got = tfast.run_benor_loop(tfast.BenOrHist(), tst0, _port_mix(mix), 12,
                               mode="hash")
    _assert_fields(got[0], want[0],
                   ("x", "can_decide", "vote", "decided", "decision"))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("case", CASES)
def test_lv_loop_plain_matches_jax_kernel(case):
    """lv_loop on the CPU (its plain version) against round_tpu's
    `_lv_kernel` in interpret mode on all nine outputs, over 3 phases: the
    coordinator moves off lane 0, so a swapped row/column would show."""
    mix, init_key, _rounds = case()
    S_ = mix.crashed.shape[0]
    x0 = jnp.broadcast_to(
        jax.random.randint(init_key, (N,), 0, 40, dtype=jnp.int32), (S_, N))
    want = jfused.lv_loop(x0, *[getattr(mix, k) for k in LOOP_ARGS],
                          rounds=12, sb=4, interpret=True)
    tmix = _port_mix(mix)
    got = tfused.lv_loop(torch.as_tensor(np.array(x0)),
                         *[getattr(tmix, k) for k in LOOP_ARGS], rounds=12)
    names = ("x", "ts", "ready", "commit", "vote", "decided", "decision",
             "done", "decided_round")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert bool((tmix.p8 > 0).any())


def test_new_loops_refuse_a_resumed_state():
    """run_floodmin_loop and run_benor_loop start from a fresh state only,
    as round_tpu's do."""
    mix, init_key, _ = _standard()
    tmix = _port_mix(mix)
    init = torch.as_tensor(np.array(jax.random.randint(init_key, (N,), 0, 8)))
    fm = FloodMinState.fresh(init, S, N)
    with pytest.raises(ValueError, match="run_floodmin_loop requires a fresh"):
        tfast.run_floodmin_loop(tfast.FloodMinHist(8, 2),
                                fm.replace(decided=~fm.decided), tmix, 4)
    bo = BenOrState.fresh(init % 2, S, N)
    for bad in (bo.replace(decided=~bo.decided),
                bo.replace(can_decide=~bo.can_decide),
                bo.replace(vote=bo.vote + 1)):
        with pytest.raises(ValueError, match="run_benor_loop requires a fresh"):
            tfast.run_benor_loop(tfast.BenOrHist(), bad, tmix, 4)
