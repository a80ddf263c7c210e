"""Port parity: K1's plain version (the whole-run OTR loop).

`otr_loop` on CPU tensors runs its plain PyTorch template; it is held bit
for bit (tolerance 0) against round_tpu's Pallas `_loop_kernel` in
interpret mode on all six outputs: the standard mix, scenario padding with
the p8=256 blackout row (tests/test_fast.py:183-209), and drop plus a live
partition (tests/test_fast.py:487)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from round_tpu.engine import fast as jfast
from round_tpu.ops import fused as jfused
from round_tpu_torch import interop
from round_tpu_torch.ops import fused as tfused

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


@pytest.mark.parametrize("case", [_standard, _padding_blackout,
                                  _drop_partition, _rotating])
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
    """mode='hw' is not ported and says where it is queued; `dot` is
    validated and both values give the same bits."""
    x0 = torch.zeros((2, 4), dtype=torch.int32)
    z = torch.zeros((2,), dtype=torch.int32)
    args = (x0, x0 != 0, x0, z, z, z, z, z, z)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfused.otr_loop(*args, num_values=4, rounds=2, mode="hw")
    with pytest.raises(ValueError):
        tfused.otr_loop(*args, num_values=4, rounds=2, dot="int4")
    a = tfused.otr_loop(*args, num_values=4, rounds=2, dot="i8")
    b = tfused.otr_loop(*args, num_values=4, rounds=2, dot="bf16")
    for u, v in zip(a, b):
        assert torch.equal(u, v)
